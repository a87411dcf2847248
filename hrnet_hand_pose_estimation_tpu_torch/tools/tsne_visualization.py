"""t-SNE plot of a model's pooled features over a dataset.

Port of the JAX package's ``tools/tsne_visualization.py`` (reference
tools/tSNE_visualization.py): each test sample's backbone features
(``HRNetOutput.features``, averaged over the map, float32) computed on the
device by ``embed``, then a 2D t-SNE scatter.  sklearn and matplotlib are
imported at the call; ``embed`` needs neither.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.tsne_visualization \\
        --cfg <exp.yaml> [--model_path <ckpt>] --out tsne.png [--device cpu]
"""

from __future__ import annotations

import torch

from ._common import base_parser, load_cfg


@torch.no_grad()
def embed(cfg, model, images: torch.Tensor) -> torch.Tensor:
    """(B, C) float32 features of (B, H, W, 3) images, the model's eval
    forward under the compute dtype's autocast, pooled over the map."""
    from ..parallel.train_step import compute_autocast

    model.eval()
    with compute_autocast(cfg, images.device):
        features = model(images).features
    return features.float().mean(dim=(1, 2))


def main() -> None:
    p = base_parser(__doc__)
    p.add_argument("--out", default="tsne.png")
    p.add_argument("--max_samples", type=int, default=256)
    args = p.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from sklearn.manifold import TSNE

    from ..data.build import make_test_dataloader
    from ..models import build_model
    from ._common import load_weights

    cfg = load_cfg(args)
    model = build_model(cfg)
    load_weights(cfg, model, args.model_path)
    model.to(args.device)
    name, loader = next(iter(make_test_dataloader(cfg).items()))
    feats, n = [], 0
    for batch in loader:
        feats.append(embed(cfg, model, torch.as_tensor(batch["imgs"]).to(args.device)).cpu()
                     .numpy())
        n += feats[-1].shape[0]
        if n >= args.max_samples:
            break
    emb = np.concatenate(feats)[: args.max_samples]
    pts = TSNE(n_components=2, init="pca", perplexity=min(30, len(emb) - 1)).fit_transform(emb)
    plt.figure(figsize=(6, 6))
    plt.scatter(pts[:, 0], pts[:, 1], s=8, c=np.arange(len(pts)), cmap="viridis")
    plt.title(f"t-SNE of {name} embeddings ({len(pts)} samples)")
    plt.tight_layout()
    plt.savefig(args.out, dpi=120)
    print(f"wrote {args.out} ({len(pts)} samples)")


if __name__ == "__main__":
    main()

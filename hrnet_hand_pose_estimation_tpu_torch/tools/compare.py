"""Overlay PCK curves of several saved evaluation runs.

Port of the JAX package's ``tools/compare.py`` (reference
tools/compare.py:13-60): read the ``PCK2d.txt`` curve (thresholds, PCK) of
each ``eval2D_results_*`` directory, print each run's AUC over the first 30
thresholds (reference misc.py:281-288) and plot the curves.  matplotlib is
imported only to plot; ``--out ''`` prints the AUCs alone.

    python -m hrnet_hand_pose_estimation_tpu_torch.tools.compare \\
        eval2D_results_expA eval2D_results_expB --out cmp.png
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np


def curve_auc(th: np.ndarray, pck: np.ndarray, n: int = 30) -> float:
    """The reference's trapezoid AUC over the first ``n`` thresholds,
    normalised by their span."""
    s = slice(0, n)
    th, pck = th[s], pck[s]
    return float((pck[0] + 2 * pck[1:-1].sum() + pck[-1]) * (th[1] - th[0]) / 2
                 / (th[-1] - th[0]))


def main(argv: Sequence[str] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dirs", nargs="+", help="eval2D_results_* directories")
    p.add_argument("--out", default="compare_pck.png", help="plot file ('' for none)")
    p.add_argument("--curve", default="PCK2d.txt")
    args = p.parse_args(argv)

    curves = []
    for d in args.dirs:
        th, pck = np.loadtxt(os.path.join(d, args.curve))
        label = f"{os.path.basename(d.rstrip('/'))} (AUC {curve_auc(th, pck):.4f})"
        curves.append((th, pck, label))
        print(label)
    if not args.out:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for th, pck, label in curves:
        ax.plot(th, pck, marker=".", label=label)
    ax.set_xlabel("threshold [px]")
    ax.set_ylabel("PCK")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

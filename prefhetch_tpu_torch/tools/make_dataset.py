"""Dataset provisioning without JAX — the counterpart of
scripts/make_dataset.py (the reference's dataset.sh):

    python -m prefhetch_tpu_torch.tools.make_dataset --out DIR --prefix P \
        [--nbase N] [--ntrain N] [--nquery N] [--d D] [--clusters C] \
        [--seed S] [--hard]

Generates a synthetic SIFT-style dataset in the reference's file layout
({P}_learn.fvecs, {P}_base.fvecs, {P}_query.fvecs, {P}_groundtruth.ivecs,
exact brute-force ground truth) with the port's generator: the same
arguments give the same bytes as the JAX script. There is no download.
"""

from __future__ import annotations

import argparse

from prefhetch_tpu_torch.data.synthetic import write_sift_style_dataset


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m prefhetch_tpu_torch.tools.make_dataset")
    p.add_argument("--out", default="sift/siftsmall")
    p.add_argument("--prefix", default="siftsmall")
    p.add_argument("--nbase", type=int, default=10_000)
    p.add_argument("--ntrain", type=int, default=25_000)
    p.add_argument("--nquery", type=int, default=100)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--clusters", type=int, default=200)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--hard", action="store_true",
                   help="overlapping heavy-tailed workload (recall<1 at "
                        "the BASELINE operating point)")
    args = p.parse_args(argv)
    paths = write_sift_style_dataset(
        args.out,
        prefix=args.prefix,
        hard=args.hard,
        nbase=args.nbase,
        ntrain=args.ntrain,
        nquery=args.nquery,
        d=args.d,
        n_clusters=args.clusters,
        gt_k=100,
        seed=args.seed,
    )
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

"""Flat DM sweep of a SIGPROC filterbank from the command line.

Port of the flat single-file mode of ``pypulsar_tpu/cli/sweep.py``: sweep
``--numdms`` trials from ``--lodm`` in steps of ``--dmstep`` on the card
(``--device cuda``, the default) and write the single-pulse candidate
list ``{outbase}.cands`` in the reference's format::

    # DM      SNR      time_s       sample    width_bins  downsamp
    80.0000   12.310   0.700000     700       2           1

Run as ``python -m pypulsar_tpu_torch.cli.sweep FILE.fil --numdms N ...``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pypulsar_tpu_torch.resilience.dataguard import finite_rows
from pypulsar_tpu_torch.resilience.journal import atomic_write_text


def write_cands(path, cands) -> None:
    """Write candidate rows atomically (tmp + os.replace); rows with a
    non-finite DM, SNR or time are dropped at the gate."""
    cands = finite_rows(cands, ("dm", "snr", "time_sec"),
                        what=os.path.basename(path))
    lines = ["# DM      SNR      time_s       sample    width_bins  "
             "downsamp\n"]
    for c in cands:
        lines.append(
            f"{c['dm']:<9.4f} {c['snr']:<8.3f} {c['time_sec']:<12.6f} "
            f"{c['sample']:<9d} {c['width_bins']:<11d} "
            f"{c['downsamp']:<8d}\n")
    atomic_write_text(path, "".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sweep",
        description="Flat DM-trial sweep of a .fil file on the GPU")
    ap.add_argument("infile", help="SIGPROC .fil input (8/4/2/1/16-bit)")
    ap.add_argument("-o", "--outbase", default=None,
                    help="output basename (default: input sans extension)")
    ap.add_argument("--lodm", type=float, default=0.0, help="lowest trial DM")
    ap.add_argument("--dmstep", type=float, default=1.0,
                    help="DM step (pc/cm^3)")
    ap.add_argument("--numdms", type=int, required=True,
                    help="number of DM trials")
    ap.add_argument("-s", "--nsub", type=int, default=64,
                    help="subbands of the two-stage dedispersion")
    ap.add_argument("--group-size", type=int, default=0,
                    help="DM trials per stage-1 group; 0 (default) picks the "
                         "largest group whose extra subband smearing stays "
                         "under one sample")
    ap.add_argument("--downsamp", type=int, default=1,
                    help="downsample factor")
    ap.add_argument("--chunk", type=int, default=None,
                    help="streaming chunk payload in (downsampled) samples")
    ap.add_argument("--widths", default="1,2,4,8,16,32",
                    help="comma-separated boxcar widths in bins")
    ap.add_argument("--threshold", type=float, default=6.0,
                    help="SNR threshold for the .cands file")
    ap.add_argument("-k", "--topk", type=int, default=10,
                    help="candidates to print")
    ap.add_argument("--engine", default="auto",
                    help="chunk formulation: auto or gather (the only one "
                         "ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.downsamp < 1:
        ap.error("--downsamp must be >= 1")

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel.staged import sweep_flat

    widths = tuple(int(w) for w in args.widths.split(","))
    outbase = args.outbase or os.path.splitext(args.infile)[0]
    dms = args.lodm + args.dmstep * np.arange(args.numdms)
    with FilterbankFile(args.infile) as reader:
        staged = sweep_flat(reader, dms, downsamp=args.downsamp,
                            nsub=args.nsub, group_size=args.group_size,
                            widths=widths, chunk_payload=args.chunk,
                            verbose=True, engine=args.engine,
                            device=args.device)
    hits = staged.above_threshold(args.threshold)
    write_cands(outbase + ".cands", hits)
    print(f"# {staged.n_trials} DM trials swept; {len(hits)} detections "
          f">= {args.threshold} sigma -> {outbase}.cands")
    for c in staged.best(args.topk):
        print(f"DM {c['dm']:8.3f}  SNR {c['snr']:7.2f}  t "
              f"{c['time_sec']:10.4f}s  width {c['width_bins']:3d} bins "
              f"({c['width_sec']*1e3:.2f} ms)  ds {c['downsamp']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

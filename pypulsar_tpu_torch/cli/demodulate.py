"""Orbital demodulation: resample a .dat to a constant pulsar-frame rate.

Behavioral spec: reference ``bin/demodulate.py`` — synthesize a scratch
parfile whose F0 is 0.001/dt so one "rotation" is 1000 samples (:53-82),
generate polycos for it, and drop/duplicate samples wherever the
polyco-predicted pulsar-frame sample index drifts more than half a bin
from the observation-frame index (:103-231); write the resampled .dat
(even length, for realfft) and an updated .inf.

TPU-era redesign: the reference walked the series with an adaptive
step-size search (:120-199, amortized Python looping); here the
pulsar-frame drift is evaluated *vectorized* per polyco block
(``Polyco.rotation_batch``) and drop/add events are the unit crossings of
``round(drift)`` — the same events, found in O(N) numpy instead of a
data-dependent scalar loop.

Copy of ``pypulsar_tpu/cli/demodulate.py`` over the port's
``fold/polycos.create_polycos_from_inf`` (host numpy, as there).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Tuple

import numpy as np

from pypulsar_tpu_torch.core.psrmath import SECPERDAY
from pypulsar_tpu_torch.fold.polycos import create_polycos_from_inf
from pypulsar_tpu_torch.io.datfile import Datfile
from pypulsar_tpu_torch.resilience.journal import atomic_open

# parfile keys replaced by the scratch ephemeris (spin + astrometry)
_REPLACED_KEYS = {
    "F", "F0", "F1", "F2", "F3", "F4", "F5", "F6",
    "P", "P0", "P1", "P2", "P3", "P4", "P5", "P6",
    "RAJ", "DECJ", "ELAT", "ELONG", "LAMBDA", "BETA",
    "RA_RAD", "DEC_RAD", "PMRA", "PMDEC", "PEPOCH", "POSEPOCH",
}


def create_parfile(inparfn: str, inf) -> str:
    """Scratch parfile: F0 = 0.001/dt at the .inf position/epoch, binary
    terms copied from ``inparfn`` (reference demodulate.py:53-82)."""
    outfd, outfn = tempfile.mkstemp(suffix=".par", dir=os.getcwd(),
                                    text=True)
    with os.fdopen(outfd, "w") as outff:
        outff.write("RAJ %s\n" % inf.RA)
        outff.write("DECJ %s\n" % inf.DEC)
        # 1000 samples per rotation keeps TEMPO polyco digits sufficient
        outff.write("F0 %.15f\n" % (0.001 / inf.dt))
        outff.write("F1 0\n")
        outff.write("DM 0\n")
        outff.write("PEPOCH %.15f\n" % inf.epoch)
        outff.write("POSEPOCH %.15f\n" % inf.epoch)
        outff.write("TZRMJD %.15f\n" % inf.epoch)
        outff.write("TZRSITE @\n")
        outff.write("TZRFREQ %.5f\n" % (inf.lofreq + 0.5 * inf.BW))
        with open(inparfn) as inff:
            for line in inff:
                split = line.strip().split()
                if split and split[0] not in _REPLACED_KEYS:
                    outff.write(" ".join(split[0:2]) + "\n")
    return outfn


def find_resample_events(pcos, inf, chunk: int = 1 << 20
                         ) -> Tuple[List[int], List[int]]:
    """(drop_indices, add_indices): samples where the pulsar-frame index
    drifts past half a bin.  drift(i) = psr_frame_sample(i) - i; a unit
    decrease of round(drift) drops a sample, a unit increase adds one."""
    imjd = int(np.floor(inf.epoch))
    fmjd0 = float(inf.epoch) - imjd
    samp_in_day = inf.dt / SECPERDAY
    rot0 = pcos.get_rotation(imjd, fmjd0)

    idrop: List[int] = []
    iadd: List[int] = []
    prev_k = 0
    for start in range(0, inf.N, chunk):
        n = min(chunk, inf.N - start)
        idx = start + np.arange(n, dtype=np.int64)
        fmjds = fmjd0 + idx * samp_in_day
        # evaluate each sample with its valid polyco block
        rots = np.empty(n, dtype=np.float64)
        block_of = np.array([pcos.select_polyco(imjd, float(f))
                             for f in (fmjds[0], fmjds[-1])])
        if block_of[0] == block_of[1]:
            rots = pcos.polycos[block_of[0]].rotation_batch(imjd, fmjds)
        else:
            bounds = np.searchsorted(
                pcos.TMIDs + pcos.validrange, imjd + fmjds)
            for b in np.unique(bounds):
                sel = bounds == b
                blk = pcos.select_polyco(
                    imjd, float(fmjds[sel][0]))
                rots[sel] = pcos.polycos[blk].rotation_batch(
                    imjd, fmjds[sel])
        psr_samp = (rots - rot0) * 1000.0  # 1000 samples per rotation
        drift = psr_samp - idx
        k = np.floor(drift + 0.5).astype(np.int64)
        kfull = np.concatenate(([prev_k], k))
        dk = np.diff(kfull)
        for i in np.nonzero(dk)[0]:
            step = int(dk[i])
            # multi-unit jumps would need |v| ~ c; treat each unit as an
            # event at the same sample
            if step < 0:
                idrop.extend([int(idx[i])] * (-step))
            else:
                iadd.extend([int(idx[i])] * step)
        prev_k = int(k[-1])
    return idrop, iadd


def write_resampled(indat: Datfile, outname: str,
                    idrop: List[int], iadd: List[int]) -> int:
    """Write the resampled .dat: at each drop index omit one sample, at
    each add index duplicate one; force an even total length
    (reference demodulate.py:211-231)."""
    samps = np.concatenate((idrop, iadd)).astype(np.int64)
    isdrops = np.zeros_like(samps, dtype=np.int8)
    isdrops[:len(idrop)] = 1
    order = np.argsort(samps, kind="stable")
    samps, isdrops = samps[order], isdrops[order]

    indat.rewind()
    nwritten = 0
    # atomic (PL003): a kill mid-resample must not leave a torn .dat
    # that looks complete
    with atomic_open(outname + ".dat", "wb") as outff:
        for ind, isdrop in zip(samps, isdrops):
            data = indat.read_to(int(ind))
            if data is None:
                break
            if isdrop:
                data[:-1].tofile(outff)
                nwritten += len(data) - 1
            else:
                data.tofile(outff)
                data[-1:].tofile(outff)
                nwritten += len(data) + 1
        data = indat.read_to(-1)  # rest of the file
        if data is not None and len(data):
            if (len(data) + nwritten) % 2:
                data = data[:-1]
            data.tofile(outff)
            nwritten += len(data)
        elif nwritten % 2:
            nwritten -= 1  # cannot happen with data left; safety
    return nwritten


def build_parser():
    parser = argparse.ArgumentParser(
        prog="demodulate.py",
        description="Resample a PRESTO .dat file to remove orbital "
                    "modulation (constant pulsar-frame sample rate).")
    parser.add_argument("datfile",
                        help="PRESTO *.dat file (matching *.inf required)")
    parser.add_argument("-f", "--parfile", required=True,
                        help="Parfile with the orbit to de-modulate.")
    parser.add_argument("-o", "--outname", default=None,
                        help="Output basename (default: <input>_demod)")
    parser.add_argument("--force", action="store_true",
                        help="Overwrite existing output files.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    indat = Datfile(args.datfile)
    outname = args.outname or indat.basefn + "_demod"
    for ext in (".dat", ".inf"):
        if os.path.exists(outname + ext) and not args.force:
            print("Output file (%s) already exists!" % (outname + ext),
                  file=sys.stderr)
            return 1

    parfn = create_parfile(args.parfile, indat.inf)
    try:
        pcos = create_polycos_from_inf(parfn, indat.inf)
        idrop, iadd = find_resample_events(pcos, indat.inf)
    finally:
        os.remove(parfn)
    print("Number of samples removed: %d" % len(idrop))
    print("Number of samples added: %d" % len(iadd))

    nwritten = write_resampled(indat, outname, idrop, iadd)
    indat.inf.deorbited = True
    indat.inf.N = nwritten
    indat.inf.basenm = os.path.basename(outname)
    indat.inf.to_file(outname + ".inf")
    print("Wrote %s.dat (%d samples)" % (outname, nwritten))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

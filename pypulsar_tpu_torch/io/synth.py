"""Write a synthetic SIGPROC filterbank holding a dispersed pulsar.

The port's counterpart of ``tools/make_synthetic_fil.py``: uniform noise
(0..noise_hi-1 counts) plus a periodic pulse dispersed at ``dm``, written
blockwise so a file of any length needs one block of memory. The period is
a whole number of samples, so the pulse is one [period, nchan] pattern
tiled over each block. Randomness comes from ``numpy.random.default_rng(seed)``.

Run as ``python -m pypulsar_tpu_torch.io.synth --out FILE [options]``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io import sigproc
from pypulsar_tpu_torch.io.filterbank import pack_subbyte

_DEFAULT_AMP = {8: 30, 4: 2, 2: 1}
_DEFAULT_NOISE_HI = {8: 200, 4: 14, 2: 3}


def write_synthetic_fil(path: str, nchan: int = 1024, tsamp: float = 64e-6,
                        nsamp: int = 1 << 20, fch1: float = 1500.0,
                        bw: float = 300.0, dm: float = 70.0,
                        period_samples: int = 4096, width: int = 8,
                        nbits: int = 8, amp=None, noise_hi=None,
                        seed: int = 0, blocks_per_write: int = 32) -> dict:
    """Write the file (descending band of ``bw`` MHz from ``fch1``) and
    return its geometry and injected signal. ``nsamp`` is rounded down to
    whole periods (at least one)."""
    amp = _DEFAULT_AMP[nbits] if amp is None else int(amp)
    noise_hi = _DEFAULT_NOISE_HI[nbits] if noise_hi is None else int(noise_hi)
    if not 1 <= noise_hi <= 256:
        raise ValueError("noise_hi must be in [1, 256]")
    if noise_hi - 1 + amp >= (1 << nbits):
        raise ValueError(f"noise_hi-1 + amp = {noise_hi - 1 + amp} overflows "
                         f"{nbits}-bit samples")
    C, P = int(nchan), int(period_samples)
    nsamp = max((int(nsamp) // P) * P, P)
    foff = -bw / C
    freqs = fch1 + foff * np.arange(C)
    delays = psrmath.bin_delays(dm, freqs, tsamp)
    # one period of the pulse: channel c is on at rows (delays[c] + i) % P
    pattern = np.zeros((P, C), np.uint8)
    rows = (np.arange(width)[:, None] + delays[None, :]) % P
    pattern[rows, np.arange(C)[None, :]] = amp
    hdr = {
        "source_name": f"SYNTH_DM{dm:g}_P{P}",
        "fch1": fch1, "foff": foff, "nchans": C, "tsamp": tsamp,
        "nsamples": nsamp, "nbits": nbits, "nifs": 1, "tstart": 60000.0,
        "data_type": 1, "telescope_id": 0, "machine_id": 0,
        "barycentric": 0, "src_raj": 0.0, "src_dej": 0.0,
        "az_start": 0.0, "za_start": 0.0,
    }
    rng = np.random.default_rng(seed)
    B = P * max(1, int(blocks_per_write))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(sigproc.pack_header(hdr))
        written = 0
        while written < nsamp:
            n = min(B, nsamp - written)
            # raw generator bytes through a multiply-shift range map: near-
            # uniform on 0..noise_hi-1 at memory speed
            raw = np.frombuffer(rng.bytes(n * C), np.uint8).reshape(n, C)
            block = ((raw.astype(np.uint16) * np.uint16(noise_hi))
                     >> np.uint16(8)).astype(np.uint8)
            block.reshape(n // P, P, C)[:] += pattern[None]
            if nbits < 8:
                block = pack_subbyte(block, nbits)
            block.tofile(f)
            written += n
    os.replace(tmp, path)
    return dict(path=path, nchan=C, nsamp=nsamp, tsamp=tsamp, nbits=nbits,
                fch1=fch1, foff=foff, dm=dm, period_samples=P, width=width,
                amp=amp, noise_hi=noise_hi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--nchan", type=int, default=1024)
    ap.add_argument("--tsamp", type=float, default=64e-6)
    ap.add_argument("--nsamp", type=int, default=1 << 20)
    ap.add_argument("--fch1", type=float, default=1500.0)
    ap.add_argument("--bw", type=float, default=300.0,
                    help="total MHz, descending")
    ap.add_argument("--dm", type=float, default=70.0)
    ap.add_argument("--period-samples", type=int, default=4096)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--nbits", type=int, default=8, choices=(8, 4, 2))
    ap.add_argument("--amp", type=int, default=None)
    ap.add_argument("--noise-hi", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    info = write_synthetic_fil(
        a.out, nchan=a.nchan, tsamp=a.tsamp, nsamp=a.nsamp, fch1=a.fch1,
        bw=a.bw, dm=a.dm, period_samples=a.period_samples, width=a.width,
        nbits=a.nbits, amp=a.amp, noise_hi=a.noise_hi, seed=a.seed)
    print(f"wrote {a.out}: {info['nsamp']} samples x {info['nchan']} chans, "
          f"{a.nbits}-bit; injected DM={a.dm} period={info['period_samples']} "
          f"samples width={a.width} amp={info['amp']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

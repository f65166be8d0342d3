"""Zero-DM RFI filter of a SIGPROC filterbank, on the GPU.

Port of ``pypulsar_tpu/cli/zero_dm_filter.py`` (the reference's
bin/zero_dm_filter.py:30-50): every time sample less its mean over the
channels, the header kept byte for byte. Blocks of ``BLOCK_SAMPLES``
samples travel to ``--device`` (default ``cuda``) in the file's own
dtype, are filtered there (rounded half to even and clipped for 8- and
16-bit samples) and come back in that dtype to be written; the output
appears only complete (written to a temporary name, then renamed).

A float32 mean over the channels adds in an order of its library's
choosing, so where the exact mean puts a sample on a half count, the card,
the CPU and the JAX package may round it to neighbouring counts:
:func:`unproven_differences` holds two outputs to that with a float64
twin. Sub-byte files (1, 2 or 4 bits) are refused: the JAX package writes
their unpacked samples under a header that still says packed.

:func:`filter` is the library call on one numpy block (the reference's
name), on ``device``.

Run as ``python -m pypulsar_tpu_torch.cli.zero_dm_filter FILE -o OUT``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.io import sigproc
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.ops.kernels import zero_dm
from pypulsar_tpu_torch.parallel.prefetch import ship_ahead
from pypulsar_tpu_torch.resilience.journal import atomic_open

BLOCK_SAMPLES = 1 << 16
_EPS32 = 2.0 ** -24  # float32 unit roundoff


def filter_block(raw: torch.Tensor) -> torch.Tensor:
    """One [time, chan] block in the file's dtype (uint8, uint16 carried
    as int16, or float32), zero-DM filtered on its device and returned
    in that dtype."""
    if raw.dtype == torch.float32:
        return zero_dm(raw.t()).t()
    x = raw.to(torch.int32) & 0xFFFF if raw.dtype == torch.int16 else raw
    out = torch.round(zero_dm(x.to(torch.float32).t()).t())
    if raw.dtype == torch.uint8:
        return out.clamp_(0, 255).to(torch.uint8)
    # 16-bit samples go back as the int16 of the same two bytes
    out = out.clamp_(0, 65535).to(torch.int32)
    return torch.where(out > 32767, out - 65536, out).to(torch.int16)


def filter(data: np.ndarray, device="cuda") -> np.ndarray:  # noqa: A001 - reference name
    """Zero-DM filter one numpy [time, chan] block on ``device``: each
    sample less its mean over the channels, rounded half to even and
    clipped to the dtype's range for integer dtypes, returned in
    ``data``'s dtype. uint8 and float32 blocks travel in their own dtype
    (:func:`filter_block`); any other dtype as float32, as the JAX
    package's ``filter`` widens it."""
    device = resolve_device(device)
    data = np.ascontiguousarray(data)
    if data.dtype in (np.uint8, np.float32):
        block = torch.from_numpy(data).to(device)
        return filter_block(block).cpu().numpy()
    x = torch.from_numpy(data.astype(np.float32)).to(device)
    out = zero_dm(x.t()).t()
    if np.issubdtype(data.dtype, np.integer):
        info = np.iinfo(data.dtype)
        out = torch.round(out).clamp_(float(info.min), float(info.max))
    return out.cpu().numpy().astype(data.dtype)


def zero_dm_file(infile: str, outfile: str,
                 block_samples: int = BLOCK_SAMPLES, device="cuda") -> int:
    """Filter ``infile`` into ``outfile`` on ``device``; returns the
    samples written."""
    device = resolve_device(device)
    with FilterbankFile(infile) as infb:
        if infb.nbits < 8:
            raise ValueError(
                f"{infile}: {infb.nbits}-bit samples; the zero-DM filter "
                f"writes 8-, 16- and 32-bit files only")
        with atomic_open(outfile, "wb") as out:
            out.write(sigproc.pack_header(infb.header))
            for _, block in ship_ahead(infb.iter_blocks(
                    block_samples, raw=True, borrow=True), device):
                filtered = filter_block(block).cpu().numpy()
                filtered.view(infb.dtype).tofile(out)
        return infb.nspec


def unproven_differences(block: np.ndarray, got: np.ndarray,
                         want: np.ndarray) -> np.ndarray:
    """Cells ``(t, c)`` where two zero-DM outputs of the integer
    [time, chan] ``block`` differ, other than by a proven tie. The
    float64 twin ``v = x - mean`` is exact up to its own rounding; a
    difference is a tie when the outputs are the two clipped neighbours
    of ``v`` and ``v`` lies within the float32 error bound of any
    summation order (``C * u * mean|x| + u * |v|``, u = 2^-24) of a half
    count, so float32 may round it either way."""
    x = block.astype(np.float64)
    C = x.shape[1]
    mean = x.mean(axis=1, keepdims=True)
    v = x - mean
    lo = np.floor(v)
    top = np.iinfo(block.dtype).max
    band = C * _EPS32 * np.abs(x).mean(axis=1, keepdims=True) \
        + _EPS32 * np.abs(v)
    g, w = got.astype(np.int64), want.astype(np.int64)
    neighbours = (np.minimum(g, w) == np.clip(lo, 0, top)) \
        & (np.maximum(g, w) == np.clip(lo + 1, 0, top))
    tie = np.abs(v - (lo + 0.5)) <= band
    return np.argwhere((g != w) & ~(neighbours & tie))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="zero_dm_filter",
        description="Perform a zero-DM filter on a filterbank file on the "
                    "GPU")
    parser.add_argument("infile", help="input .fil file")
    parser.add_argument("-o", "--outname", required=True,
                        help="Output filename.")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="Print debugging information.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: %(default)s; 'cpu' "
                             "runs the plain PyTorch ops)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    sys.stdout.write("Working...")
    sys.stdout.flush()
    zero_dm_file(options.infile, options.outname, device=options.device)
    sys.stdout.write("\rDone!" + " " * 50 + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Streamed flat sweep of a filterbank file.

Port of the flat path of ``pypulsar_tpu/parallel/staged.py``: raw blocks
in the file's native dtype ship ahead to the device
(:func:`~pypulsar_tpu_torch.parallel.prefetch.ship_ahead`), are unpacked,
transposed to [chan, time], widened to float32 and band-flipped there
(:func:`ingest_tc`), optionally downsampled, and fed to
:func:`~pypulsar_tpu_torch.parallel.sweep.sweep_stream`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.parallel.prefetch import ship_ahead
from pypulsar_tpu_torch.parallel.sweep import (
    DEFAULT_WIDTHS,
    SweepResult,
    choose_group_size,
    default_chunk_payload,
    make_sweep_plan,
    resolve_engine,
    sweep_stream,
)


@dataclasses.dataclass
class StepResult:
    """One sweep's output at its own time resolution."""

    downsamp: int
    dt: float  # effective (downsampled) sampling time, seconds
    result: SweepResult

    def candidates(self) -> List[dict]:
        """All (dm, width, snr, sample) records in physical units."""
        out = []
        res = self.result
        for di, dm in enumerate(res.dms):
            for wi, w in enumerate(res.widths):
                out.append(dict(
                    dm=float(dm),
                    snr=float(res.snr[di, wi]),
                    width_bins=int(w),
                    width_sec=float(w * self.dt),
                    sample=int(res.peak_sample[di, wi]),
                    time_sec=float(res.peak_sample[di, wi] * self.dt),
                    downsamp=self.downsamp,
                ))
        return out


@dataclasses.dataclass
class StagedSweepResult:
    """The steps' results plus global candidate selection."""

    steps: List[StepResult]

    @property
    def n_trials(self) -> int:
        return sum(len(s.result.dms) for s in self.steps)

    def best(self, k: int = 10) -> List[dict]:
        """Global top-k candidates (best width per trial) across steps."""
        cands = []
        for s in self.steps:
            res = s.result
            wi = np.argmax(res.snr, axis=1)
            for di, dm in enumerate(res.dms):
                w = res.widths[wi[di]]
                cands.append(dict(
                    dm=float(dm),
                    snr=float(res.snr[di, wi[di]]),
                    width_bins=int(w),
                    width_sec=float(w * s.dt),
                    sample=int(res.peak_sample[di, wi[di]]),
                    time_sec=float(res.peak_sample[di, wi[di]] * s.dt),
                    downsamp=s.downsamp,
                ))
        cands.sort(key=lambda c: -c["snr"])
        return cands[:k]

    def above_threshold(self, snr: float) -> List[dict]:
        """All per-(trial, width) detections above ``snr``, time-ordered."""
        out = [c for s in self.steps for c in s.candidates() if c["snr"] >= snr]
        out.sort(key=lambda c: (c["dm"], c["time_sec"]))
        return out


def band_orientation(freqs) -> Tuple[np.ndarray, bool]:
    """(high-frequency-first channel table, whether it was flipped)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    flip = len(freqs) > 1 and freqs[0] < freqs[-1]
    return (freqs[::-1].copy() if flip else freqs), flip


def ingest_tc(raw_tc: torch.Tensor, flip: bool, nbits: int = 8):
    """[time, chan] native-dtype block -> [chan, time] float32, optionally
    band-flipped, on the block's device. ``nbits`` < 8 means ``raw_tc`` is
    packed [time, nchans*nbits//8] uint8 (low bits = lower channel) and is
    unpacked here; 16-bit samples arrive as int16 and are widened as
    unsigned. Integer to float32 is exact."""
    if nbits < 8:
        spb = 8 // nbits
        mask = (1 << nbits) - 1
        parts = [(raw_tc >> (nbits * i)) & mask for i in range(spb)]
        raw_tc = torch.stack(parts, dim=-1).reshape(raw_tc.shape[0],
                                                    raw_tc.shape[1] * spb)
    elif raw_tc.dtype == torch.int16:
        raw_tc = raw_tc.to(torch.int32) & 0xFFFF
    d = raw_tc.t().to(torch.float32, memory_format=torch.contiguous_format)
    return torch.flip(d, dims=(0,)) if flip else d


class ReaderSource:
    """High-frequency-first block source over a
    :class:`~pypulsar_tpu_torch.io.filterbank.FilterbankFile`."""

    def __init__(self, reader):
        self.reader = reader
        self.frequencies, self._flip = band_orientation(reader.frequencies)
        self.tsamp = float(reader.tsamp)
        self.nsamples = int(reader.nspec)
        self.nbits = int(reader.nbits)

    def chan_major_blocks(self, payload: int, overlap: int, device):
        """(pos, [chan, time] float32 block on ``device``) stepping by
        ``payload``, each with ``overlap`` samples of lookahead."""
        if self.nbits == 32:
            # float payloads have no native-dtype ingest to save wire bytes
            raise NotImplementedError(
                "float32 .fil input is not ported yet (ROADMAP.md Queue 1)")
        raw = self.reader.iter_blocks(payload, overlap, raw=True)
        nbits = min(self.nbits, 8)
        for pos, dev in ship_ahead(raw, device):
            yield pos, ingest_tc(dev, self._flip, nbits)


def downsampled_blocks(src, factor: int, payload_ds: int, overlap_ds: int,
                       device):
    """Chan-major device blocks downsampled by ``factor`` (co-added in
    float32 on the device; a partial trailing bin is dropped). Raw blocks
    are read at ``factor`` times the downsampled geometry so bin edges
    line up across chunks."""
    for pos, data in src.chan_major_blocks(payload_ds * factor,
                                           overlap_ds * factor, device):
        if factor > 1:
            nbin = data.shape[1] // factor
            if nbin == 0:
                continue  # tail shorter than one output bin
            data = data[:, :nbin * factor].reshape(
                data.shape[0], nbin, factor).sum(dim=-1)
        yield pos // factor, data


def run_step(src, dms, factor: int, nsub: int, group_size: int,
             widths: Tuple[int, ...], chunk_payload: Optional[int],
             device, verbose: bool = False) -> Optional[StepResult]:
    """Sweep ``dms`` over ``src`` downsampled by ``factor``.
    ``group_size`` <= 0 picks the largest group within the smearing bound."""
    dt_eff = src.tsamp * factor
    n_ds = src.nsamples // factor
    if n_ds == 0:
        return None
    if group_size <= 0:
        group_size = choose_group_size(dms, src.frequencies, dt_eff, nsub)
    plan = make_sweep_plan(dms, src.frequencies, dt_eff, nsub=nsub,
                           group_size=group_size, widths=widths)
    if chunk_payload is None:
        chunk_payload = default_chunk_payload(plan.min_overlap)
    payload = min(chunk_payload, n_ds)
    if payload <= plan.min_overlap:
        payload = min(n_ds, 2 * plan.min_overlap + 1)
    if verbose:
        print(f"# downsamp={factor} dt={dt_eff:.3e}s "
              f"DMs {dms[0]:.2f}..{dms[-1]:.2f} ({len(dms)} trials, "
              f"group {group_size}) payload={payload}")
    res = sweep_stream(
        plan, downsampled_blocks(src, factor, payload, plan.min_overlap,
                                 device),
        payload, device=device)
    return StepResult(downsamp=factor, dt=dt_eff, result=res)


def sweep_flat(source, dms, downsamp: int = 1, nsub: int = 64,
               group_size: int = 32, widths: Sequence[int] = DEFAULT_WIDTHS,
               chunk_payload: Optional[int] = None, verbose: bool = False,
               engine: str = "auto", device="cuda") -> StagedSweepResult:
    """Single-step sweep of an explicit DM grid over a filterbank reader,
    streamed in chunks of ``chunk_payload`` (default: 2^18 samples less
    the overlap) on ``device``."""
    resolve_engine(engine)
    device = resolve_device(device)
    step = run_step(ReaderSource(source), np.asarray(dms, dtype=np.float64),
                    int(downsamp), nsub, group_size, tuple(widths),
                    chunk_payload, device, verbose=verbose)
    return StagedSweepResult(steps=[] if step is None else [step])

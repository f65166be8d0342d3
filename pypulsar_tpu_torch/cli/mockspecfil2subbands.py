"""Convert a SIGPROC filterbank file into PRESTO per-channel subband files.

Behavioral spec: reference ``bin/mockspecfil2subbands.py`` — one
``.sub%04d`` file per channel (subband order inverted for negative-foff
bands; :140-149), blockwise transpose-and-scatter of samples (:155-175),
plus a PRESTO ``.inf`` describing the set (:40-129).

Copy of ``pypulsar_tpu/cli/mockspecfil2subbands.py`` (host numpy); the
``.inf`` names this package as its analyzer.
"""

from __future__ import annotations

import argparse
import sys

from pypulsar_tpu_torch.astro import coordconv
from pypulsar_tpu_torch.io import sigproc
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.infodata import InfoData

SAMPLES_PER_READ = 1024 * 4


def write_info_file(filfile: FilterbankFile, outname: str) -> str:
    """Write the ``<outname>.sub.inf`` file describing the subband set
    (schema: reference mockspecfil2subbands.py:40-129)."""
    hdr = filfile.header
    inf = InfoData()
    inf.basenm = "%s.sub" % outname
    inf.telescope = sigproc.ids_to_telescope.get(
        hdr.get("telescope_id"), "????")
    inf.instrument = sigproc.ids_to_machine.get(hdr.get("machine_id"), "????")
    inf.object = hdr.get("source_name", "Unknown")
    raj = hdr.get("src_raj", 0.0)
    dej = hdr.get("src_dej", 0.0)
    inf.RA = coordconv.rastr_to_fmrastr(raj)
    inf.DEC = coordconv.decstr_to_fmdecstr(dej)
    inf.observer = "Unknown"
    inf.epoch = hdr["tstart"]
    inf.bary = 0
    inf.N = filfile.nspec
    inf.dt = hdr["tsamp"]
    inf.breaks = 0
    inf.waveband = "Radio"
    inf.beam_diam = 175  # ALFA
    inf.DM = 0
    foff, nchans = hdr["foff"], hdr["nchans"]
    chanbw = abs(foff)
    totalbw = chanbw * nchans
    lofreq = hdr["fch1"] - totalbw if foff < 0 else hdr["fch1"]
    inf.lofreq = lofreq
    inf.BW = totalbw
    inf.numchan = nchans
    inf.chan_width = chanbw
    inf.analyzer = "pypulsar_tpu_torch"
    inf.notes = ["    Subbands and inf file created by "
                 "pypulsar_tpu_torch mockspecfil2subbands"]
    inffn = "%s.sub.inf" % outname
    inf.to_file(inffn)
    return inffn


def fil_to_subbands(infile: str, outname: str,
                    samples_per_read: int = SAMPLES_PER_READ) -> None:
    with FilterbankFile(infile) as fb:
        write_info_file(fb, outname)
        nchans = int(fb.header["nchans"])
        foff = fb.header["foff"]
        if foff > 0:
            subnums = list(range(nchans))
        elif foff < 0:
            # subband files are low-frequency-first; invert the band
            subnums = list(range(nchans - 1, -1, -1))
        else:
            raise ValueError("Channel bandwidth is 0!")
        filenames = ["%s.sub%04d" % (outname, s) for s in subnums]
        outfiles = [open(fn, "wb") for fn in filenames]
        try:
            pos = 0
            total = fb.nspec
            while pos < total:
                n = min(samples_per_read, total - pos)
                block = fb.get_samples(pos, n).T  # [chan, time]
                for j in range(nchans):
                    block[j].astype(fb.dtype).tofile(outfiles[j])
                pos += n
        finally:
            for f in outfiles:
                f.close()


def build_parser():
    parser = argparse.ArgumentParser(
        prog="mockspecfil2subbands.py",
        description="Convert filterbank data (from MockSpec data) to "
                    "PRESTO subbands. Each subband is one channel.")
    parser.add_argument("infile", help="input .fil file")
    parser.add_argument("-o", "--outname", required=True,
                        help="Output basename (no extension).")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    sys.stdout.write("Working...")
    sys.stdout.flush()
    fil_to_subbands(options.infile, options.outname)
    sys.stdout.write("\rDone!       \n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's run journal (``resilience/journal.py``) and the resume of
the sweep stage it keeps (``cli.sweep --journal``,
``--accel-skip-existing``), on the CPU.

Contracts: a rerun with the same journal and flags redoes no unit and
changes no byte; a truncated ``.cand`` is redone to the same bytes; a
changed mask (another path, or other contents at the same path), DM
grid or chunk engine starts over; the artifacts are the same bytes
with and without ``--journal``; the journal itself tolerates a torn
last line and refuses another tool's.
"""

import glob
import hashlib
import json
import os

import pytest

from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.io.rfimask import write_mask
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel import accelpipe, staged
from pypulsar_tpu_torch.resilience.journal import (
    RunJournal,
    atomic_open,
    file_digest,
)
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "6", "-s", "8",
         "--group-size", "2", "--threshold", "6"]
ACCEL = ["--accel-search", "--accel-zmax", "10", "--accel-numharm", "2",
         "--accel-sigma", "3", "--accel-batch", "4", "--write-dats"]


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


def test_journal_records_validate_and_survive_a_reopen(tmp_path):
    art = _write(str(tmp_path / "a.txt"), "alpha")
    jp = str(tmp_path / "j.jsonl")
    with RunJournal(jp, "fp1", tool="t") as j:
        assert j.completed() == set()
        j.done("u1", [art])
        j.note(event="milestone", n=1)
        assert j.completed() == {"u1"}
    assert RunJournal(jp, "fp1", tool="t").completed() == {"u1"}
    rec = [json.loads(ln) for ln in open(jp)]
    assert rec[0] == {"type": "journal", "version": 1, "tool": "t",
                      "fingerprint": "fp1"}
    assert rec[1]["outputs"] == [{"path": art, "bytes": 5,
                                  "sha256": hashlib.sha256(b"alpha")
                                  .hexdigest()}]
    assert rec[2] == {"type": "note", "event": "milestone", "n": 1}


@pytest.mark.parametrize("damage", ["truncate", "rewrite", "delete"])
def test_a_damaged_artifact_is_redone(tmp_path, damage):
    art = _write(str(tmp_path / "a.txt"), "alpha")
    keep = _write(str(tmp_path / "b.txt"), "beta")
    jp = str(tmp_path / "j.jsonl")
    with RunJournal(jp, "fp", tool="t") as j:
        j.done("a", [art])
        j.done("b", [keep])
    if damage == "truncate":
        _write(art, "alp")
    elif damage == "rewrite":
        _write(art, "ALPHA")
    else:
        os.remove(art)
    assert RunJournal(jp, "fp", tool="t").completed() == {"b"}


def test_torn_last_line_is_dropped_and_overwritten(tmp_path):
    art = _write(str(tmp_path / "a.txt"), "alpha")
    jp = str(tmp_path / "j.jsonl")
    with RunJournal(jp, "fp", tool="t") as j:
        j.done("a", [art])
    with open(jp, "a") as f:
        f.write('{"type": "done", "unit": "b", "outp')  # a kill mid-append
    with RunJournal(jp, "fp", tool="t") as j:
        assert j.completed() == {"a"}
        j.done("c", [art])
    lines = open(jp).read().splitlines()
    assert len(lines) == 3 and all(json.loads(ln) for ln in lines)
    assert RunJournal(jp, "fp", tool="t").completed() == {"a", "c"}


def test_another_fingerprint_restarts_another_tool_refuses(tmp_path):
    art = _write(str(tmp_path / "a.txt"), "alpha")
    jp = str(tmp_path / "j.jsonl")
    with RunJournal(jp, "fp1", tool="t") as j:
        j.done("a", [art])
    j2 = RunJournal(jp, "fp2", tool="t")
    assert j2.completed() == set()
    j2.note(event="start")
    j2.close()
    assert json.loads(open(jp).readline())["fingerprint"] == "fp2"
    with pytest.raises(ValueError, match="different tool"):
        RunJournal(jp, "fp2", tool="other")


def test_atomic_open_publishes_only_whole_files(tmp_path):
    path = str(tmp_path / "out.bin")
    with atomic_open(path) as f:
        f.write(b"one")
    with pytest.raises(RuntimeError):
        with atomic_open(path) as f:
            f.write(b"two, torn")
            raise RuntimeError("killed")
    assert open(path, "rb").read() == b"one"
    assert os.listdir(tmp_path) == ["out.bin"]
    for mode in ("ab", "rb", "r+b"):
        with pytest.raises(ValueError, match="not a fresh write"):
            with atomic_open(path, mode):
                pass
    assert file_digest(path) == (3, hashlib.sha256(b"one").hexdigest())


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    d = tmp_path_factory.mktemp("journal")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=32, tsamp=5e-4, nsamp=1 << 13,
                        fch1=1500.0, bw=128.0, dm=30.0, period_samples=256,
                        width=4, seed=4)
    mask = write_mask(str(d / "a.mask"), nchan=32, nint=4, ptsperint=2048,
                      zap_chans=[3, 4], zap_chans_per_int=[[], [9], [], []])
    mask2 = write_mask(str(d / "b.mask"), nchan=32, nint=4, ptsperint=2048,
                       zap_chans=[3, 5], zap_chans_per_int=[[], [9], [], []])
    plain = str(d / "plain")
    assert cli.main([fil, "-o", plain, *SWEEP, *ACCEL, "--mask", mask,
                     "--device", "cpu"]) == 0
    return dict(dir=d, fil=fil, mask=mask, mask2=mask2, plain=plain)


def _artifacts(outbase):
    """Every artifact's bytes by suffix; an ``.inf`` without its first
    line, which names the outbase."""
    out = {}
    for p in sorted(glob.glob(outbase + ".cands")
                    + glob.glob(outbase + "_DM*")):
        with open(p, "rb") as f:
            data = f.read()
        out[p[len(outbase):]] = (data.split(b"\n", 1)[1]
                                 if p.endswith(".inf") else data)
    return out


def _run(obs, outbase, *extra, mask=None):
    return cli.main([obs["fil"], "-o", outbase, *SWEEP, *ACCEL, "--mask",
                     mask or obs["mask"], "--journal", outbase + ".jsonl",
                     "--device", "cpu", *extra])


class _Count:
    """Counts the calls of ``module.name`` through monkeypatch."""

    def __init__(self, monkeypatch, module, name):
        real = getattr(module, name)
        self.calls = 0

        def wrapper(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)


def _done_units(path):
    return [json.loads(ln)["unit"] for ln in open(path)
            if '"type": "done"' in ln]


def test_journal_run_equals_the_plain_run_and_reruns_nothing(
        obs, monkeypatch, capsys):
    out = str(obs["dir"] / "j")
    assert _run(obs, out) == 0
    first = _artifacts(out)
    assert first == _artifacts(obs["plain"]) and len(first) == 1 + 6 * 4
    assert sorted(_done_units(out + ".jsonl")) == sorted(
        ["sweep:cands"] + [f"cand:DM{10.0 * i:.2f}" for i in range(6)])
    capsys.readouterr()
    sweeps = _Count(monkeypatch, staged, "sweep_flat")
    searches = _Count(monkeypatch, accelpipe, "accel_search_batch")
    assert _run(obs, out) == 0
    said = capsys.readouterr().out
    assert "skipping the single-pulse sweep pass" in said
    assert "0 trials searched, 6 skipped" in said
    assert sweeps.calls == 0 and searches.calls == 0
    assert len(_done_units(out + ".jsonl")) == 7
    assert _artifacts(out) == first


def test_truncated_cand_is_redone_to_the_same_bytes(obs, monkeypatch,
                                                    capsys):
    out = str(obs["dir"] / "t")
    assert _run(obs, out) == 0
    first = _artifacts(out)
    victim = out + "_DM20.00_ACCEL_10.cand"
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    capsys.readouterr()
    searches = _Count(monkeypatch, accelpipe, "accel_search_batch")
    assert _run(obs, out) == 0
    assert "1 trials searched, 5 skipped" in capsys.readouterr().out
    assert searches.calls == 1
    assert _artifacts(out) == first


@pytest.mark.parametrize("change", ["mask", "mask_content", "grid",
                                    "engine"])
def test_changed_mask_or_grid_starts_over(obs, capsys, change):
    """Another mask, another mask written at the same path (as the
    survey's mask stage does on every run), another DM grid or another
    chunk engine (a journal written under ``gather`` rerun under
    ``tree``; the engines agree only within tolerance): every unit is
    redone."""
    import shutil

    out = str(obs["dir"] / f"c_{change}")
    at_one_path = out + "_rfifind.mask"
    shutil.copyfile(obs["mask"], at_one_path)
    assert _run(obs, out, mask=at_one_path if change == "mask_content"
                else None) == 0
    capsys.readouterr()
    if change == "mask":
        assert _run(obs, out, mask=obs["mask2"]) == 0
    elif change == "mask_content":
        shutil.copyfile(obs["mask2"], at_one_path)
        assert _run(obs, out, mask=at_one_path) == 0
    elif change == "grid":
        assert _run(obs, out, "--dmstep", "11") == 0
    else:
        assert _run(obs, out, "--engine", "tree") == 0
    said = capsys.readouterr().out
    assert "skipping the single-pulse sweep pass" not in said
    assert "6 trials searched, 0 skipped" in said
    header = json.loads(open(out + ".jsonl").readline())
    assert header["type"] == "journal" and header["tool"] == "sweep-accel"
    assert len(_done_units(out + ".jsonl")) == 7


def test_accel_skip_existing_skips_validated_pairs(obs, capsys):
    out = str(obs["dir"] / "s")
    assert cli.main([obs["fil"], "-o", out, *SWEEP, *ACCEL, "--mask",
                     obs["mask"], "--device", "cpu"]) == 0
    first = _artifacts(out)
    os.remove(out + "_DM30.00_ACCEL_10.txtcand")
    capsys.readouterr()
    assert cli.main([obs["fil"], "-o", out, *SWEEP, *ACCEL, "--mask",
                     obs["mask"], "--accel-only", "--accel-skip-existing",
                     "--device", "cpu"]) == 0
    assert "1 trials searched, 5 skipped" in capsys.readouterr().out
    assert _artifacts(out) == first


def test_fingerprint_keys_on_the_mask_content_at_one_path(obs, tmp_path):
    """The chain journal's fingerprint hashes the zap table as well as the
    mask's path: the survey's mask stage rewrites one path on every run."""
    import shutil

    from pypulsar_tpu_torch.io.rfimask import RfifindMask

    path = str(tmp_path / "obs_rfifind.mask")
    args = cli._parser().parse_args([obs["fil"], *SWEEP, *ACCEL,
                                     "--mask", path])
    prints = []
    for src in (obs["mask"], obs["mask"], obs["mask2"]):
        shutil.copyfile(src, path)
        prints.append(cli._journal_fingerprint(
            args, [0.0, 10.0], (1, 2), "o", RfifindMask(path)))
    assert prints[0] == prints[1] != prints[2]


def test_notes_read_back_as_the_reference_reads_them(tmp_path):
    """``RunJournal.notes`` (all of them, or one event's) gives the JAX
    package's records for the same journal, a torn last line ignored."""
    from pypulsar_tpu.resilience.journal import RunJournal as JaxJournal

    path = str(tmp_path / "n.jsonl")
    out = str(tmp_path / "a.txt")
    _write(out, "x")
    with RunJournal(path, "fp", tool="foldbatch") as j:
        j.note(event="fold_result", name="c0", best_period=0.5)
        j.done("fold:c0", [out])
        j.note(event="foldbatch_done", n_folded=1)
        j.note(event="fold_result", name="c1", best_period=0.25)
    with open(path, "a") as f:
        f.write('{"type": "note", "event": "fold_res')
    ours = RunJournal(path, "fp", tool="foldbatch")
    theirs = JaxJournal(path, "fp", tool="foldbatch")
    for event in (None, "fold_result", "foldbatch_done", "absent"):
        assert ours.notes(event) == theirs.notes(event)
    assert [n["name"] for n in ours.notes("fold_result")] == ["c0", "c1"]
    assert RunJournal(path, "other", tool="foldbatch").notes() == []

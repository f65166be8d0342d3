"""``python -m pypulsar_tpu_torch.cli <tool>``, the port's tool dispatcher
(``cli/__main__.py``), against the JAX package's.

Contracts: the JAX package's tool list in its order; every tool the port
has runs through the dispatcher with the exit code and outputs of its
own ``main``; an unported tool exits 2 naming its ROADMAP.md item, an
unknown one exits 2 with the JAX package's closest-match hint; a bare
call lists the tools and exits 1, ``--help`` exits 0.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from pypulsar_tpu.cli import __main__ as jax_dispatch
from pypulsar_tpu_torch.cli import __main__ as dispatch
from pypulsar_tpu_torch.io.synth import write_synthetic_fil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_DIR = os.path.join(HERE, "pypulsar_tpu_torch", "cli")
PORTED = [t for t in dispatch.TOOLS if t not in dispatch.NOT_PORTED]


def test_tool_list_is_the_references():
    assert dispatch.TOOLS == jax_dispatch.TOOLS
    assert set(dispatch.NOT_PORTED) <= set(dispatch.TOOLS)
    assert len(PORTED) == 19
    for tool in dispatch.TOOLS:
        has_module = os.path.exists(os.path.join(CLI_DIR, f"{tool}.py"))
        assert has_module == (tool in PORTED), tool


@pytest.mark.parametrize("tool", PORTED)
def test_ported_tools_have_a_main(tool):
    mod = importlib.import_module(f"pypulsar_tpu_torch.cli.{tool}")
    assert callable(mod.main)


@pytest.mark.parametrize("tool", sorted(dispatch.NOT_PORTED))
def test_unported_tool_exits_2_naming_its_item(tool, capsys):
    assert dispatch.main([tool, "--help"]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md Queue 1 item 16" in err


@pytest.mark.parametrize("name", ["swep", "pfdsnr", "zzz"])
def test_unknown_tool_exits_2_with_the_references_hint(name, capsys):
    assert dispatch.main([name]) == 2
    got = capsys.readouterr().err
    assert jax_dispatch.main([name]) == 2
    want = capsys.readouterr().err
    assert got.replace("pypulsar_tpu_torch", "pypulsar_tpu") == want
    assert ("did you mean" in got) == (name != "zzz")


def test_bare_call_and_help(capsys):
    assert dispatch.main([]) == 1
    listing = capsys.readouterr().out
    for tool in dispatch.TOOLS:
        assert f"  {tool}" in listing
    assert listing.count("not ported yet") == len(dispatch.NOT_PORTED)
    assert dispatch.main(["--help"]) == 0
    assert dispatch.main(["-h"]) == 0


def _run(*args):
    env = dict(os.environ, PYTHONPATH=HERE)
    return subprocess.run([sys.executable, "-m", "pypulsar_tpu_torch.cli",
                           *args], capture_output=True, text=True, env=env,
                          cwd=HERE, timeout=300)


def test_module_entry_point_exit_codes():
    """``python -m``: a ported tool's --help exits 0, an unknown tool and
    an unported one exit 2."""
    assert _run("sift", "--help").returncode == 0
    bad = _run("swep")
    assert bad.returncode == 2 and "did you mean 'sweep'" in bad.stderr
    assert _run("tune").returncode == 2
    assert _run().returncode == 1


def test_sweep_through_the_dispatcher_is_the_tools_own(tmp_path, capsys):
    fil = str(tmp_path / "obs.fil")
    write_synthetic_fil(fil, nchan=32, tsamp=5e-4, nsamp=1 << 13,
                        fch1=1500.0, bw=128.0, dm=30.0, period_samples=512,
                        width=4, seed=2)
    common = [fil, "--numdms", "8", "--dmstep", "8", "-s", "8",
              "--device", "cpu"]
    from pypulsar_tpu_torch.cli import sweep

    assert dispatch.main(["sweep", *common, "-o", str(tmp_path / "a")]) == 0
    assert sweep.main([*common, "-o", str(tmp_path / "b")]) == 0
    with open(tmp_path / "a.cands") as a, open(tmp_path / "b.cands") as b:
        rows = a.read()
        assert rows == b.read()
    assert len(rows.splitlines()) > 1
    assert np.isfinite(float(rows.splitlines()[1].split()[1]))
    capsys.readouterr()

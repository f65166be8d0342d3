"""psrlint for the port (``pypulsar_tpu_torch/analysis``,
``cli/psrlint.py``) against the JAX package's linter.

- The rules whose logic the port keeps (PL001, PL003, PL005-PL009,
  PL012-PL017): on the reference's own fixture pairs (a true positive and
  a near miss a rule), with the package prefix swapped, the port's
  findings (rule, line, column) are the JAX linter's.
- The torch counterparts (PL002, PL004, PL011, PL013, PL018) and
  PL005's keyword forms of a fault point: fixture pairs of their own.
- The machinery: suppressions, select, ignore, baseline, the JSON report,
  the CLI's exit codes.
- The gate: the port's linter over its default scope (the package, its
  tests and ``chip_smoke.py``) exits 0.
- The event the gate found nobody asserting: ``survey.claim_terminal``.

Fixtures are written into a temporary tree, so each rule's path scopes
are exercised as the real gate sees them.
"""

import json
import os

import pytest

from pypulsar_tpu.analysis import all_rules as jax_all_rules
from pypulsar_tpu.analysis.engine import run as jax_engine_run
from pypulsar_tpu_torch.analysis import all_rules, rules, run_psrlint
from pypulsar_tpu_torch.analysis.engine import run as engine_run
from pypulsar_tpu_torch.cli import psrlint as cli

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(root, files):
    for rel, src in files.items():
        full = root / rel
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(src)
    return sorted({rel.split("/")[0] for rel in files})


def lint(tmp_path, files, **kw):
    """Write {relpath: source} under tmp_path and lint the tree with the
    port's rules."""
    paths = _write(tmp_path, files)
    return engine_run(all_rules(), paths, str(tmp_path), **kw)


def codes(report):
    return [f.rule for f in report.findings]


def _to_port(rel):
    if rel.startswith("pypulsar_tpu/"):
        return "pypulsar_tpu_torch/" + rel[len("pypulsar_tpu/"):]
    return "chip_smoke.py" if rel == "bench.py" else rel


# ---------------------------------------------------------------------------
# the rules whose logic is the reference's: the reference's fixture pairs,
# through both linters

#: case -> (files at the JAX package's paths, rule, the expected codes)
PARITY = {
    "pl001_true_positive": ({"pypulsar_tpu/a.py":
                             "def f(a, n):\n"
                             "    x = a[n / 2]\n"
                             "    for i in range(n / 4):\n"
                             "        x += i\n"
                             "    return x\n"}, "PL001", ["PL001"] * 2),
    "pl001_near_miss": ({"pypulsar_tpu/a.py":
                         "def f(a, n):\n"
                         "    x = a[n // 2] + a[int(n / 2)]\n"
                         "    mean = x / n\n"
                         "    return x[: n // 4], mean\n"}, "PL001", []),
    "pl003_true_positive": ({"pypulsar_tpu/writer.py":
                             "def save(outname, rows):\n"
                             "    with open(outname + '.cands', 'w') as f:\n"
                             "        f.write(str(rows))\n"}, "PL003",
                            ["PL003"]),
    "pl003_near_miss": ({"pypulsar_tpu/writer.py":
                         "import os\n"
                         "def save(outname, rows):\n"
                         "    with open(outname + '.cands.tmp', 'w') as f:\n"
                         "        f.write(str(rows))\n"
                         "    os.replace(outname + '.cands.tmp',\n"
                         "               outname + '.cands')\n"
                         "def load(outname):\n"
                         "    with open(outname + '.cands') as f:\n"
                         "        return f.read()\n"
                         "def note(logdir):\n"
                         "    open(logdir + '/notes.txt', 'w').close()\n"},
                        "PL003", []),
    "pl005_true_positive": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "def work():\n"
            "    faultinject.trip('real.point')\n",
        "tests/test_faults.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "def test_ghost():\n"
            "    faultinject.configure('oom:ghost.point:1')\n",
    }, "PL005", ["PL005"]),
    "pl005_near_miss": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "def work(stage):\n"
            "    faultinject.trip('real.point')\n"
            "    faultinject.trip(f'survey.stage_start.{stage}')\n",
        "tests/test_faults.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "def test_real():\n"
            "    faultinject.configure(\n"
            "        'oom:real.point:1, io:survey.stage_start.sweep')\n"
            "def test_selfmade():\n"
            "    faultinject.configure('io:mine:1')\n"
            "    faultinject.trip('mine')\n",
    }, "PL005", []),
    "pl005_tuple_point_registry_defines": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "FAULT_POINTS = ('broker.submit', 'broker.dispatch')\n"
            "def work():\n"
            "    for p in FAULT_POINTS:\n"
            "        faultinject.trip(p)\n",
        "tests/test_faults.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "def test_real():\n"
            "    faultinject.configure(\n"
            "        'io:broker.submit:1, kill:broker.dispatch:1')\n"
            "def test_ghost():\n"
            "    faultinject.configure('io:broker.ghost:1')\n",
    }, "PL005", ["PL005"]),
    "pl005_bench_reference": ({
        "pypulsar_tpu/prod.py":
            "def work(fi):\n"
            "    fi.trip('real.point')\n",
        "bench.py":
            "SPEC = 'oom:real.point:1,hang:ghost.bench:2'\n",
    }, "PL005", ["PL005"]),
    "pl006_true_positive": ({"pypulsar_tpu/io/fmt.py":
                             "import struct\n"
                             "def header(f):\n"
                             "    (n,) = struct.unpack('<i', f.read(4))\n"
                             "    return f.read(n).decode('ascii')\n"},
                            "PL006", ["PL006"] * 2),
    "pl006_near_miss": ({
        "pypulsar_tpu/io/fmt.py":
            "import struct\n"
            "from pypulsar_tpu.io.errors import read_exact\n"
            "def header(f, path):\n"
            "    (n,) = struct.unpack('<i', read_exact(f, 4, path, 'len'))\n"
            "    return read_exact(f, n, path, 'name').decode('ascii')\n",
        "pypulsar_tpu/utils/scratch.py":
            "import struct\n"
            "def peek(f):\n"
            "    return struct.unpack('<i', f.read(4))\n",
    }, "PL006", []),
    "pl007_true_positive": ({"pypulsar_tpu/mod.py":
                             "def f(x, acc=[], opts={}):\n"
                             "    return x, acc, opts\n"}, "PL007",
                            ["PL007"] * 2),
    "pl007_near_miss": ({"pypulsar_tpu/mod.py":
                         "def f(x, acc=None, opts=(), name=''):\n"
                         "    acc = [] if acc is None else acc\n"
                         "    return x, acc, opts, name\n"}, "PL007", []),
    "pl008_true_positive": ({"pypulsar_tpu/mod.py":
                             "from pypulsar_tpu.obs import telemetry\n"
                             "def work():\n"
                             "    telemetry.span('stage')\n"
                             "    return 1\n"}, "PL008", ["PL008"]),
    "pl008_near_miss": ({"pypulsar_tpu/mod.py":
                         "import contextlib\n"
                         "from pypulsar_tpu.obs import telemetry\n"
                         "def work(trace):\n"
                         "    with telemetry.span('stage'):\n"
                         "        pass\n"
                         "    with contextlib.ExitStack() as es:\n"
                         "        es.enter_context(telemetry.span('s2'))\n"
                         "    trace.span('done', 0.0, 1.0)\n"
                         "def shim(name):\n"
                         "    return telemetry.span(name)\n"}, "PL008", []),
    "pl009_true_positive": ({"pypulsar_tpu/parallel/stage.py":
                             "def run(fn):\n"
                             "    try:\n"
                             "        return fn()\n"
                             "    except Exception:\n"
                             "        return None\n"}, "PL009", ["PL009"]),
    "pl009_hyphenated_word_is_not_a_reason": ({
        "pypulsar_tpu/survey/util.py":
            "def run(fn):\n"
            "    try:\n"
            "        return fn()\n"
            "    except Exception:  # best-effort\n"
            "        return None\n"}, "PL009", ["PL009"]),
    "pl009_near_miss": ({
        "pypulsar_tpu/parallel/stage.py":
            "from pypulsar_tpu.resilience import health\n"
            "def run(fn):\n"
            "    try:\n"
            "        return fn()\n"
            "    except Exception as e:\n"
            "        if health.no_degrade(e):\n"
            "            raise\n"
            "        return None\n"
            "def probe(fn):\n"
            "    try:\n"
            "        return fn()\n"
            "    except Exception:  # noqa: BLE001 - probe is best-effort\n"
            "        return None\n"
            "def ferry(fn):\n"
            "    try:\n"
            "        return fn(), None\n"
            "    except Exception as e:\n"
            "        return None, e\n",
        "pypulsar_tpu/astro/coords.py":
            "def parse(s):\n"
            "    try:\n"
            "        return float(s)\n"
            "    except Exception:\n"
            "        return None\n",
    }, "PL009", []),
    "pl012_cross_file_cycle": ({
        "pypulsar_tpu/a.py":
            "def one(sched, health):\n"
            "    with sched._lock:\n"
            "        with health._lock:\n"
            "            pass\n",
        "pypulsar_tpu/b.py":
            "def two(sched, health):\n"
            "    with health._lock:\n"
            "        with sched._lock:\n"
            "            pass\n",
    }, "PL012", ["PL012"]),
    "pl012_self_deadlock": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "a_lock = threading.Lock()\n"
            "b_lock = threading.Lock()\n"
            "def nested_same():\n"
            "    with a_lock:\n"
            "        with a_lock:\n"
            "            pass\n",
    }, "PL012", ["PL012"]),
    "pl012_near_miss": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "a_lock = threading.Lock()\n"
            "b_lock = threading.Lock()\n"
            "an_rlock = threading.RLock()\n"
            "def one():\n"
            "    with a_lock:\n"
            "        with b_lock:\n"
            "            pass\n"
            "def two():\n"
            "    with a_lock:\n"
            "        with b_lock:\n"
            "            pass\n"
            "def re():\n"
            "    with an_rlock:\n"
            "        with an_rlock:\n"
            "            pass\n"
            "def files(path):\n"
            "    with open(path) as f:\n"
            "        with open(path + '2') as g:\n"
            "            return f, g\n",
    }, "PL012", []),
    "pl013_true_positive": ({
        "pypulsar_tpu/mod.py":
            "import time, threading, subprocess\n"
            "a_lock = threading.Lock()\n"
            "def slow(t, fut):\n"
            "    with a_lock:\n"
            "        time.sleep(1)\n"
            "        open('x.txt').read()\n"
            "        subprocess.run(['true'])\n"
            "        fut.result()\n"
            "        t.join(timeout=5)\n",
    }, "PL013", ["PL013"] * 5),
    "pl013_near_miss": ({
        "pypulsar_tpu/mod.py":
            "import time, threading\n"
            "a_lock = threading.Lock()\n"
            "a_cv = threading.Condition(a_lock)\n"
            "def ok(parts):\n"
            "    with a_lock:\n"
            "        n = len(parts)\n"
            "        name = ','.join(parts)\n"
            "    time.sleep(0.1)\n"
            "    with a_cv:\n"
            "        while n:\n"
            "            a_cv.wait(0.1)\n"
            "            n -= 1\n"
            "    with a_lock:\n"
            "        def later():\n"
            "            time.sleep(1)\n"
            "        return later, name\n",
    }, "PL013", []),
    "pl014_true_positive": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "a_lock = threading.Lock()\n"
            "def leak():\n"
            "    a_lock.acquire()\n"
            "    work = 1\n"
            "    a_lock.release()\n"
            "    return work\n",
    }, "PL014", ["PL014"]),
    "pl014_near_miss": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "a_lock = threading.Lock()\n"
            "def sibling():\n"
            "    a_lock.acquire()\n"
            "    try:\n"
            "        return 1\n"
            "    finally:\n"
            "        a_lock.release()\n"
            "def inside():\n"
            "    try:\n"
            "        a_lock.acquire()\n"
            "        return 1\n"
            "    finally:\n"
            "        a_lock.release()\n"
            "def managed():\n"
            "    with a_lock:\n"
            "        return 1\n"
            "def other(backend):\n"
            "    backend.acquire()\n",
    }, "PL014", []),
    "pl015_true_positive": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "cv = threading.Condition()\n"
            "def bad(ready):\n"
            "    with cv:\n"
            "        if not ready():\n"
            "            cv.wait()\n",
    }, "PL015", ["PL015"]),
    "pl015_near_miss": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "cv = threading.Condition()\n"
            "stop = threading.Event()\n"
            "def good(ready):\n"
            "    with cv:\n"
            "        while not ready():\n"
            "            cv.wait(0.1)\n"
            "def forever():\n"
            "    with cv:\n"
            "        while True:\n"
            "            cv.wait(0.1)\n"
            "def pred(ready):\n"
            "    with cv:\n"
            "        cv.wait_for(ready)\n"
            "def ev(proc):\n"
            "    stop.wait(1.0)\n"
            "    proc.wait()\n",
    }, "PL015", []),
    "pl016_true_positive": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "def orphan(fn):\n"
            "    t = threading.Thread(target=fn)\n"
            "    t.start()\n"
            "    return t\n",
    }, "PL016", ["PL016"]),
    "pl016_near_miss": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "def daemonized(fn):\n"
            "    t = threading.Thread(target=fn, daemon=True)\n"
            "    t.start()\n"
            "def timered(fn):\n"
            "    t = threading.Timer(0.5, fn)\n"
            "    t.daemon = True\n"
            "    t.start()\n"
            "def joined(fn, parts):\n"
            "    name = ','.join(parts)\n"
            "    t = threading.Thread(target=fn, name=name)\n"
            "    t.start()\n"
            "    t.join(timeout=5)\n",
    }, "PL016", []),
    "pl016_str_join_does_not_count": ({
        "pypulsar_tpu/mod.py":
            "import threading\n"
            "def sneaky(fn, parts):\n"
            "    t = threading.Thread(target=fn)\n"
            "    t.start()\n"
            "    return ','.join(parts)\n",
    }, "PL016", ["PL016"]),
    "pl017_consumer_name_nothing_emits": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.obs import telemetry\n"
            "def f():\n"
            "    telemetry.event('survey.slo_burn', frac=0.9)\n",
        "tests/test_x.py":
            "def test_x(tlm):\n"
            "    assert tlm.event_counts.get('survey.slo_burn')\n"
            "    assert tlm.event_counts.get('survey.slo_burm')\n",
    }, "PL017", ["PL017"]),
    "pl017_event_nobody_consumes": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.obs import telemetry\n"
            "def f():\n"
            "    telemetry.event('survey.orphan_verdict', n=1)\n",
        "tests/test_x.py": "def test_x():\n    pass\n",
    }, "PL017", ["PL017"]),
    "pl017_near_misses": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.obs import telemetry\n"
            "from pypulsar_tpu.resilience import faultinject\n"
            "def f(stage, reason):\n"
            "    telemetry.event('survey.quarantine', stage=stage)\n"
            "    telemetry.counter('survey.stages_run')\n"
            "    with telemetry.span(f'survey.stage.{stage}'):\n"
            "        faultinject.trip(f'survey.stage_start.{stage}')\n"
            "    name = 'survey.deadline_exceeded'\n"
            "    telemetry.event(name, after=1.0)\n"
            "    telemetry.event('mesh.device_strike', dev=0)\n",
        "tests/test_x.py":
            "from pypulsar_tpu.resilience import faultinject\n"
            "def test_x(tlm, tmp_path):\n"
            "    assert tlm.event_counts.get('survey.quarantine')\n"
            "    assert tlm.event_counts.get('survey.deadline_exceeded')\n"
            "    assert tlm.stages.get('survey.stage.sweep')\n"
            "    faultinject.configure('kill:survey.stage_start.sweep:1')\n"
            "    assert faultinject.hits('survey.stage_start.sweep')\n"
            "    assert (tmp_path / 'tune.json').exists()\n",
    }, "PL017", []),
    "pl017_summarize_and_bench_consume": ({
        "pypulsar_tpu/prod.py":
            "from pypulsar_tpu.obs import telemetry\n"
            "def f():\n"
            "    telemetry.event('survey.rendered', n=1)\n"
            "    telemetry.event('survey.benched', n=1)\n",
        "pypulsar_tpu/obs/summarize.py":
            "NAMES = ('survey.rendered', 'survey.never_emitted')\n",
        "bench.py":
            "WANT = 'survey.benched'\n",
    }, "PL017", ["PL017"]),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_kept_rules_find_what_the_jax_linter_finds(tmp_path, case):
    files, rule, want = PARITY[case]
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jpaths = _write(jroot, files)
    ppaths = _write(proot, {_to_port(k): v for k, v in files.items()})
    ref = jax_engine_run(jax_all_rules(), jpaths, str(jroot), select=rule)
    mine = engine_run(all_rules(), ppaths, str(proot), select=rule)
    assert codes(ref) == want
    assert [(f.rule, f.path, f.line, f.col) for f in mine.findings] == [
        (f.rule, _to_port(f.path), f.line, f.col) for f in ref.findings]


def test_pl017_consumer_finding_names_the_drifted_name(tmp_path):
    files, rule, _ = PARITY["pl017_consumer_name_nothing_emits"]
    rep = lint(tmp_path, {_to_port(k): v for k, v in files.items()},
               select=rule)
    assert "slo_burm" in rep.findings[0].message
    assert rep.findings[0].path == "tests/test_x.py"


def test_pl017_event_finding_sits_in_the_package(tmp_path):
    files, rule, _ = PARITY["pl017_event_nobody_consumes"]
    rep = lint(tmp_path, {_to_port(k): v for k, v in files.items()},
               select=rule)
    assert "orphan_verdict" in rep.findings[0].message
    assert rep.findings[0].path == "pypulsar_tpu_torch/prod.py"


# ---------------------------------------------------------------------------
# PL002: raw card enumeration or selection


def test_pl002_true_positive(tmp_path):
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/work.py":
            "import torch\n"
            "def cards():\n"
            "    n = torch.cuda.device_count()\n"
            "    torch.cuda.set_device(n - 1)\n"
            "    return torch.cuda.current_device()\n",
        "chip_smoke.py":
            "import torch\n"
            "print(torch.cuda.device_count())\n",
    }, select="PL002")
    assert codes(rep) == ["PL002"] * 4
    assert [(f.path, f.line) for f in rep.findings] == [
        ("chip_smoke.py", 2), ("pypulsar_tpu_torch/work.py", 3),
        ("pypulsar_tpu_torch/work.py", 4), ("pypulsar_tpu_torch/work.py", 5)]


def test_pl002_near_miss(tmp_path):
    # the registry's modules are exempt; resolving through them is the
    # sanctioned shape; tests are out of scope; availability probes and
    # the reference's jax.devices() are not card selection
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/parallel/mesh.py":
            "import torch\n"
            "def lease_devices():\n"
            "    return list(range(torch.cuda.device_count()))\n",
        "pypulsar_tpu_torch/core/device.py":
            "import torch\n"
            "def resolve_device():\n"
            "    return torch.cuda.current_device()\n",
        "pypulsar_tpu_torch/work.py":
            "import jax, torch\n"
            "from pypulsar_tpu_torch.parallel.mesh import lease_devices\n"
            "def cards():\n"
            "    assert torch.cuda.is_available()\n"
            "    return lease_devices(), jax.devices()\n",
        "tests/test_caps.py":
            "import torch\n"
            "def test_n():\n"
            "    assert torch.cuda.device_count() == 1\n",
    }, select="PL002")
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# PL004: the knob registry against its consults and defaults

_KNOBS = ("def _declare(name, stage, ktype, **kw):\n"
          "    pass\n"
          "def resolve(stage, name, explicit=None):\n"
          "    pass\n"
          "_declare('chunk', 'sweep', 'int',\n"
          "         const='pypulsar_tpu_torch.parallel.sweep:CHUNK')\n"
          "_declare('batch', 'accel', 'int',\n"
          "         const='pypulsar_tpu_torch.parallel.gone:BATCH')\n"
          "_declare('mode', 'sweep', 'str', value='auto')\n"
          "def fine():\n"
          "    return resolve('sweep', 'mode')\n")


def test_pl004_true_positive(tmp_path):
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/tune/knobs.py": _KNOBS,
        "pypulsar_tpu_torch/parallel/sweep.py": "CHUNK = 1 << 18\n",
        "pypulsar_tpu_torch/parallel/stage.py":
            "from pypulsar_tpu_torch.tune import knobs\n"
            "def f():\n"
            "    return (knobs.resolve('sweep', 'chunk'),\n"
            "            knobs.knob('sweep', 'chunkk'),\n"
            "            knobs.resolve('fold', 'chunk', 3))\n",
    }, select="PL004")
    assert codes(rep) == ["PL004"] * 3
    got = [(f.path, f.line) for f in rep.findings]
    assert got == [("pypulsar_tpu_torch/parallel/stage.py", 4),
                   ("pypulsar_tpu_torch/parallel/stage.py", 5),
                   ("pypulsar_tpu_torch/tune/knobs.py", 7)]
    assert "gone:BATCH" in rep.findings[2].message


def test_pl004_near_miss(tmp_path):
    # declared consults (in and out of the registry), constants bound as
    # functions, classes or tuple targets, consults whose names are not
    # literals, and a registry elsewhere than tune/knobs.py are silent
    knobs = _KNOBS.replace("parallel.gone:BATCH", "parallel.accel:Batch")
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/tune/knobs.py": knobs,
        "pypulsar_tpu_torch/parallel/sweep.py": "CHUNK, X = 1 << 18, 0\n",
        "pypulsar_tpu_torch/parallel/accel.py": "class Batch:\n    pass\n",
        "pypulsar_tpu_torch/parallel/stage.py":
            "from pypulsar_tpu_torch.tune import knobs\n"
            "def f(stage, name):\n"
            "    return (knobs.resolve('accel', 'batch'),\n"
            "            knobs.resolve(stage, name), resolve('x', 'y'))\n",
        "pypulsar_tpu_torch/other/knobs.py": _KNOBS,
    }, select="PL004")
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# PL005: the port's keyword forms of a fault point


def test_pl005_keyword_and_halving_forms_define_points(tmp_path):
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/prod.py":
            "def build(eng, Engine, GroupHalving, run):\n"
            "    a = Engine(eng, point='sweep.chunk_dispatch')\n"
            "    b = run(eng, dispatch_point='specfuse.chunk_dispatch')\n"
            "    c = GroupHalving(eng, 'fold.group_dispatch', 'fold')\n"
            "    d = run(eng, name='ghost.named')\n"
            "    return a, b, c, d\n",
        "tests/test_faults.py":
            "from pypulsar_tpu_torch.resilience import faultinject\n"
            "def test_points():\n"
            "    faultinject.configure(\n"
            "        'oom:sweep.chunk_dispatch:2, '\n"
            "        'oom:specfuse.chunk_dispatch:1, '\n"
            "        'oom:fold.group_dispatch:1')\n"
            "    assert faultinject.hits('ghost.named') == 0\n",
    }, select="PL005")
    # only the point handed over as a plain name= keyword is dead
    assert codes(rep) == ["PL005"]
    assert "ghost.named" in rep.findings[0].message
    assert rep.findings[0].line == 7


def test_pl005_without_the_keyword_forms_the_ports_faults_are_dead(
        monkeypatch):
    """The repo's case: ``sweep.chunk_dispatch`` is defined through
    ``point=`` and ``GroupHalving``'s argument alone. Taught neither form,
    PL005 fires at the fault tests that arm it; taught them, the port is
    clean (no suppression needed)."""
    assert run_psrlint(cli.default_scope(REPO_ROOT), REPO_ROOT,
                       select="PL005").findings == []
    monkeypatch.setattr(rules, "_POINT_KEYWORDS", ())
    monkeypatch.setattr(rules, "_POINT_CTORS", ())
    found = run_psrlint(cli.default_scope(REPO_ROOT), REPO_ROOT,
                        select="PL005").findings
    assert found, "the keyword forms are the only definition"
    assert {f.path for f in found} == {"tests/test_torch_faultinject.py"}
    assert all("sweep.chunk_dispatch" in f.message for f in found)


# ---------------------------------------------------------------------------
# PL011: an environment read in the package


def test_pl011_true_positive(tmp_path):
    rep = lint(tmp_path, {"pypulsar_tpu_torch/mod.py":
                          "import os\n"
                          "from os import environ\n"
                          "a = os.environ.get('PYPULSAR_TPU_CHUNK')\n"
                          "b = os.getenv('HOME', '/')\n"
                          "c = os.environ['JAX_PLATFORMS']\n"
                          "d = dict(os.environ)\n"
                          "def arm():\n"
                          "    os.environ['X'] = '1'\n"},
               select="PL011")
    assert codes(rep) == ["PL011"] * 6
    assert [f.line for f in rep.findings] == [2, 3, 4, 5, 6, 8]


def test_pl011_near_miss(tmp_path):
    # tests and the card driver may arm children's environments; prose
    # naming the variable is no read; a suppressed read of another
    # program's variable is the sanctioned exception
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/mod.py":
            "import os\n"
            "HELP = 'reads no os.environ'\n"
            "def poln():\n"
            "    return os.getenv('PSRFITS_POLN')  "
            "# psrlint: ignore[PL011] -- a format's variable\n",
        "tests/test_env.py":
            "import os\n"
            "def test_env():\n"
            "    os.environ['PYPULSAR_TPU_CHUNK'] = '5'\n"
            "    assert os.environ.get('PYPULSAR_TPU_CHUNK') == '5'\n",
        "chip_smoke.py":
            "import os\n"
            "ENV = dict(os.environ, PYTHONPATH='.')\n",
    }, select="PL011")
    assert codes(rep) == []


def test_pl011_agrees_with_the_isolation_test():
    """The package reads no environment, as
    ``tests/test_torch_isolation.py`` holds over its text: the one
    ``os.getenv`` (PRESTO's ``PSRFITS_POLN``) carries its suppression,
    and without suppressions PL011 names that line alone."""
    pkg = ["pypulsar_tpu_torch"]
    assert run_psrlint(pkg, REPO_ROOT, select="PL011").findings == []
    from pypulsar_tpu_torch.analysis.engine import FileContext

    orig = FileContext.__init__

    def unsuppressed(self, *a, **kw):
        orig(self, *a, **kw)
        self.suppressions = {}

    try:
        FileContext.__init__ = unsuppressed
        found = engine_run([rules.EnvReadRule()], pkg, REPO_ROOT).findings
    finally:
        FileContext.__init__ = orig
    assert [(f.path, f.rule) for f in found] == [
        ("pypulsar_tpu_torch/io/psrfits.py", "PL011")]
    with open(os.path.join(REPO_ROOT, found[0].path)) as f:
        lines = f.read().splitlines()
    assert "PSRFITS_POLN" in " ".join(lines[found[0].line - 1:
                                            found[0].line + 1])


# ---------------------------------------------------------------------------
# PL013: waits on the card under a lock


def test_pl013_card_waits_under_a_lock(tmp_path):
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/mod.py":
            "import threading, torch\n"
            "a_lock = threading.Lock()\n"
            "def pull(x, ev, stream):\n"
            "    with a_lock:\n"
            "        v = x.sum().item()\n"
            "        h = x.cpu()\n"
            "        rows = x.tolist()\n"
            "        arr = h.numpy()\n"
            "        torch.cuda.synchronize()\n"
            "        ev.synchronize()\n"
            "        stream.synchronize()\n"
            "    return v, rows, arr\n",
    }, select="PL013")
    assert codes(rep) == ["PL013"] * 7
    assert [f.line for f in rep.findings] == list(range(5, 12))


def test_pl013_card_waits_near_miss(tmp_path):
    # the same calls outside the critical section, a queued copy that
    # does not wait, the reference's jax calls (no counterpart) and the
    # card driver's waits outside locks are silent
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/mod.py":
            "import threading, torch, jax\n"
            "a_lock = threading.Lock()\n"
            "def pull(x, ev):\n"
            "    with a_lock:\n"
            "        y = x.to('cpu', non_blocking=True)\n"
            "        z = jax.device_put(x).block_until_ready\n"
            "        w = x.numpy(force=True)\n"
            "    ev.synchronize()\n"
            "    return y.item(), z, w, x.cpu().numpy()\n",
        "chip_smoke.py":
            "import torch\n"
            "torch.cuda.synchronize()\n",
    }, select="PL013")
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# PL018: kernel libraries past ops/_build.load


def test_pl018_true_positives(tmp_path):
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/ops/extra.py":
            "import ctypes, torch\n"
            "from torch.utils import cpp_extension\n"
            "lib = ctypes.CDLL('libx.so')\n"
            "lib2 = ctypes.cdll.LoadLibrary('liby.so')\n"
            "f = torch.compile(lambda x: x)\n"
            "g = torch.jit.script(lambda x: x)\n"
            "h = torch.jit.trace(lambda x: x, (1,))\n"
            "m = cpp_extension.load(name='m', sources=['m.cu'])\n"
            "n = torch.utils.cpp_extension.load_inline('n', '')\n",
        "chip_smoke.py":
            "import ctypes\n"
            "lib = ctypes.CDLL('libz.so')\n",
    }, select="PL018")
    assert codes(rep) == ["PL018"] * 8
    assert [(f.path, f.line) for f in rep.findings] == [
        ("chip_smoke.py", 2)] + [
        ("pypulsar_tpu_torch/ops/extra.py", ln) for ln in range(3, 10)]


def test_pl018_near_misses(tmp_path):
    # the loader itself, tests, the card driver's compiled references
    # (not the package), jax.jit (no counterpart), other .compile
    # attributes and prose are silent
    assert rules.KERNEL_LOADERS == ("pypulsar_tpu_torch/ops/_build.py",)
    rep = lint(tmp_path, {
        "pypulsar_tpu_torch/ops/_build.py":
            "import ctypes\n"
            "def load(path):\n"
            "    return ctypes.CDLL(path)\n",
        "pypulsar_tpu_torch/mod.py":
            "import re, jax\n"
            "HELP = 'never torch.compile'\n"
            "pat = re.compile('x')\n"
            "f = jax.jit(lambda x: x)\n",
        "tests/test_load.py":
            "import ctypes, torch\n"
            "def test_f(monkeypatch):\n"
            "    ctypes.CDLL('libc.so.6')\n"
            "    torch.compile(lambda x: x)\n",
        "chip_smoke.py":
            "import torch\n"
            "ref = torch.compile(lambda x: x)\n",
    }, select="PL018")
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# suppressions / select / ignore / baseline / output


def test_suppression_silences_and_unused_is_flagged(tmp_path):
    rep = lint(tmp_path, {"pypulsar_tpu_torch/mod.py":
                          "def f(acc=[]):  # psrlint: ignore[PL007] -- fixture\n"
                          "    return acc\n"
                          "def g():  # psrlint: ignore[PL007] -- stale\n"
                          "    return 1\n"})
    assert codes(rep) == ["PL010"]
    assert rep.findings[0].line == 3


def test_suppression_comma_list(tmp_path):
    rep = lint(tmp_path, {"pypulsar_tpu_torch/mod.py":
                          "def f(a, n, acc=[]):  # psrlint: ignore[PL007, PL001]\n"
                          "    return a[n / 2], acc\n"})
    # the PL001 is on line 2, not the suppressed line 1: that half of
    # the comma list is an unused suppression
    assert sorted(codes(rep)) == ["PL001", "PL010"]


def test_select_and_ignore(tmp_path):
    files = {"pypulsar_tpu_torch/mod.py":
             "import torch\n"
             "def f(a, n, acc=[]):\n"
             "    return a[n / 2], acc, torch.cuda.device_count()\n"}
    assert sorted(codes(lint(tmp_path, dict(files)))) == [
        "PL001", "PL002", "PL007"]
    assert sorted(codes(lint(tmp_path, dict(files),
                             select="PL001,PL007"))) == ["PL001", "PL007"]
    assert sorted(codes(lint(tmp_path, dict(files),
                             ignore="PL002"))) == ["PL001", "PL007"]


def test_baseline_drops_known_findings(tmp_path):
    files = {"pypulsar_tpu_torch/mod.py": "def f(acc=[]):\n    return acc\n"}
    dirty = lint(tmp_path, dict(files), select="PL007")
    assert codes(dirty) == ["PL007"]
    base = {"PL007": [{"path": "pypulsar_tpu_torch/mod.py", "line": 1}]}
    assert codes(lint(tmp_path, dict(files), select="PL007",
                      baseline=base)) == []


def test_cli_unwraps_nested_baseline(tmp_path):
    pkg = tmp_path / "pypulsar_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text("def f(acc=[]):\n    return acc\n")
    basefn = tmp_path / "base.json"
    basefn.write_text(json.dumps({
        "psrlint": {"PL007": [{"path": "pypulsar_tpu_torch/mod.py",
                               "line": 1}]},
        "ruff": []}))
    assert cli.main(["--root", str(tmp_path), "pypulsar_tpu_torch",
                     "--select", "PL007"]) == 1
    assert cli.main(["--root", str(tmp_path), "pypulsar_tpu_torch",
                     "--select", "PL007",
                     "--baseline", str(basefn)]) == 0
    (tmp_path / "bad.json").write_text("{")
    assert cli.main(["--root", str(tmp_path), "--baseline",
                     str(tmp_path / "bad.json")]) == 2


def test_parse_error_is_a_finding_not_a_crash(tmp_path):
    rep = lint(tmp_path, {"pypulsar_tpu_torch/bad.py": "def f(:\n    pass\n"})
    assert codes(rep) == ["PL100"]
    rep = lint(tmp_path, {"pypulsar_tpu_torch/dedent.py":
                          "def f():\n    x = 1\n   y = 2\n"})
    assert codes(rep) == ["PL100", "PL100"]
    assert {f.path for f in rep.findings} == {
        "pypulsar_tpu_torch/bad.py", "pypulsar_tpu_torch/dedent.py"}


def test_cli_missing_path_is_loud(tmp_path):
    """A mistyped path exits 2, never 'clean: 0 file(s)' and exit 0."""
    (tmp_path / "pypulsar_tpu_torch").mkdir()
    assert cli.main(["--root", str(tmp_path), "no_such_file.py"]) == 2
    (tmp_path / "empty").mkdir()
    assert cli.main(["--root", str(tmp_path), "empty"]) == 2


def test_report_json_schema(tmp_path, capsys):
    rep = lint(tmp_path, {"pypulsar_tpu_torch/mod.py":
                          "def f(acc=[]):\n    return acc\n"}, select="PL007")
    doc = json.loads(rep.to_json())
    assert doc["files"] == 1 and doc["counts"] == {"PL007": 1}
    (finding,) = doc["findings"]
    assert set(finding) == {"rule", "path", "line", "col", "message"}
    assert finding["rule"] == "PL007" and finding["line"] == 1
    assert cli.main(["--root", str(tmp_path), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"] == {"PL007": 1}


def test_rule_catalog_complete(capsys):
    got = {r.code for r in all_rules()}
    assert got == ({f"PL00{i}" for i in range(1, 10)}
                   | {f"PL01{i}" for i in range(1, 9)})
    assert got == {r.code for r in jax_all_rules()}
    assert all(r.summary and r.name for r in all_rules())
    assert cli.main(["--list-rules"]) == 0
    listing = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in listing] == sorted(got)


def test_default_scope_is_the_port():
    scope = cli.default_scope(REPO_ROOT)
    assert scope[0] == "pypulsar_tpu_torch" and "chip_smoke.py" in scope
    assert "tests/torch_hermetic.py" in scope
    tests = [p for p in scope if p.startswith("tests/")]
    assert "tests/test_torch_psrlint.py" in tests
    assert all(os.path.basename(p).startswith(("test_torch_", "torch_"))
               for p in tests)


# ---------------------------------------------------------------------------
# the repo-wide gate


def test_repo_is_clean_smoke(capsys):
    """``psrlint --json`` exits 0 over the port's default scope, with
    every suppression in use (PL010 runs)."""
    assert cli.main(["--root", REPO_ROOT, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["files"] > 100
    assert len(doc["rules"]) == 17


def test_single_file_scan_keeps_project_context():
    """Linting one file does not report the unscanned rest of the tree
    as drift or dead points: the CLI hands cross-file rules the whole
    default scope and clips their findings to the request."""
    for target in ("pypulsar_tpu_torch/io/sigproc.py",
                   "tests/test_torch_faultinject.py",
                   "pypulsar_tpu_torch/tune/knobs.py"):
        assert cli.main(["--root", REPO_ROOT, target]) == 0


def test_cli_registered():
    from pypulsar_tpu_torch.cli import __main__ as dispatch

    assert "psrlint" in dispatch.TOOLS
    assert not hasattr(dispatch, "NOT_PORTED")


# ---------------------------------------------------------------------------
# the event PL017 found nobody asserting


def test_claim_terminal_is_an_event_as_in_the_reference(tmp_path):
    """``FleetPlane.mark_terminal`` emits ``survey.claim_terminal`` once,
    with the host, the observation and the state, as the JAX package's
    plane does, and the claim record carries the same state."""
    from pypulsar_tpu.obs import telemetry as jax_telemetry
    from pypulsar_tpu.survey import fleet as jax_fleet
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.survey.fleet import FleetPlane

    got = {}
    for name, plane_cls, tlm_mod in (
            ("port", FleetPlane, telemetry),
            ("jax", jax_fleet.FleetPlane, jax_telemetry)):
        out = tmp_path / name
        plane = plane_cls(str(out), host_id="hA", lease_s=60.0,
                          settle_s=0.0)
        plane.register()
        try:
            token = plane.claim("o0")
            assert token is not None
            with tlm_mod.session() as tlm:
                plane.mark_terminal("o0", token, state="quarantined",
                                    trace_id="t1")
                counts = dict(tlm.event_counts)
        finally:
            plane.close()
        claim = plane.read_claim("o0")
        got[name] = (counts.get("survey.claim_terminal"), claim["state"],
                     claim["host"], claim["trace_id"])
    assert got["port"] == got["jax"] == (1, "quarantined", "hA", "t1")

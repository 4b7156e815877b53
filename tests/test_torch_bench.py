"""The port's bench (``dctsvd_tpu_torch/bench.py``) against the root
``bench.py`` on the CPU (``--device cpu``).

- The output contract: for every config, both ``main``s with their bench
  functions replaced by stubs that return the same fixed values print the
  same JSON line and call their bench function with the same sizes
  (``bench.py``'s ``_require_backend`` is a no-op here). ``mesh``'s metric
  names shards of cards where ``bench.py``'s names a virtual CPU mesh, and
  its branch reconfigures JAX's platform (made a no-op here): for it the
  keys, unit, value, vs_baseline and curve are compared.
- ``_inputs``, ``_roc_host`` and ``_natural_host`` byte-equal to
  ``bench.py``'s.
- Small runs of the bench functions; the robustness and ROC tables held
  against ``bench.py``'s own functions at 128x128 with the JAX package on
  its fused branch (the Pallas kernels in interpret mode at the s1.25
  schedule, the path its TPU runs; tests/test_torch_parallel.py), with
  the same keys and counts; the budget's keys against the dict literal of
  ``bench.py``'s ``bench_budget``.
- No CPU fallback: without a card the default ``--device cuda`` exits 3.

Tolerances, stated beforehand: every detect score (and score statistic)
within SCORE_TOL; extraction NC and SSIM within NC_TOL; a rate over n
scores within RATE_SLACK / n (two scores on the other side of its
threshold). The two packages agree on the embed within 1 quantum on at
most 1 % of the bytes (tests/test_torch_serve.py), and a quantum moves a
JPEG round trip's output and the enhancement chain's.
"""

import ast
import functools
import importlib.util
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax

from dctsvd_tpu.models import blocked as jb
from dctsvd_tpu.ops import wm_pallas
from dctsvd_tpu_torch import bench as tbench

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCORE_TOL = 5e-3
NC_TOL = 1e-2
RATE_SLACK = 2
SMALL = 128          # robustness / ROC side: 16 blocks a detect band


def _load_root_bench():
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load_root_bench()


class _Interpreted:
    """A jitted Pallas entry point whose ``__wrapped__`` body runs the
    kernel in interpret mode (the JAX package's fused branch calls the
    bodies through ``__wrapped__``)."""

    def __init__(self, fn):
        self.__wrapped__ = functools.partial(fn.__wrapped__, interpret=True)


@pytest.fixture(autouse=True, scope="module")
def _jax_fused_branch():
    """The JAX package on its fused branch for this module, its compiled
    executables dropped before and after so no other module sees them,
    and its interpret-mode Pallas executables kept out of the persistent
    compile cache (see tests/test_torch_serve.py)."""
    from jax._src import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "_USE_FUSED_MEMO", [True])
        for name in ("spectrum_plane_blocks", "embed_plane_blocks",
                     "roundtrip_frames_blocks"):
            mp.setattr(wm_pallas, name,
                       _Interpreted(getattr(wm_pallas, name)))
        yield
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


# ---------------------------------------------------------------------------
# (a) the output contract
# ---------------------------------------------------------------------------

FIXED = {
    "bench_embed_extract": 1234.5678,
    "bench_detect": 23456.789,
    "bench_full_path": 3.14159,
    "bench_8k_plane": 61.23456,
    "bench_detect_roc": {"n_clean_hosts": 384, "separation_margin": 0.1234,
                         "pos": {"min": 0.45678}},
    "bench_mesh_scaling": (1000.0, 800.0, {1: 1000.0, 2: 950.0, 4: 900.0,
                                           8: 800.0}),
    "bench_video": (45.678, 123.456, 678.901),
    "bench_budget": (2345.678, {"tier": 1.25, "batch": 128,
                                "ms": {"full": 54.57}}),
    "bench_geometric": (0.87654, {"alpha=0.10": {}}),
    "bench_robustness": (0.65432, {"alpha=0.10": {}}),
}


def _stub_benches(monkeypatch, mod, calls):
    """Replace ``mod``'s bench functions by stubs returning FIXED; each
    call is recorded without the port's device/profile keywords."""
    for name, value in FIXED.items():
        def stub(*args, _name=name, _value=value, **kw):
            kw.pop("device", None)
            kw.pop("profile", None)
            calls.append((_name, args, kw))
            return _value
        monkeypatch.setattr(mod, name, stub)


def _one_line(out: str) -> str:
    lines = out.strip().splitlines()
    assert len(lines) == 1, lines
    return lines[0]


@pytest.mark.parametrize("config", tbench.CONFIGS)
def test_main_prints_bench_py_line(config, monkeypatch, capsys):
    """Same stub values in, the same JSON line out, the same sizes asked
    of the bench function."""
    jcalls, tcalls = [], []
    _stub_benches(monkeypatch, jbench, jcalls)
    _stub_benches(monkeypatch, tbench, tcalls)
    monkeypatch.setattr(jbench, "_require_backend", lambda *a, **k: None)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--config", config])
    jbench.main()
    want = _one_line(capsys.readouterr().out)
    assert tbench.main(["--config", config, "--device", "cpu"]) == 0
    got = _one_line(capsys.readouterr().out)
    assert tcalls == jcalls
    if config != "mesh":
        assert got == want
        return
    got, want = json.loads(got), json.loads(want)
    assert list(got) == list(want)
    for key in ("unit", "value", "vs_baseline", "overhead_curve"):
        assert got[key] == want[key], key
    assert "8 shards of 1 card(s)" in got["metric"]


# ---------------------------------------------------------------------------
# (b), (c) seeded inputs and host generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 512, 512), (1, 1080, 1920)],
                         ids=["gray_512", "color_1080p"])
def test_inputs_equal_bench_py(shape):
    want = [np.asarray(a) for a in jbench._inputs(*shape)]
    got = [t.numpy() for t in tbench._inputs(*shape, device="cpu")]
    for name, g, w in zip(("frames", "wm", "blk", "intra"), got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert got[0].dtype == got[1].dtype == np.uint8


@pytest.mark.parametrize("i", range(8))
@pytest.mark.parametrize("family", ["_roc_host", "_natural_host"])
def test_host_generators_equal_bench_py(family, i):
    want = getattr(jbench, family)(i, 72, 96)
    got = getattr(tbench, family)(i, 72, 96)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (72, 96, 3)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# (d) small runs
# ---------------------------------------------------------------------------

def _finite_positive(x) -> bool:
    return math.isfinite(x) and x > 0


@pytest.mark.parametrize("color", [True, False], ids=["color", "gray"])
def test_embed_extract_small(color):
    assert _finite_positive(tbench.bench_embed_extract(
        64, 64, 2, 1, color=color, device="cpu"))


def test_detect_small_with_profile(tmp_path, capsys):
    """--profile on the CPU: a trace is written and the log says the
    trace holds no device time (no CPU time stands in for it)."""
    assert _finite_positive(tbench.bench_detect(64, 64, 2, 1, device="cpu",
                                                profile=str(tmp_path)))
    assert list(tmp_path.glob("trace_*.json"))
    assert "profile: no device time" in capsys.readouterr().err


def _literal_keys(node):
    """The key tree of a dict literal: {key: subtree or None}."""
    return {k.value: (_literal_keys(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}


def _value_keys(d):
    return {k: (_value_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def test_budget_small_keys_equal_bench_py():
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_budget")
    literal = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "budget")
    fps, budget = tbench.bench_budget(64, 64, 2, 1, device="cpu")
    assert _finite_positive(fps)
    assert _value_keys(budget) == _literal_keys(literal)
    assert budget["batch"] == 2 and budget["tier"] == 1.25
    assert all(math.isfinite(v) for v in budget["ms"].values())


def test_robustness_small_equals_bench_py():
    jworst, jtable = jbench.bench_robustness(SMALL, SMALL, alphas=(0.13,))
    tworst, ttable = tbench.bench_robustness(SMALL, SMALL, alphas=(0.13,),
                                             device="cpu")
    assert _value_keys(ttable) == _value_keys(jtable)
    assert abs(tworst - jworst) <= SCORE_TOL
    for a, jrow in jtable.items():
        trow = ttable[a]
        assert abs(trow["clean_host_detect"]
                   - jrow["clean_host_detect"]) <= SCORE_TOL
        for attack, jcell in jrow.items():
            if attack == "clean_host_detect":
                continue
            tcell = trow[attack]
            assert abs(tcell["detect"] - jcell["detect"]) <= SCORE_TOL, (
                a, attack)
            for m in ("nc", "ssim"):
                assert abs(tcell[m] - jcell[m]) <= NC_TOL, (a, attack, m)
    # the table is not degenerate at this size: the mark survives JPEG
    assert jtable["alpha=0.13"]["jpeg_q50"]["detect"] > 0.5


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_detect_roc_small_equals_bench_py():
    kw = dict(n_hosts=12, n_natural=12, alphas=(0.14,))
    want = _flatten(jbench.bench_detect_roc(SMALL, SMALL, **kw))
    got = _flatten(tbench.bench_detect_roc(SMALL, SMALL, device="cpu", **kw))
    assert list(got) == list(want)
    counts = ("n_clean_hosts", "n_neg_scores", "n_pos_scores",
              "natural.n_hosts", "natural.n_neg_scores")
    for key in counts:
        assert got[key] == want[key], key
    # the scores each rate is taken over (4 positives a natural host)
    over = {"fpr_at_0.6": want["n_neg_scores"],
            "tpr_at_0.6": want["n_pos_scores"],
            "fpr_at_0.30": want["n_neg_scores"],
            "tpr_at_0.30": want["n_pos_scores"],
            "natural.fpr_at_0.30": want["natural.n_neg_scores"],
            "natural.tpr_at_0.30": 4 * want["natural.n_hosts"]}
    for key, w in want.items():
        if key in counts:
            continue
        tol = RATE_SLACK / over[key] if key in over else SCORE_TOL
        assert abs(got[key] - w) <= tol, key
    assert want["pos.mean"] > 0.5


def test_main_runs_on_the_cpu_when_asked(capsys):
    """``--device cpu`` at a small --batch: one JSON line with
    bench.py's keys and a finite value."""
    assert tbench.main(["--config", "512gray", "--batch", "1", "--iters",
                        "1", "--device", "cpu"]) == 0
    line = json.loads(_one_line(capsys.readouterr().out))
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["unit"] == "frames/sec/chip"
    assert _finite_positive(line["value"])


# ---------------------------------------------------------------------------
# (e) no CPU fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["1080p", "mesh"])
def test_no_card_exits_3(config, monkeypatch, capsys):
    """Without a card the default --device cuda exits 3 before any work,
    with the reason on stderr and nothing on stdout (mesh too, which
    bench.py runs on virtual CPU devices)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    _stub_benches(monkeypatch, tbench, called)
    with pytest.raises(SystemExit) as exc:
        tbench.main(["--config", config])
    assert exc.value.code == 3
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not called

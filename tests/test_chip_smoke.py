"""CPU tests of what the GPU smoke run and the GPU bring-up rest on:
chip_smoke's helpers and its reference comparison, the compile-cache
placement, the backend-keyed dtype choice, and the per-process card
binding of --distributed launches."""

import json
import os
import types

import numpy as np
import pytest
import jax

import chip_smoke


def test_ok_line_is_the_contract_line():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.ok_line(dev)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line) == {"ok": True, "device": dev}


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_require_gpu_reports_the_device():
    gpu = types.SimpleNamespace(platform="gpu", device_kind="H100")
    assert chip_smoke.require_gpu([gpu] * 4) == {
        "platform": "gpu", "kind": "H100", "count": 4,
    }


def _run(**scale):
    u = np.linspace(1.0, 2.0, 50)
    p = np.linspace(-1.0, 3.0, 20)
    run = {"u": u, "p": p, "c_D": 5.58, "c_L": 0.0106, "dp": 0.1175}
    return {k: v * scale.get(k, 1.0) for k, v in run.items()}


def test_compare_accepts_inside_bounds():
    bounds = {"u": 1e-3, "p": 1e-3, "c_D": 5e-3, "c_L": 5e-3, "dp": 5e-3}
    got = _run(u=1 + 9e-4, p=1 - 9e-4, c_D=1 + 4.9e-3, dp=1 + 4.9e-3)
    diffs, fails = chip_smoke.compare(got, _run(), bounds)
    assert fails == []
    assert diffs["u_rel_l2"] == pytest.approx(9e-4)
    assert diffs["p_rel_l2"] == pytest.approx(9e-4)
    assert diffs["c_D_rel"] == pytest.approx(4.9e-3)
    assert diffs["dp_rel"] == pytest.approx(4.9e-3)


def test_compare_scales_lift_by_the_force():
    """A lift near zero differs by a large share of itself while the
    force it belongs to has barely moved: c_L is bounded against
    |(c_D, c_L)|."""
    bounds = {"u": 1e-3, "c_D": 1e-3, "c_L": 1e-3, "dp": 1e-3}
    diffs, fails = chip_smoke.compare(_run(c_L=1.1), _run(), bounds)
    assert fails == []
    assert diffs["c_L_rel"] == pytest.approx(
        0.1 * 0.0106 / np.hypot(5.58, 0.0106))
    diffs, fails = chip_smoke.compare(_run(c_L=1.6), _run(), bounds)
    assert fails == [f"c_L_rel {diffs['c_L_rel']:.3e} > 0.001"]


@pytest.mark.parametrize("field", ["u", "p", "c_D", "c_L", "dp"])
def test_compare_rejects_outside_bounds(field):
    bounds = {"u": 1e-6, "p": 1e-6, "c_D": 1e-6, "c_L": 1e-6, "dp": 1e-6}
    bounds[field] = 1e-8
    ref = _run()
    got = {k: v * (1 + 1e-7) for k, v in ref.items()}
    got["c_L"] = ref["c_L"] + 1e-7 * np.hypot(ref["c_D"], ref["c_L"])
    diffs, fails = chip_smoke.compare(got, ref, bounds)
    assert len(fails) == 1 and fails[0].startswith(field)
    key = f"{field}_rel_l2" if field in ("u", "p") else f"{field}_rel"
    assert diffs[key] == pytest.approx(1e-7)


def test_compare_without_pressure_bound_skips_pressure():
    bounds = {"u": 1e-3, "c_D": 5e-3, "c_L": 5e-3, "dp": 5e-3}
    diffs, fails = chip_smoke.compare(_run(p=2.0), _run(), bounds)
    assert fails == [] and "p_rel_l2" not in diffs


# A tiny DFG 2D-1 mesh (672 DOF): the comparison's machinery end to end
# in seconds. At this size the drag is ~3% of its converged value, so
# its relative difference is amplified ~30-fold against the smoke's
# 9,861-DOF case; the other bounds are the smoke's own.
TINY_RES_SCALE = 4.0
TINY_F32_BOUNDS = {**chip_smoke.F32_BOUNDS, "c_D": 1e-2}


@pytest.fixture(scope="module")
def f32_vs_f64_on_cpu():
    """The smoke's float32-against-float64 comparison, run end to end on
    the CPU on a tiny mesh."""
    return chip_smoke.reference_comparison(
        TINY_RES_SCALE, chip_smoke.REF_STEPS, jax.devices("cpu")[0],
        {"cpu_f32": (np.float32, TINY_F32_BOUNDS)},
    )


def test_reference_comparison_f32_within_bounds(f32_vs_f64_on_cpu):
    (rec,) = f32_vs_f64_on_cpu
    assert rec["fails"] == []
    assert rec["phase"] == "compare_cpu_f32"
    assert rec["steps"] == chip_smoke.REF_STEPS
    assert rec["ref_device"] == str(jax.devices("cpu")[0])
    assert rec["ndofs"] < 1000
    # float32 differs from float64 by rounding, never by nothing
    assert 0 < rec["u_rel_l2"] <= chip_smoke.F32_BOUNDS["u"]


def test_reference_comparison_records_converged_steps(f32_vs_f64_on_cpu):
    (rec,) = f32_vs_f64_on_cpu
    for key in ("newton", "ksp", "newton_ref", "ksp_ref"):
        assert len(rec[key]) == chip_smoke.REF_STEPS
    assert max(rec["newton"] + rec["newton_ref"]) < chip_smoke.SNES_MAX_IT
    assert max(rec["ksp_max"]) < chip_smoke.KSP_MAX_IT


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_left_to_the_caller(monkeypatch, restore_cache_dir,
                                          tmp_path):
    from cfdtpu.utils.compile_cache import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_repo(monkeypatch, restore_cache_dir):
    from cfdtpu.utils.compile_cache import use_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    first = use_compile_cache()
    assert first == os.path.join(repo, ".jax_cache")
    assert use_compile_cache() == first
    assert jax.config.jax_compilation_cache_dir == first


@pytest.mark.parametrize("backend,expected", [
    ("gpu", np.float32), ("cpu", np.float64),
])
def test_resolve_dtype_auto_by_backend(monkeypatch, backend, expected):
    from cfdtpu.utils import resolve_dtype

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert resolve_dtype("auto") == np.dtype(expected)
    assert resolve_dtype(None) == np.dtype(expected)
    assert resolve_dtype("float64") == np.dtype(np.float64)


@pytest.mark.parametrize("args,env,expected", [
    (("localhost:1234", 4, 2), {},
     {"coordinator_address": "localhost:1234", "num_processes": 4,
      "process_id": 2, "local_device_ids": [2]}),
    # a launcher's local rank wins over the global process id
    (("host0:1234", 8, 5), {"LOCAL_RANK": "1"},
     {"coordinator_address": "host0:1234", "num_processes": 8,
      "process_id": 5, "local_device_ids": [1]}),
    (("host0:1234", 8, 6), {"SLURM_LOCALID": "2"},
     {"coordinator_address": "host0:1234", "num_processes": 8,
      "process_id": 6, "local_device_ids": [2]}),
    ((None, None, None), {"LOCAL_RANK": "3"}, {}),
])
def test_init_distributed_binds_one_local_card(monkeypatch, args, env,
                                               expected):
    from cfdtpu.dist import process

    for var in process.LOCAL_RANK_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    process.init_distributed(*args)
    assert seen == expected


def _trace_idle():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "trace_idle.py")
    spec = importlib.util.spec_from_file_location("trace_idle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("intervals,busy", [
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),            # overlap counts once
    ([(20, 30), (0, 10)], 20),           # order does not matter
    ([(0, 10), (2, 3), (10, 12)], 12),   # nested and touching
])
def test_trace_idle_union(intervals, busy):
    assert _trace_idle().union_ns(intervals) == busy


def test_trace_idle_share_over_the_kernel_window():
    rec = _trace_idle().idle_share([(100, 150), (175, 200)])
    assert rec["window_ns"] == 100 and rec["busy_ns"] == 75
    assert rec["idle_share"] == pytest.approx(0.25)
    assert rec["events"] == 2

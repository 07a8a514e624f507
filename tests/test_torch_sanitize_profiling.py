"""The port's stage sanitizer and stage profiler against mad_tpu's: the six
cases of tests/test_sanitize_unit.py on torch tensors, a NaN voxel
localized to the stage mad_tpu names first, and
tests/test_functional_api.py's ``test_profiling_stage_accumulates``
(with ``timing.stage`` on the same clock and ``device_trace``'s file).

On the 16^3 map below both packages name the gradient field of the
upsampled octave first. mad_tpu also names ``detect[o1]``: its
fixed-capacity anchor table (4,096 slots) localizes padding slots (value
-inf, not valid) whose seeds sit in the NaN region, where the port's table
holds only the peaks found (none on that octave). The 48^3 map of
tests/test_misc_components.py:197-223, where both name the same stages in
the same order, is in tests/test_torch_regimes_slow.py.
"""

import re

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.core.grid import DensityGrid
from mad_tpu_torch.engine.pipeline import describe_grid
from mad_tpu_torch.utils import profiling, sanitize

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def stage_mode(monkeypatch):
    monkeypatch.setenv("MAD_TPU_NANCHECK", "1")
    sanitize.clear()
    yield
    sanitize.clear()


def test_flush_names_bad_stages_in_one_pull():
    sanitize.watch("stage_a", torch.ones(4))
    sanitize.watch("stage_b", torch.tensor([1.0, float("nan")]))
    sanitize.watch("stage_c", torch.full((3,), float("inf")))
    with pytest.raises(FloatingPointError, match="stage_b, stage_c"):
        sanitize.flush()
    # queue drained: a second flush is a no-op
    sanitize.flush()


def test_clean_pipeline_flushes_silently():
    for name in ("s1", "s2", "s3"):
        sanitize.watch(name, torch.arange(8, dtype=torch.float32))
    sanitize.watch("bf16", torch.ones(3, dtype=torch.bfloat16))
    sanitize.flush()


def test_watch_flag_rides_fused_programs():
    sanitize.watch_flag("fused_ok", torch.isfinite(torch.ones(3)).all())
    sanitize.watch_flag("fused_bad",
                        torch.isfinite(torch.tensor([float("nan")])).all())
    with pytest.raises(FloatingPointError, match="fused_bad"):
        sanitize.flush()


def test_non_float_and_none_arrays_ignored():
    sanitize.watch("ints", torch.arange(4), None)
    sanitize.flush()


def test_check_host_raises_immediately():
    with pytest.raises(FloatingPointError, match="host_stage"):
        sanitize.check_host("host_stage", np.array([np.nan]))


def test_off_mode_is_free(monkeypatch):
    monkeypatch.setenv("MAD_TPU_NANCHECK", "0")
    sanitize.watch("ignored", torch.tensor([float("nan")]))
    assert not sanitize._pending
    sanitize.flush()
    monkeypatch.setenv("MAD_TPU_NANCHECK", "global")
    assert sanitize.mode() == "global"
    monkeypatch.delenv("MAD_TPU_NANCHECK")
    sanitize.set_nan_checks(True)
    try:
        assert sanitize.mode() == "global"
    finally:
        sanitize.set_nan_checks(False)
    assert sanitize.mode() == "off"


def _stages(err) -> list:
    return re.search(r"stage\(s\): (.*) \(rerun", str(err)).group(1) \
        .split(", ")


def test_nan_voxel_named_first_as_mad_tpu_does():
    import jax
    from mad_tpu.core.config import MadConfig as JConfig
    from mad_tpu.core.grid import DensityGrid as JGrid
    from mad_tpu.engine.pipeline import describe_grid as jdescribe
    from mad_tpu.utils import sanitize as jsanitize
    assert not jax.config.jax_debug_nans
    rng = np.random.default_rng(0)
    data = rng.random((16, 16, 16)).astype(np.float32)
    data[6, 6, 6] = np.nan
    with pytest.raises(FloatingPointError) as got:
        describe_grid(DensityGrid(torch.as_tensor(data), np.zeros(3), 2.0),
                      MadConfig(), name="bad", device="cpu")
    jsanitize.clear()
    try:
        with pytest.raises(FloatingPointError) as want:
            jdescribe(JGrid(data=data, origin=np.zeros(3), voxsp=2.0),
                      JConfig(), name="bad")
    finally:
        jsanitize.clear()
    port, ref = _stages(got.value), _stages(want.value)
    assert port[0] == ref[0] == "scalespace.grad[o0]", (port, ref)
    assert set(port) <= set(ref), (port, ref)
    assert set(ref) - set(port) == {"detect[o1]"}, (port, ref)


def test_profiling_stage_accumulates(monkeypatch, tmp_path):
    profiling.show_timing(reset=True)
    with profiling.stage("unit_test_stage"):
        sum(range(1000))
    with profiling.stage("unit_test_stage"):
        sum(range(1000))
    t = profiling.get_timings()
    assert "unit_test_stage" in t and t["unit_test_stage"] >= 0
    assert profiling._COUNTS["unit_test_stage"] == 2
    table = profiling.show_timing(reset=True)
    assert "unit_test_stage" in table
    assert "unit_test_stage" not in profiling.get_timings()
    # timing.stage reads the registry's clock: the same seconds in both
    from mad_tpu_torch.timing import stage
    monkeypatch.setenv("MAD_TPU_HBM", "1")
    timings = {}
    with stage(timings, "fit_stage", "cpu"):
        sum(range(1000))
    assert timings["fit_stage"] == profiling.get_timings()["fit_stage"]
    assert profiling.hbm_peaks() == {} and \
        profiling.device_bytes_in_use() == 0     # no card in use
    profiling.show_timing(reset=True)
    with stage(None, "no_dict", "cpu"):
        pass
    assert "no_dict" not in profiling.get_timings()
    # device_trace writes a Chrome trace of its block
    with profiling.device_trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert logdir == str(tmp_path / "trace")

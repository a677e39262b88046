"""Port parity for `config`, `utils.tracing` and the public names of
`utils`, `config` and `plotting`.

Each config default is held to the default of the port's own parameter
of the same name (read with `inspect.signature`, not copied from the JAX
module's text), and to the JAX dataclass; the configs splat into port
calls as tests/test_utils.py splats them into JAX's.  Tracing runs on the
CPU (no device events there); the Chrome-trace summation is held to a
synthetic trace with known kernel, copy and memset events, exactly.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
import frankenz_tpu.config as JC
import frankenz_tpu.plotting as JPLOT
import frankenz_tpu.utils as JU
import frankenz_tpu.utils.checkpoint as JCK
import frankenz_tpu_torch as ft
from frankenz_tpu_torch import config as TC
from frankenz_tpu_torch.models import (BruteForce, GrowingNeuralGas,
                                       NearestNeighbors, SelfOrganizingMap)
from frankenz_tpu_torch.models import bruteforce as TBF
from frankenz_tpu_torch.models.networks import _Network
from frankenz_tpu_torch.ops import likelihood as TL
from frankenz_tpu_torch.samplers import (hierarchical_sampler,
                                         population_sampler)
from frankenz_tpu_torch.sim import MockSurvey
from frankenz_tpu_torch.utils import checkpoint as TCK
from frankenz_tpu_torch.utils import tracing as TT

# Where each config field's default lives in the port: {config: [(field,
# callable, parameter name)]}; a field may be checked against several.
_FIT_PREDICTS = (BruteForce.fit_predict, NearestNeighbors.fit_predict,
                 _Network.fit_predict, BruteForce.predict)
SOURCES = {
    "ThresholdConfig": [(f, fn, f) for f in ("wt_thresh", "cdf_thresh")
                        for fn in _FIT_PREDICTS],
    "LikelihoodConfig": [(f, fn, f) for f in (
        "free_scale", "ignore_model_err", "dim_prior", "ltol",
        "return_scale") for fn in (TL.logprob, TL.loglike)],
    "KNNConfig": [("K", NearestNeighbors.__init__, "K"),
                  ("k", NearestNeighbors.fit, "k"),
                  ("k", NearestNeighbors.fit_predict, "k"),
                  ("feature_map", NearestNeighbors.__init__, "feature_map"),
                  ("lp_norm", NearestNeighbors.fit, "lp_norm"),
                  ("leafsize", NearestNeighbors.__init__, "leafsize")],
    "SOMConfig": [(f, SelfOrganizingMap.train_network, f) for f in (
        "nside", "nproj", "niter", "nbatch", "wt_thresh", "cdf_thresh",
        "track_scale")],
    "GNGConfig": [(f, GrowingNeuralGas.train_network, f) for f in (
        "niter", "nbatch", "max_nodes", "max_age", "learn_best",
        "learn_neighbor", "new_err_dec", "all_err_dec", "track_scale")],
    "PopulationSamplerConfig": [(f, population_sampler.run_mcmc, f)
                                for f in ("thin", "mh_steps", "nchains")],
    "HierarchicalSamplerConfig": [(f, hierarchical_sampler.run_mcmc, f)
                                  for f in ("thin", "nchains")],
    "BatchConfig": [("batch_size", BruteForce.fit_predict, "batch_size"),
                    ("batch_size", BruteForce.fit, "batch_size"),
                    ("grid_budget_elems", TBF.default_batch_size,
                     "budget_elems"),
                    ("synth_budget_bytes", MockSurvey.synthesize_grid,
                     "budget_bytes")],
}


@pytest.mark.parametrize("name", TC.__all__)
def test_config_defaults_are_the_ports_own(name):
    cls = getattr(TC, name)
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    checked = set()
    for field, fn, param in SOURCES[name]:
        want = inspect.signature(fn).parameters[param].default
        assert defaults[field] == want, (name, field, fn.__qualname__)
        checked.add(field)
    assert checked == set(defaults), f"{name}: unchecked {set(defaults) - checked}"
    # The same dataclass as the JAX package's, field for field.
    jfields = {f.name: f.default
               for f in dataclasses.fields(getattr(JC, name))}
    assert jfields == defaults
    assert cls.__dataclass_params__.frozen


def test_configs_splat_into_calls():
    cfg = TC.KNNConfig()
    assert cfg.K == 25 and cfg.k == 20
    cfg2 = cfg.replace(K=5)
    assert cfg2.K == 5 and cfg.K == 25
    d = TC.LikelihoodConfig(free_scale=True).asdict()
    rng = np.random.default_rng(4)
    m = rng.uniform(1, 10, (20, 4))
    t = torch.tensor
    res = TL.logprob(t(m[:3]), t(0.1 * m[:3]), t(np.ones((3, 4))), t(m),
                     t(0.05 * m), t(np.ones_like(m)), **d)
    assert res[2].shape == (3, 20)
    som = SelfOrganizingMap(m, 0.05 * m, np.ones_like(m), device="cpu")
    som.train_network(**TC.SOMConfig(nside=3, niter=4, nbatch=5).asdict(),
                      seed=0, verbose=False)
    assert som.nodes.shape == (9, 4)
    gng = GrowingNeuralGas(m, 0.05 * m, np.ones_like(m), device="cpu")
    gng.train_network(**TC.GNGConfig(niter=4, nbatch=5,
                                     max_nodes=8).asdict(),
                      seed=0, verbose=False)
    assert 2 <= gng.NNODE <= 8
    bf = BruteForce(m, 0.05 * m, np.ones_like(m), device="cpu")
    pdfs = bf.fit_predict(m[:3], 0.1 * m[:3], np.ones((3, 4)),
                          rng.uniform(0, 3, 20), np.full(20, 0.1),
                          label_grid=np.linspace(0, 3, 31), verbose=False,
                          **TC.ThresholdConfig().asdict())
    assert pdfs.shape == (3, 31)


def test_tracing_helpers_on_the_cpu(tmp_path):
    with TT.annotate("test-phase"):
        pass
    assert TT.device_memory() == {} or torch.cuda.is_available()
    assert TT.device_memory("cpu") == {}
    with TT.trace(str(tmp_path / "t")):
        with TT.annotate("phase-a"):
            torch.ones(64).sum()
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "phase-a" in names
    # The CPU ran no device event: the summation finds none to keep.
    assert TT.collect_device_events(str(tmp_path / "t")) == {}
    assert TT.collect_device_events(str(tmp_path / "none")) is None
    assert TT.profile_device_busy(lambda x: x + 1,
                                  [(torch.ones(3),)]) == (None, None)


def _synthetic_trace(logdir):
    """A Chrome trace with known kernel, copy and memset events beside
    host events that must not count; durations in microseconds."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "chi2_stack_kernel",
         "ts": 0, "dur": 1250.5},
        {"ph": "X", "cat": "kernel", "name": "chi2_stack_kernel",
         "ts": 2000, "dur": 1249.25},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
         "ts": 4000, "dur": 3.75},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 5000, "dur": 812.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 6000, "dur": 1.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 9000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0, "dur": 4.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    logdir.mkdir(parents=True, exist_ok=True)
    (logdir / "trace_1.json").write_text(json.dumps(
        {"traceEvents": events}))


def test_collect_device_events_sums_a_synthetic_trace(tmp_path):
    _synthetic_trace(tmp_path / "t")
    got = TT.collect_device_events(str(tmp_path / "t"))
    assert got == {"chi2_stack_kernel": (1250.5 + 1249.25) / 1e6,
                   "elementwise_kernel": 3.75 / 1e6,
                   "Memcpy DtoH": 812.0 / 1e6,
                   "Memset (Device)": 1.5 / 1e6}
    kernels = TT.collect_device_events(str(tmp_path / "t"),
                                       plane_filter="kernel")
    assert set(kernels) == {"chi2_stack_kernel", "elementwise_kernel"}
    every = TT.collect_device_events(str(tmp_path / "t"), plane_filter="")
    assert every["aten::mm"] == 9000.0 / 1e6 and "instant" not in every


def test_profile_device_busy_sums_kernels_and_copies(tmp_path, monkeypatch):
    """Busy = kernels + copies (+ memsets), summed over the trace of the
    calls and divided by the calls; a prefix keeps matching names."""
    from contextlib import contextmanager
    from pathlib import Path

    calls = []

    @contextmanager
    def fake_trace(logdir, create_perfetto_link=False):
        yield
        _synthetic_trace(Path(logdir))

    monkeypatch.setattr(TT, "trace", fake_trace)
    busy, events = TT.profile_device_busy(lambda x: calls.append(x),
                                          [(1,), (2,)])
    assert calls == [1, 2]
    assert busy == sum(events.values()) / 2
    assert events["Memcpy DtoH"] == 812.0 / 1e6
    busy, _ = TT.profile_device_busy(lambda x: None, [(1,)],
                                     prefix="chi2_")
    assert busy == (1250.5 + 1249.25) / 1e6
    assert TT.profile_device_busy(lambda x: None, [(1,)],
                                  prefix="nothing")[0] is None


def test_profile_device_busy_counts_overlap_once(monkeypatch):
    """Kernels on two streams overlap on [50, 100]: busy is the union of
    the kept events, not their sum; the events by name stay sums."""
    from contextlib import contextmanager
    from pathlib import Path

    events = [
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 50, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 60, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 150, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 500.0},
    ]

    @contextmanager
    def fake_trace(logdir, create_perfetto_link=False):
        yield
        Path(logdir).mkdir(parents=True, exist_ok=True)
        (Path(logdir) / "trace_1.json").write_text(json.dumps(
            {"traceEvents": events}))

    monkeypatch.setattr(TT, "trace", fake_trace)
    busy, by_name = TT.profile_device_busy(lambda: None, [(), ()])
    assert by_name == {"k_a": 110.0 / 1e6, "k_b": 100.0 / 1e6,
                       "Memcpy DtoH": 20.0 / 1e6}
    assert busy == pytest.approx(170.0 / 1e6 / 2, rel=1e-12)
    busy, _ = TT.profile_device_busy(lambda: None, [()], prefix="k_")
    assert busy == pytest.approx(150.0 / 1e6, rel=1e-12)


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


@pytest.mark.parametrize("jax_mod, port_mod", [
    (JU, ft.utils), (JC, ft.config), (JPLOT, ft.plotting),
    (JCK, TCK), (JU.tracing, TT)])
def test_public_names_exist_in_the_port(jax_mod, port_mod):
    # Names the JAX modules import for themselves (jax, jnp, functools,
    # ...) are not their API: `__all__` where there is one, else every
    # public name that is not a module of the standard library or JAX.
    names = set(getattr(jax_mod, "__all__", ())) or {
        n for n in _public(jax_mod)
        if getattr(getattr(jax_mod, n), "__module__", "frankenz_tpu")
        .startswith("frankenz_tpu")}
    missing = sorted(n for n in names if not hasattr(port_mod, n))
    assert not missing, f"{port_mod.__name__} lacks {missing}"


def test_checkpoint_schema_is_jaxs():
    assert TCK.__all__ == JCK.__all__
    assert TCK._STATE_ATTRS == JCK._STATE_ATTRS


def test_package_exports():
    for name in ("save", "restore", "state_dict", "load_state_dict",
                 "annotate", "device_memory", "trace"):
        assert getattr(ft.utils, name) is not None
    assert ft.config is TC and ft.plotting.__name__ == \
        "frankenz_tpu_torch.plotting"

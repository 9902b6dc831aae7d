"""Isolation of the port: opentenbase_tpu_torch imports no JAX and nothing
of opentenbase_tpu, and its entry points run on the card by default."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "opentenbase_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import opentenbase_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "opentenbase_tpu" or m.startswith("opentenbase_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


_IMPORT_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "opentenbase_tpu" or m.startswith("opentenbase_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""

# the cluster tier's modules, each imported alone in a fresh interpreter
CLUSTER_MODULES = [
    "opentenbase_tpu_torch.parallel.cluster",
    "opentenbase_tpu_torch.exec.dist",
    "opentenbase_tpu_torch.exec.dist_session",
    "opentenbase_tpu_torch.exec.mesh_exec",
    "opentenbase_tpu_torch.parallel.mesh",
    "opentenbase_tpu_torch.gtm.server",
    "opentenbase_tpu_torch.plan.distribute",
]


# the vector search modules
ANN_MODULES = [
    "opentenbase_tpu_torch.ops.ann",
    "opentenbase_tpu_torch.storage.store",
]


# the fused and serving tiers' modules
FUSED_MODULES = [
    "opentenbase_tpu_torch.exec.fused",
    "opentenbase_tpu_torch.exec.plancache",
    "opentenbase_tpu_torch.exec.scheduler",
    "opentenbase_tpu_torch.exec.shield",
    "opentenbase_tpu_torch.sql.fingerprint",
]


# TPC-DS and the window functions (K13)
WINDOW_MODULES = [
    "opentenbase_tpu_torch.tpcds",
    "opentenbase_tpu_torch.tpcds.datagen",
    "opentenbase_tpu_torch.tpcds.queries",
    "opentenbase_tpu_torch.tpcds.schema",
    "opentenbase_tpu_torch.exec.executor",
    "opentenbase_tpu_torch.ops.kernels",
]


@pytest.mark.parametrize("module", CLUSTER_MODULES + FUSED_MODULES
                         + ANN_MODULES + WINDOW_MODULES)
def test_cluster_tier_module_loads_no_jax(module):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


_BAD_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|opentenbase_tpu)(\.|\s|$)", re.M)


def test_no_source_imports_jax_or_the_reference():
    offenders = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    if _BAD_IMPORT.search(fh.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as fh:
        assert not _BAD_IMPORT.search(fh.read())


def test_local_node_defaults_to_the_card():
    from opentenbase_tpu_torch.exec.session import LocalNode
    if torch.cuda.is_available():
        assert LocalNode().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalNode()
    assert LocalNode(device="cpu").device.type == "cpu"


def test_entry_defaults_to_the_card():
    from opentenbase_tpu_torch import entry
    if torch.cuda.is_available():
        _fn, (cols,) = entry.entry()
        assert all(v.device.type == "cuda" for v in cols.values())
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.entry()


def test_port_codec_state_is_its_own(monkeypatch, tmp_path):
    """The port keeps its codec ladder to itself: the reference's knobs
    do not reach it, and a column it encodes leaves the reference's
    ladder and state file untouched."""
    import numpy as np
    from opentenbase_tpu.storage import codec as ref
    from opentenbase_tpu_torch.storage import codec
    state = tmp_path / "ref_codec_state.json"
    monkeypatch.setenv("OTB_CODEC", "0")
    monkeypatch.setenv("OTB_CODEC_STATE", str(state))
    table = "isolation_probe"
    h = np.arange(1000, 1100, dtype=np.int64)
    try:
        out = codec.encode_staged(table, "c", h)
        assert out is not None and out[1].family == "for"
        assert (table, "c") in codec._LADDER
        assert (table, "c") not in ref._LADDER
        assert not state.exists()
    finally:
        codec.invalidate_ladder(table)
    assert (table, "c") not in codec._LADDER


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A wrapper given a CUDA tensor launches the kernel or raises; it
    never falls back to the plain version (checked without a card by
    faking the device test)."""
    from opentenbase_tpu_torch.ops import kernels as K
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_lib", no_library)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no kernel library"):
        K.visibility_mask(x, x, x, x, 1, 1, 1)
    assert calls == [1]


def test_fused_scan_agg_on_cuda_never_takes_the_plain_path(monkeypatch):
    """The fused scan-aggregate wrapper given CUDA tensors launches its
    kernel or raises."""
    from opentenbase_tpu_torch.ops import kernels as K
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_lib", no_library)
    monkeypatch.setattr(K, "fused_scan_agg_plain", None)
    spec = K.ScanAggSpec(instrs=[], n_shared=0, consts=[], aggs=[],
                         gid_reg=-1, qual_reg=-1, n_groups=1,
                         mv_regs=(0, 0, 0, 0), n_lits=0)
    x = torch.zeros(8, dtype=torch.int64)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no kernel library"):
        K.fused_scan_agg(spec, [(x, None, None)] * 4, 8,
                         torch.zeros((1, 0), dtype=torch.int64), one, one, 0)
    assert calls == [1]


def _window_call(K, name):
    x = torch.zeros(8, dtype=torch.int64)
    v = torch.ones(8, dtype=torch.bool)
    if name == "window_bounds":
        return lambda: K.window_bounds(torch.zeros((2, 8), dtype=torch.int64),
                                       1, (), v)
    if name == "window_frame_reduce":
        return lambda: K.window_frame_reduce("row_number", (x,) * 5, None,
                                             x, v)
    return lambda: K.range_minmax(x, v, True)


@pytest.mark.parametrize("name", ["window_bounds", "window_frame_reduce",
                                  "range_minmax"])
def test_window_kernels_on_cuda_never_take_the_plain_path(monkeypatch,
                                                          name):
    """The K13 wrappers given CUDA tensors launch their kernels or
    raise."""
    from opentenbase_tpu_torch.ops import kernels as K
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(K, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(K, "_lib", no_library)
    monkeypatch.setattr(K, name + "_plain", None)
    with pytest.raises(RuntimeError, match="no kernel library"):
        _window_call(K, name)()
    assert calls == [1]

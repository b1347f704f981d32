"""Checkpoints across packages: the port's ``CheckpointManager`` writes
and reads the reference's format (``arrays.npz`` + ``manifest.json``,
leaves named by ``jax.tree_util.keystr``, bf16 as a uint8 view, a CRC32
per stored leaf, static meta in ``extra``).

The state is a bf16 smoke llama1_7b's {params, AdamW state} plus a CLAQ
tensor whose stripe bits and shape travel in ``extra``.  The reference
writes it and the port restores it bitwise; the port writes it and the
reference restores it bitwise; both manifests name the same leaves in
the same order with the same shapes.  Then the counterparts of
tests/test_checkpoint.py: a verified round trip, a flipped byte raising
``CheckpointCorrupt`` with the leaf's name, and ``latest_step`` walking
back past a corrupt checkpoint."""
import dataclasses
import json
import os
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import OptimConfig as JOpt  # noqa: E402
from repro.optim import init_opt_state as j_init  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorrupt,  # noqa: E402
                                    CheckpointManager)
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import (from_numpy_tree, opt_state_from_numpy,  # noqa: E402
                                 param_tree, quantized_to_numpy)
from repro_torch.core import APConfig, CLAQConfig, ORConfig  # noqa: E402
from repro_torch.core import claq as claq_lib  # noqa: E402
from repro_torch.core.quantized import QuantStripe, QuantizedTensor  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import OptimConfig, init_opt_state  # noqa: E402
from test_torch_dense_configs import numpy_to_reference  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _bits(x):
    """Host bits of a tensor or array (bf16 as its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32) if x.dtype == torch.int32 \
            else x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x.view(np.uint32) if x.dtype == np.int32 else x


@pytest.fixture(scope="module")
def states():
    """The same state in both packages, and the CLAQ tensor's meta."""
    kw = dict(vocab=128, n_layers=2, dtype="bfloat16")
    jcfg = dataclasses.replace(get_smoke_config("llama1_7b"), **kw)
    tcfg = dataclasses.replace(t_smoke("llama1_7b"), **kw)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = j_init(jp, JOpt())
    rng = np.random.default_rng(0)
    jopt = jopt._replace(
        m=jax.tree_util.tree_map(lambda a: jnp.asarray(rng.normal(
            size=a.shape).astype(np.float32)), jopt.m),
        step=jnp.asarray(7, jnp.int32))
    W = torch.from_numpy(rng.normal(size=(48, 64)).astype(np.float32))
    qt, _, _ = claq_lib.quantize_matrix(
        W, None, CLAQConfig(bits=2, method="kmeans", kmeans_iters=3,
                            ap=APConfig(2.3, 2, 4), orr=ORConfig(0.05)))
    assert len(qt.stripes) > 1
    jqt = numpy_to_reference(quantized_to_numpy(qt))
    extra = {"claq": {"bits": [s.bits for s in qt.stripes],
                      "shape": list(qt.shape)}}

    tm = from_numpy_tree(jax_tree_to_numpy(jp), tcfg, device="cpu")
    topt = opt_state_from_numpy(
        {"m": jax_tree_to_numpy(jopt.m), "v": jax_tree_to_numpy(jopt.v),
         "step": np.asarray(jopt.step)}, tm, tcfg, device="cpu")
    jstate = {"params": jp, "opt": jopt, "claq": jqt}
    tstate = {"params": param_tree(tm, tcfg), "opt": topt, "claq": qt}
    return jcfg, tcfg, jstate, tstate, extra


def _port_template(tcfg, extra):
    """A fresh port state of the same structure: another init, zero
    moments, a CLAQ tensor rebuilt from the meta in ``extra``."""
    fresh = tapi.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    i32 = torch.zeros(0, dtype=torch.int32)
    f32 = torch.zeros(0)
    meta = extra["claq"]
    qt = QuantizedTensor(
        stripes=tuple(QuantStripe(i32, f32, b) for b in meta["bits"]),
        col_perm=i32, out_idx=i32, out_val=f32, out_count=i32,
        shape=tuple(meta["shape"]))
    tree = param_tree(fresh, tcfg)
    return {"params": tree, "opt": init_opt_state(tree, OptimConfig()),
            "claq": qt}


def _assert_same(port_state, ref_state):
    names = [n for n, _ in tree_lib.flatten(port_state)]
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    assert names == [jax.tree_util.keystr(p) for p, _ in ref_flat]
    for (name, leaf), (_, ref) in zip(tree_lib.flatten(port_state),
                                      ref_flat):
        got = (np.stack([_bits(t) for t in leaf])
               if isinstance(leaf, tree_lib.LayerStack) else _bits(leaf))
        np.testing.assert_array_equal(got, _bits(ref), err_msg=name)


def test_reference_writes_port_restores(states, tmp_path):
    jcfg, tcfg, jstate, tstate, extra = states
    JManager(str(tmp_path)).save(3, jstate, extra=extra)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    meta = mgr.manifest(3)["extra"]
    got = mgr.restore(3, _port_template(tcfg, meta))
    assert got["claq"].shape == tstate["claq"].shape
    assert [s.bits for s in got["claq"].stripes] == meta["claq"]["bits"]
    _assert_same(got, jstate)
    _assert_same(got, jax.tree_util.tree_map(np.asarray, jstate))
    # the restored params serve: a forward equals the original port model's
    model = tapi.init_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    tree_lib.copy_into(param_tree(model, tcfg), got["params"])
    toks = torch.arange(12).reshape(2, 6)
    want, _, _ = tapi.tf.forward(
        from_numpy_tree(jax_tree_to_numpy(jstate["params"]), tcfg, "cpu"),
        tcfg, toks)
    assert torch.equal(tapi.tf.forward(model, tcfg, toks)[0], want)


def test_port_writes_reference_restores(states, tmp_path):
    jcfg, tcfg, jstate, tstate, extra = states
    CheckpointManager(str(tmp_path)).save(4, tstate, extra=extra)
    jm = JManager(str(tmp_path))
    assert jm.latest_step() == 4
    tmpl = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    _assert_same(tstate, jm.restore(4, tmpl))


def test_manifests_name_the_same_leaves(states, tmp_path):
    jcfg, tcfg, jstate, tstate, extra = states
    JManager(str(tmp_path / "ref")).save(1, jstate, extra=extra)
    CheckpointManager(str(tmp_path / "port")).save(1, tstate, extra=extra)

    def manifest(d):
        with open(tmp_path / d / "step_0000000001" / "manifest.json") as f:
            return json.load(f)
    ref, port = manifest("ref"), manifest("port")
    assert list(port["leaves"]) == list(ref["leaves"])
    assert "['params']['blocks']['attn']['q']['kernel']" in port["leaves"]
    assert "['opt'].m['embed']['embedding']" in port["leaves"]
    assert "['claq'].stripes[0].packed" in port["leaves"]
    for name, info in ref["leaves"].items():
        mine = port["leaves"][name]
        assert (mine["key"], mine["shape"]) == (info["key"], info["shape"]), name
        if info["dtype"] != "uint32":     # the port's planes are int32
            assert (mine["dtype"], mine["crc"]) == (info["dtype"],
                                                    info["crc"]), name
    assert port["extra"] == ref["extra"] == extra
    assert ref["leaves"]["['params']['embed']['embedding']"]["dtype"] == \
        "bfloat16"


def _flip(directory, step, leaf):
    ckpt = os.path.join(directory, f"step_{step:010d}")
    with np.load(os.path.join(ckpt, "arrays.npz")) as z:
        arrays = {k: z[k].copy() for k in z.files}
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    key = (manifest["leaves"][leaf]["key"] if leaf
           else next(iter(arrays)))
    arrays[key].reshape(-1)[:4] ^= 0xFF
    np.savez(os.path.join(ckpt, "arrays.npz"), **arrays)


def test_flipped_byte_names_the_leaf(states, tmp_path):
    jcfg, tcfg, jstate, tstate, extra = states
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tstate, extra=extra)
    leaf = "['params']['blocks']['mlp']['down']['kernel']"
    _flip(str(tmp_path), 2, leaf)
    with pytest.raises(CheckpointCorrupt, match=r"\['down'\]") as ei:
        mgr.restore(2, _port_template(tcfg, extra))
    assert ei.value.leaf == leaf and ei.value.step == 2
    assert mgr.latest_step() is None


class State(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor
    step: torch.Tensor


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return State(w=torch.randn((8, 16), generator=g).to(torch.bfloat16),
                 b=torch.arange(16, dtype=torch.float32) + seed,
                 step=torch.tensor(3, dtype=torch.int32))


def _zeros(st):
    return State(*(torch.zeros_like(t) for t in st))


def test_roundtrip_verifies_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    mgr.save(7, st)
    assert mgr.latest_step() == 7
    out = mgr.restore(7, _zeros(st))
    for a, b in zip(st, out):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_corrupted_leaf_fails_fast_with_path(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    mgr.save(1, st)
    _flip(str(tmp_path), 1, ".w")
    with pytest.raises(CheckpointCorrupt, match=r"\.w") as ei:
        mgr.restore(1, _zeros(st))
    assert ei.value.leaf == ".w" and ei.value.step == 1
    assert mgr.latest_step() is None


def test_latest_step_falls_back_past_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state(seed=1))
    mgr.save(2, _state(seed=2))
    _flip(str(tmp_path), 2, None)
    assert mgr.latest_step() == 1                # newest valid, not newest
    step, out = mgr.restore_latest(_zeros(_state()))
    assert step == 1
    assert torch.equal(out.b, _state(seed=1).b)
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(2, _zeros(_state()))


def test_short_disk_fails_before_writing(tmp_path, monkeypatch):
    import shutil
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(shutil, "disk_usage",
                        lambda _: shutil._ntuple_diskusage(1, 1, 1000))
    with pytest.raises(OSError, match="GB free"):
        mgr.save(1, _state())
    assert mgr._list_steps() == []

"""Port parity for the hybrid family, the pipeline half (split from
tests/test_torch_hybrid.py so the suite's workers can balance it):
calibration taps key for key (the shared block once a site, its LoRA
delta as ``o_lora``), the quantizer's codes in weight space and its
Hessian/identity key sets, checkpoints across packages, and the CPU
launchers, on the smoke ``zamba2_1p2b`` of ``test_torch_hybrid.hy``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CLAQConfig as JCLAQ  # noqa: E402
from repro.launch import quantize as jlq  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import CLAQConfig  # noqa: E402
from repro_torch.launch import quantize as tlq  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from test_torch_models import jax_tree_to_numpy  # noqa: E402
from test_torch_hybrid import hy  # noqa: E402,F401
from test_torch_rwkv import (QCFG, checkpoint_both_ways,  # noqa: E402
                             hessian_keys, port_planes, ref_planes)

jax.config.update("jax_platform_name", "cpu")


def _ref_hessians(hy):
    if "jh" not in hy:
        hy["jh"] = jlq.calibrate(hy["jp"], hy["jcfg"],
                                 jnp.asarray(hy["calib"].numpy()),
                                 batch_size=2)
    return hy["jh"]


def test_calibration_taps_key_for_key(hy):
    """The shared block taps once a site (``shared_attn.site{s}.q`` ...
    ``.gate``, its LoRA delta through ``o`` as ``o_lora``), the Mamba2
    layers ``layers.{i}.mamba.in_proj``; every Hessian within 1e-5 of its
    largest entry."""
    tcfg = hy["tcfg"]
    jh = _ref_hessians(hy)
    th = tlq.calibrate(hy["tm"], tcfg, hy["calib"], batch_size=2)
    assert list(th) == list(jh)
    assert {"shared_attn.site2.o_lora", "shared_attn.site0.gate",
            "layers.5.mamba.out_proj", "lm_head"} <= set(th)
    for k, H in th.items():
        Hj = np.asarray(jh[k])
        np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-5,
                                   atol=1e-5 * np.abs(Hj).max(), err_msg=k)


def test_quantizer_codes_and_hessian_keys(hy):
    """Weight space: every matrix gets the reference's codes exactly.
    From the reference's Hessians: the same keys take a Hessian (the
    shared q/k/v/o, summed over sites) and the same the identity (every
    Mamba2 in_proj/out_proj and the shared MLP), as in the reference."""
    jcfg, tcfg, jp = hy["jcfg"], hy["tcfg"], hy["jp"]
    jh = _ref_hessians(hy)
    th = {k: torch.from_numpy(np.array(v)) for k, v in jh.items()}

    def jfn(with_h):
        q, rep = jlq.quantize_model_params(jp, jcfg, jh if with_h else {},
                                           JCLAQ(**QCFG))
        planes = ref_planes(q, [("layers.{}", q["blocks"], tcfg.n_layers),
                                ("shared_attn", q["shared_attn"], None)])
        assert set(planes) == set(rep.stats)
        return planes

    def tfn(with_h):
        m, rep = tlq.quantize_model_params(
            from_numpy_tree(jax_tree_to_numpy(jp), tcfg, "cpu"), tcfg,
            th if with_h else {}, CLAQConfig(**QCFG))
        planes = {}
        for k, v in port_planes(m).items():
            head, _, rest = k.partition(".")
            if head == "blocks":      # blocks.{i}.mamba.x -> layers.{i}.x
                i, _, leaf = rest.partition(".")
                k = f"layers.{i}.{leaf.removeprefix('mamba.')}"
            planes[k] = v
        assert set(planes) == set(rep.stats)
        return planes
    (jh_keys, jid, j0), (th_keys, tid, t0) = hessian_keys(jfn, tfn)
    assert (th_keys, tid) == (jh_keys, jid)
    assert th_keys == {f"shared_attn.{n}" for n in "qkvo"}
    assert tid == ({f"layers.{i}.{n}" for i in range(tcfg.n_layers)
                    for n in ("in_proj", "out_proj")}
                   | {f"shared_attn.mlp.{n}" for n in ("gate", "up",
                                                       "down")})
    for k in j0:
        for a, b in zip(t0[k], j0[k]):
            np.testing.assert_array_equal(a.view(np.uint32), b, err_msg=k)


def test_checkpoint_written_by_each_restored_by_the_other(hy, tmp_path):
    fresh = checkpoint_both_ways(tmp_path, hy["jp"], hy["tm"], hy["tcfg"])
    toks = torch.arange(1, 13).reshape(2, 6)
    assert torch.equal(tapi.tf.forward(fresh, hy["tcfg"], toks)[0],
                       tapi.tf.forward(hy["tm"], hy["tcfg"], toks)[0])


def test_launchers_on_cpu(capsys):
    st = tserve.main(["--arch", "zamba2_1p2b", "--smoke", "--bits", "2.2",
                      "--requests", "3", "--max-new", "4", "--device",
                      "cpu"])
    out = capsys.readouterr().out
    assert "CLAQ-quantized to" in out
    assert "[serve] 3 requests, 12 tokens" in out
    assert st["lifecycle"]["finished"] == 3
    ttrain.main(["--arch", "zamba2_1p2b", "--smoke", "--steps", "2",
                 "--device", "cpu"])
    assert "[train] done" in capsys.readouterr().out

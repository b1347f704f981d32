"""Training on a (data, model) mesh (``train.make_train_step`` under
``dist.context.use_mesh``) and the mesh launchers, on spawned gloo CPU
ranks, held to the single-device port and, for the first step, to the
reference's single-device step (the reference's own mesh train test
fails under this JAX, so its single-device step is the parity it has).

The model is the smoke llama1_7b narrowed to d_model 64 (vocab 128, 2
layers, f32), initialized by the reference and converted.  Tolerances:

  * the step-0 loss on every mesh against the reference's single-device
    loss on the same numpy tokens: 1e-5 (the port's own single-device
    parity with the reference is 1e-5);
  * every step's loss and grad norm against the single-device port's:
    rtol 1e-5 (f32: a sharded product sums its partial input gradients
    over ranks, the data ranks' gradients are summed, so sums run in
    another order; the measured gaps are below 2e-7);
  * the params after 3 AdamW steps (lr 1e-3), gathered from the blocks,
    and the launchers' final states: every leaf within 1e-3 of its own
    largest magnitude.  Adam normalizes a gradient that cancels to
    rounding noise, so such a weight moves by a noise-driven part of lr
    a step: measured up to 9e-6 here and 2.3e-5 in the launcher runs
    (lr 3e-4, 4 steps), against weights of 0.1-1; a misplaced block
    would be off by the leaf's own scale.

The four ranks also train as a (pod 2, data 1, model 2) mesh: "dp" is
pod x data, so the pod axis takes the data axis's part; its losses stay
within 1e-6 of the single device's and its params within the bound
above.

The launcher round trips: a checkpoint written on a 1x2 mesh resumes on
one device, and one written on one device resumes on a 2x1 mesh; both
runs end at the straight single-device run's state.

F3: the serve launcher on 2 ranks whose thread counts differ (4 on rank
0, 1 on rank 1) serves the single device's tokens at 8 threads: rank 0
quantizes and every rank receives its tree (on this CPU the smoke
granite's 1-thread quantization differs from its 8-thread one in a few
leaves, so a rank quantizing its own copy would serve another model).
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import from_numpy_tree, param_tree  # noqa: E402
from repro_torch.dist import context as dctx  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.optim import OptimConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-3
POD_LOSS_ATOL = 1e-6
POD = ((2, 1, 2), ("pod", "data", "model"))
STEP2, STEP4 = "step_0000000002", "step_0000000004"
REF_LOSS_ATOL = 1e-5
LAUNCH = ["--arch", "llama1_7b", "--smoke", "--batch", "4", "--seq-len",
          "32", "--backend", "gloo", "--device", "cpu"]
F3_ARCHS = ("granite_8b", "qwen2_1p5b")
RECURRENT = ("rwkv6_7b", "zamba2_1p2b")
# the families whose train launcher runs on (1, 2) against one device
MESH_LAUNCHED = RECURRENT + ("seamless_m4t_medium",)
SERVE = ["--smoke", "--bits", "2.2", "--requests", "3", "--max-new", "4",
         "--max-len", "32", "--device", "cpu"]


def _cfg(arch="llama1_7b"):
    return dataclasses.replace(t_smoke(arch), d_model=64, vocab=128,
                               n_layers=2)


def _tokens():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, size=(8, 32)).astype(np.int32)
            for _ in range(STEPS)]


def _train(tree, shape=None, microbatches=1, axes=("data", "model")):
    """STEPS steps on the port from the numpy tree, on a debug mesh of
    ``shape`` over ``axes`` (the world's size) or one device: losses,
    grad norms and the whole params after the last step."""
    from repro_torch.launch.train import gathered_state
    cfg = _cfg()
    model = from_numpy_tree(tree, cfg, device="cpu")
    mesh = None
    if shape is not None:
        mesh = mesh_lib.make_debug_mesh(shape, axes, device_type="cpu")
        shd.place_model(model, cfg, mesh)
    ocfg = OptimConfig(**OPT)
    opt = init_opt_state(param_tree(model, cfg), ocfg)
    step = make_train_step(cfg, ocfg, microbatches)
    losses, norms = [], []
    with dctx.use_mesh(mesh):
        for t in _tokens():
            model, opt, met = step(model, opt, {"tokens": torch.from_numpy(t)})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        params = (param_tree(model, cfg) if mesh is None
                  else gathered_state(model, cfg, opt, mesh)["params"])
    return dict(losses=losses, norms=norms,
                params=[t.numpy().copy() for t in tree_lib.tensors(params)])


def _launch(argv):
    from repro_torch.launch import train
    train.main(LAUNCH + argv)


def _rank2(rank, world, dev, tree, dirs):
    """(1, 2), (2, 1), microbatches on (2, 1), the launcher's halves on a
    mesh, then F3's serve launcher with unequal thread counts."""
    from repro_torch.launch import serve
    out = {shape: _train(tree, shape) for shape in ((1, 2), (2, 1))}
    out["micro"] = _train(tree, (2, 1), microbatches=2)
    out["remat_off_thread"] = _backward_off_thread(tree)
    # a mesh runs 4 steps (saving 2 and 4); a mesh resumes a one-device
    # step 2 to step 4
    _launch(["--mesh-shape", "1x2", "--steps", "4", "--ckpt-every", "2",
             "--ckpt-dir", dirs["mesh_first"]])
    _launch(["--mesh-shape", "2x1", "--steps", "4", "--ckpt-every", "2",
             "--ckpt-dir", dirs["one_first"]])
    torch.set_num_threads(4 if rank == 0 else 1)
    out["serve"] = {arch: serve.main(["--arch", arch, "--mesh-shape", "1x2",
                                      "--backend", "gloo"] + SERVE)["tokens"]
                    for arch in F3_ARCHS}
    for arch in MESH_LAUNCHED:
        _launch_arch(arch, ["--mesh-shape", "1x2", "--ckpt-dir",
                            dirs[f"{arch}_mesh"]])
    return out


def _launch_arch(arch, argv):
    """The train launcher on the smoke ``arch``: 2 steps, a checkpoint at
    the end."""
    from repro_torch.launch import train
    train.main(["--arch", arch] + LAUNCH[2:] + ["--steps", "2",
                                                "--ckpt-every", "2"] + argv)


def _backward_off_thread(tree):
    """The remat'd loss's gradients on a (1, 2) mesh, the backward run on
    another thread (where the autograd engine runs a CUDA backward, and
    this thread's mesh context is not set), against the same thread's."""
    import threading
    from repro_torch.models import api
    cfg = dataclasses.replace(_cfg(), remat=True)
    model = from_numpy_tree(tree, cfg, device="cpu")
    mesh = mesh_lib.make_debug_mesh((1, 2), device_type="cpu")
    shd.place_model(model, cfg, mesh)
    flat = tree_lib.tensors(param_tree(model, cfg))
    batch = {"tokens": torch.from_numpy(_tokens()[0])}
    for t in flat:
        t.requires_grad_(True)
    grads, box = [], {}
    for off_thread in (False, True):
        with dctx.use_mesh(mesh), torch.enable_grad():
            loss, _ = api.loss_fn(model, cfg, batch)
        if off_thread:
            th = threading.Thread(target=lambda: box.update(
                g=torch.autograd.grad(loss, flat)))
            th.start()
            th.join()
            grads.append(box.get("g"))
        else:
            with dctx.use_mesh(mesh):
                grads.append(torch.autograd.grad(loss, flat))
    return grads[1] is not None and all(
        torch.equal(a, b) for a, b in zip(*grads))


def _rank4(rank, world, dev, tree):
    return {(2, 2): _train(tree, (2, 2)),
            POD[0]: _train(tree, POD[0], axes=POD[1])}


def _final_params(d, step=STEP4):
    with np.load(os.path.join(d, step, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's step-0 loss, the single-device port's runs, the
    ranks' runs and the launchers' checkpoints."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import api as japi
    from repro_torch.launch import serve
    from test_torch_models import jax_tree_to_numpy
    import test_torch_dist_train as me
    jcfg = dataclasses.replace(get_smoke_config("llama1_7b"), d_model=64,
                               vocab=128, n_layers=2)
    jp = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax_tree_to_numpy(jp)
    ref_loss = float(japi.loss_fn(
        jp, jcfg, {"tokens": jnp.asarray(_tokens()[0])})[0])
    single = _train(tree)
    micro = _train(tree, microbatches=2)
    base = tmp_path_factory.mktemp("launch")
    dirs = {k: str(base / k) for k in ("mesh_first", "one_first", "straight")
            + tuple(f"{a}_{w}" for a in MESH_LAUNCHED
                    for w in ("mesh", "one"))}
    _launch(["--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
             dirs["straight"]])
    for arch in MESH_LAUNCHED:
        _launch_arch(arch, ["--ckpt-dir", dirs[f"{arch}_one"]])
    shutil.copytree(os.path.join(dirs["straight"], STEP2),
                    os.path.join(dirs["one_first"], STEP2))
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        served = {arch: serve.main(["--arch", arch] + SERVE)["tokens"]
                  for arch in F3_ARCHS}
    finally:
        torch.set_num_threads(threads)
    two = mesh_lib.run_local(me._rank2, 2, tree, dirs)
    four = mesh_lib.run_local(me._rank4, 4, tree)
    # the mesh run preempted after step 2, resumed on one device
    shutil.rmtree(os.path.join(dirs["mesh_first"], STEP4))
    _launch(["--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
             dirs["mesh_first"]])
    return dict(ref_loss=ref_loss, single=single, micro=micro, two=two,
                four=four, dirs=dirs, served=served)


def _close(got, want, tag):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               atol=0, err_msg=tag)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL,
                               atol=0, err_msg=tag)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        assert a.shape == b.shape, tag
        np.testing.assert_allclose(
            a, b, rtol=0, err_msg=tag,
            atol=STATE_RTOL * float(np.abs(b).max()))


def _ranks(runs, shape):
    return [r[shape] for r in runs["four" if len(shape) == 3 or shape == (
        2, 2) else "two"]]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), POD[0]])
def test_mesh_steps_equal_single_device(runs, shape):
    ranks = _ranks(runs, shape)
    for r, got in enumerate(ranks):
        _close(got, runs["single"], f"{shape} rank {r}")
        if shape == POD[0]:
            np.testing.assert_allclose(got["losses"],
                                       runs["single"]["losses"], rtol=0,
                                       atol=POD_LOSS_ATOL)
    # the ranks agree with each other exactly: one all-reduce result each
    assert all(g["losses"] == ranks[0]["losses"] for g in ranks)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), POD[0]])
def test_mesh_step0_loss_equals_reference(runs, shape):
    ranks = _ranks(runs, shape)
    assert abs(runs["single"]["losses"][0] - runs["ref_loss"]) < \
        REF_LOSS_ATOL
    for got in ranks:
        assert abs(got["losses"][0] - runs["ref_loss"]) < REF_LOSS_ATOL


def test_microbatches_on_a_data_mesh(runs):
    for r in runs["two"]:
        _close(r["micro"], runs["micro"], "microbatches 2 on (2, 1)")


def test_remat_recomputes_on_the_mesh_from_any_thread(runs):
    """A remat'd block recomputes in the backward under the forward's
    mesh, also when the backward runs on another thread (the autograd
    engine's thread of a CUDA backward): the gradients are the same."""
    assert all(r["remat_off_thread"] for r in runs["two"])


@pytest.mark.parametrize("tag", ["mesh_first", "one_first"])
def test_launcher_checkpoints_cross_mesh_and_one_device(runs, tag):
    """A mesh run's step-2 save resumed on one device, and a one-device
    run's resumed on a mesh (the launcher's schedule follows --steps, so
    each resumes a 4-step run), both end at the straight one-device
    run's step 4."""
    want = _final_params(runs["dirs"]["straight"])
    got = _final_params(runs["dirs"][tag])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if got[k].dtype.kind == "f":
            np.testing.assert_allclose(
                got[k], want[k], rtol=0, err_msg=k,
                atol=STATE_RTOL * float(np.abs(want[k]).max()))
        else:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", F3_ARCHS)
def test_mesh_serves_rank0_quantization_whatever_the_threads(runs, arch):
    """F3: both ranks (4 and 1 threads) serve the 8-thread single
    device's tokens."""
    for r in runs["two"]:
        assert r["serve"][arch] == runs["served"][arch]
    assert all(len(t) == 4 for t in runs["served"][arch])


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b",
                                  "seamless_m4t_medium"])
def test_multi_rank_mesh_refuses_unported_families(request, arch):
    """No family is refused on a multi-rank mesh any more: rwkv, the
    hybrid and encdec (its frames' rows split with its tokens) train
    there, the train launcher's 2 steps on (1, 2) ending at its
    single-device state."""
    dirs = request.getfixturevalue("runs")["dirs"]
    got = _final_params(dirs[f"{arch}_mesh"], STEP2)
    want = _final_params(dirs[f"{arch}_one"], STEP2)
    assert got.keys() == want.keys() and len(want) > 10
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(
            got[k], want[k], rtol=0, err_msg=k,
            atol=STATE_RTOL * float(np.abs(want[k]).max()))

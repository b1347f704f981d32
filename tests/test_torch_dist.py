"""The port's distribution layer (``repro_torch.dist``,
``repro_torch.launch.mesh``) held against the reference's ``repro.dist``.

  * the sharding rules: for every smoke config, the port's spec of every
    leaf of the params (converted from the reference's arrays), of
    prepared AP+OR plans and of the caches (contiguous, paged fp, paged
    int8) equals the reference's, on four mesh shapes passed as
    duck-typed meshes to both packages;
  * shard-local plans: the blocks' dequantizations, concatenated, are the
    whole plan's bit for bit, with outliers in every block and the last
    tile; a unit whose tiles do not divide stays whole;
  * on 4 gloo ranks (spawned once for the module): the row-sharded
    quantizer against the single-device one (the port's and the
    reference's) within the reference's own tolerance, the psum'd k-means,
    and ``compressed_psum`` as ``tests/test_dist.py`` asserts it.

JAX is imported lazily: the spawned ranks import this module and run the
port only.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

ARCHS = ("llama1_7b", "zamba2_1p2b", "seamless_m4t_medium", "glm4_9b",
         "qwen3_32b", "qwen2_1p5b", "granite_8b", "phi3_vision_4p2b",
         "rwkv6_7b", "deepseek_v2_236b", "qwen3_moe_30b_a3b")
MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 4}, {"model": 8},
          {"pod": 2, "data": 16, "model": 16})


def _jax():
    import jax
    jax.config.update("jax_platform_name", "cpu")
    return jax


def ref_specs(tree, rule, cfg, shape):
    """The reference's (keystr name, spec) of every leaf, as its
    ``tree_shardings`` assigns them (quantized units expanded)."""
    jax = _jax()
    from jax.sharding import PartitionSpec
    from repro.dist import sharding as jshd
    ax = jshd.MeshAxes(SimpleNamespace(shape=dict(shape)))
    out = []
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=jshd._is_quantized_unit)[0]
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if jshd._is_quantized_unit(leaf):
            sub = jax.tree_util.tree_flatten_with_path(
                jshd.spec_for_quantized(leaf, ax),
                is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
            out += [(name + jax.tree_util.keystr(p), tuple(s))
                    for p, s in sub]
        else:
            out.append((name, tuple(rule(name, np.shape(leaf), cfg, ax))))
    return out


def port_specs(tree, rule, cfg, shape):
    return [(n, tuple(s))
            for n, s in tshd.tree_specs(tree, rule, cfg, dict(shape))]


@pytest.fixture(scope="module")
def param_trees():
    """(reference param tree, port model) of every smoke config: the
    reference's tree as numpy arrays of its shapes and dtypes (the rules
    read shapes only; ``jax.eval_shape`` skips the init's arithmetic),
    converted into the port's model."""
    jax = _jax()
    from repro.configs import get_smoke_config
    from repro.models import api as japi
    out = {}
    for arch in ARCHS:
        jcfg = get_smoke_config(arch)
        sds = jax.eval_shape(lambda: japi.init_params(
            jax.random.PRNGKey(0), jcfg))
        jp = jax.tree_util.tree_map(
            lambda l: np.zeros(l.shape, l.dtype), sds)
        tm = convert.from_numpy_tree(jp, t_smoke(arch), device="cpu")
        out[arch] = (jcfg, jp, tm)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(param_trees, arch):
    from repro.dist import sharding as jshd
    jcfg, jp, tm = param_trees[arch]
    tcfg = t_smoke(arch)
    tree = convert.param_tree(tm, tcfg)
    for shape in MESHES:
        want = ref_specs(jp, jshd.spec_for_param_serve, jcfg, shape)
        got = port_specs(tree, tshd.spec_for_param_serve, tcfg, shape)
        assert got == want, (arch, shape)
    big = dict(MESHES[1])
    assert any("model" in s for _, s in port_specs(
        tree, tshd.spec_for_param, tcfg, big))


_CACHES = (("contiguous", {}),
           ("paged", dict(page_size=8, n_pages=15)),
           ("paged_int8", dict(page_size=8, n_pages=15, kv_dtype="int8")))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch):
    """Slot caches: the port's per-layer list (encdec: its
    ``EncDecCache``), read in the reference's stacked layout."""
    jax = _jax()
    from repro.configs import get_smoke_config
    from repro.dist import sharding as jshd
    from repro.models import api as japi
    jcfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    ran = 0
    for _, kw in _CACHES:
        if tcfg.family == "encdec":
            kw = dict(kw, src_len=16)
        try:
            sds = jax.eval_shape(lambda: japi.make_cache(jcfg, 4, 32, **kw))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                tapi.make_cache(tcfg, 4, 32, dtype=torch.float32,
                                device="cpu", **kw)
            continue
        cache = tapi.make_cache(tcfg, 4, 32, dtype=torch.float32,
                                device="cpu", **kw)
        tree = tshd.cache_tree(cache, tcfg)
        for shape in MESHES + ({"data": 4, "model": 2},):
            want = ref_specs(sds, jshd.spec_for_cache, jcfg, shape)
            got = port_specs(tree, tshd.spec_for_cache, tcfg, shape)
            assert got == want, (arch, kw, shape)
        ran += 1
    assert ran >= 1


def test_batch_specs_equal_the_reference():
    from repro.dist import sharding as jshd
    for shape in MESHES:
        jax_ax = jshd.MeshAxes(SimpleNamespace(shape=shape))
        ax = tshd.MeshAxes(shape)
        for s in ((16, 64), (3, 8), (32,), ()):
            assert tuple(tshd.spec_for_batch("['tokens']", s, None, ax)) == \
                tuple(jshd.spec_for_batch("['tokens']", s, None, jax_ax))


# ---------------------------------------------------------------------------
# Prepared plans
# ---------------------------------------------------------------------------

ROWS, COLS = 256, 160
# rows in each of 4 row blocks of 64 (and in the last 32-row tile)
OUTLIER_ROWS = (5, 70, 140, 250)


def _ref_stacked_qt(seed: int, layers: int = 2):
    """A layer-stacked reference QuantizedTensor: AP-style column bits
    shared by the layers, outliers in every row block of every layer."""
    import jax.numpy as jnp
    from repro.core import quantized as jq
    rng = np.random.default_rng(seed)
    column_bits = rng.choice([2, 3, 4], size=COLS, p=[0.6, 0.2, 0.2])
    counts = np.full(COLS, len(OUTLIER_ROWS))
    members = []
    for _ in range(layers):
        codes = np.stack([rng.integers(0, 2 ** b, size=ROWS)
                          for b in column_bits], axis=1).astype(np.int32)
        cb = np.sort(rng.normal(size=(COLS, 16)).astype(np.float32), axis=1)
        cb[np.arange(16)[None, :] >= (2 ** column_bits)[:, None]] = np.inf
        mask = np.zeros((ROWS, COLS), bool)
        mask[list(OUTLIER_ROWS), :] = True
        Q = rng.normal(size=(ROWS, COLS)).astype(np.float32)
        members.append(jq.build_quantized_tensor(
            jnp.asarray(codes), jnp.asarray(cb), column_bits, counts,
            jnp.asarray(Q), jnp.asarray(mask)))
    jax = _jax()
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)


@pytest.fixture(scope="module")
def plans():
    """{bn: (reference stacked plan, port LayerStack of plans)} of one
    stacked AP+OR tensor, plus the raw tensors."""
    from repro.kernels import plan as jplan
    from test_torch_packing import qt_to_numpy
    jqt = _ref_stacked_qt(0)
    d = qt_to_numpy(jqt)
    tqts = tree_lib.LayerStack(
        convert.quantized_from_numpy(d, device="cpu", layer=i)
        for i in range(2))
    out = {"raw": (jqt, tqts)}
    for bn in (32, 128):
        jp = jplan.prepare_for_inference(jqt, bn=bn)
        tp = tree_lib.LayerStack(tplan.prepare_for_inference(q, bn=bn)
                                 for q in tqts)
        out[bn] = (jp, tp)
    return out


@pytest.mark.parametrize("key", ["raw", 32, 128])
def test_plan_specs_equal_the_reference(plans, key):
    """A prepared unit splits its planes over "model" when its tiles
    divide (bn=32: 8 tiles), else stays whole (bn=128: 2 tiles, whole on
    model=4); a raw QuantizedTensor is always whole."""
    from repro.dist import sharding as jshd
    jq, tq = plans[key]
    jtree, ttree = {"w": {"kernel": jq}}, {"w": {"kernel": tq}}
    split = set()
    for shape in MESHES + ({"data": 1, "model": 2},):
        want = ref_specs(jtree, jshd.spec_for_param_serve, None, shape)
        got = port_specs(ttree, tshd.spec_for_param_serve, None, shape)
        assert got == want, (key, shape)
        if any("model" in s for _, s in got):
            split.add(shape["model"])
    assert split == {"raw": set(), 32: {2, 4, 8}, 128: {2}}[key]


def test_local_plans_concatenate_to_the_whole_plan(plans):
    """For tp = 2, 4, 8: each block's dequantize, concatenated, is the
    whole plan's bitwise (outliers in every block and the last tile are
    rebased to the block); a block applies no other block's outlier; a
    plan whose tiles do not divide refuses to split."""
    _, tp = plans[32]
    for pqt in tp:
        whole = pqt.dequantize()
        for parts in (2, 4, 8):
            assert pqt.shards_whole_tiles(parts)
            blocks = [tplan.local_plan(pqt, parts, i) for i in range(parts)]
            got = torch.cat([b.dequantize() for b in blocks])
            assert torch.equal(got, whole), parts
            for i, b in enumerate(blocks):
                assert b.shard == tplan.PlanShard(parts, i, ROWS)
                assert b.n_padded == pqt.n_padded // parts
                for g, wg in zip(b.groups, pqt.groups):
                    oi = g.out_idx[g.out_idx >= 0]
                    assert oi.numel() == 0 or int(oi.max()) < b.n_padded
                    # K-indexed leaves are the whole plan's, shared
                    assert g.codebook is wg.codebook
                    assert g.x_idx is wg.x_idx
                n_out = sum(int((g.out_idx >= 0).sum()) for g in b.groups)
                assert n_out == sum(int(((g.out_idx >= i * b.n_padded)
                                         & (g.out_idx < (i + 1)
                                            * b.n_padded)).sum())
                                    for g in pqt.groups)
                lo, hi = i * b.n_padded, (i + 1) * b.n_padded
                assert (n_out > 0) == any(lo <= r < hi
                                          for r in OUTLIER_ROWS), (parts, i)
    _, tp128 = plans[128]
    assert not tp128[0].shards_whole_tiles(4)
    with pytest.raises(ValueError):
        tplan.local_plan(tp128[0], 4, 0)


def test_local_shard_blocks():
    """local_shard / entry_block over single and tuple entries (pod x data
    is row-major)."""
    mesh = {"pod": 2, "data": 2, "model": 2}
    t = torch.arange(8 * 6).reshape(8, 6)
    spec = tshd.PartitionSpec(("pod", "data"), "model")
    got = tshd.local_shard(t, spec, mesh, {"pod": 1, "data": 0, "model": 1})
    assert torch.equal(got, t[4:6, 3:6])
    assert tshd.entry_block(("pod", "data"), mesh,
                            {"pod": 1, "data": 1}) == (4, 3)
    assert tshd.local_shard(t, tshd.PartitionSpec(), mesh, {}) is t
    assert repr(spec) == "PartitionSpec(('pod', 'data'), 'model')"


def test_production_mesh_refuses_a_small_world():
    with pytest.raises(ValueError, match="256"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        mesh_lib.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="nccl"):
        mesh_lib.init_distributed("nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.init_distributed("mpi", "cpu")


# ---------------------------------------------------------------------------
# Multi-rank: the row-sharded quantizer, k-means statistics, compressed_psum
# ---------------------------------------------------------------------------

def _quant_cfg():
    """The case of ``tests/test_dist.py``'s row-sharded quantizer test."""
    from repro_torch.core import CLAQConfig
    return CLAQConfig(bits=3, method="kmeans", kmeans_iters=5,
                      gptq_blocksize=32)


def _matrix():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(64, 64)).astype(np.float32)
    X = rng.normal(size=(256, 64)).astype(np.float32)
    return W, (2 * X.T @ X).astype(np.float32)


def _rank_checks(rank, world, dev):
    """Run on every rank of a 4-rank gloo world."""
    import torch.distributed as dist
    from repro_torch.core import claq, kmeans
    from repro_torch.optim import compressed_psum
    mesh = mesh_lib.make_debug_mesh((1, world), device_type="cpu")
    W, H = _matrix()
    cfg = _quant_cfg()
    qt, Q, st = claq.quantize_matrix(torch.from_numpy(W),
                                     torch.from_numpy(H), cfg, mesh=mesh)
    out = {"Q": Q.numpy(), "proxy": st.proxy_loss,
           "dq": qt.dequantize().numpy()}
    # psum'd Lloyd statistics: the blocks of one column fit the centroids
    # of the whole column from a common init
    col = torch.from_numpy(W[:, 3]).contiguous()
    blk = col.reshape(world, -1)[rank]
    out["km"] = kmeans.kmeans_1d(blk, 4, iters=3,
                                 group=dist.group.WORLD)[0].numpy()
    # compressed_psum: each rank's gradient tree, two steps of feedback
    g_rng = np.random.default_rng(100 + rank)
    grads = {"a": torch.from_numpy(g_rng.normal(size=(64,)).astype(
        np.float32)), "b": [torch.from_numpy(g_rng.normal(
            size=(8, 4)).astype(np.float32))]}
    err = tree_lib.tree_map(torch.zeros_like, grads)
    mean, new_err = compressed_psum(grads, err)
    out["grads"] = grads
    out["mean"] = mean
    out["err"] = new_err
    return out


@pytest.fixture(scope="module")
def ranks():
    import test_torch_dist
    return mesh_lib.run_local(test_torch_dist._rank_checks, 4)


def test_rowsharded_quantizer_matches_single_device(ranks):
    """The tolerance of ``tests/test_dist.py``: Q to rtol 1e-4 / atol 1e-5,
    the proxy loss to 1e-3 relative; every rank holds the same result."""
    from repro_torch.core import claq
    W, H = _matrix()
    cfg = _quant_cfg()
    _, Q1, st1 = claq.quantize_matrix(torch.from_numpy(W),
                                      torch.from_numpy(H), cfg)
    for r in ranks:
        np.testing.assert_allclose(r["Q"], Q1.numpy(), rtol=1e-4, atol=1e-5)
        assert abs(r["proxy"] - st1.proxy_loss) <= 1e-3 * abs(st1.proxy_loss)
        np.testing.assert_array_equal(r["Q"], ranks[0]["Q"])
        np.testing.assert_array_equal(r["dq"], ranks[0]["dq"])


def test_rowsharded_quantizer_matches_the_reference(ranks):
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import CLAQConfig
    from repro.core.claq import quantize_matrix
    W, H = _matrix()
    jcfg = CLAQConfig(bits=3, method="kmeans", kmeans_iters=5,
                      gptq_blocksize=32)
    _, Qj, stj = quantize_matrix(jnp.asarray(W), jnp.asarray(H), jcfg)
    assert jax is not None
    np.testing.assert_allclose(ranks[0]["Q"], np.asarray(Qj), rtol=1e-4,
                               atol=1e-5)
    assert abs(ranks[0]["proxy"] - stj.proxy_loss) <= \
        1e-3 * abs(stj.proxy_loss)


def test_kmeans_sums_statistics_over_the_group(ranks):
    """Every rank ends at the same centroids: Lloyd's iterations whose
    per-cluster sums and counts are summed over the ranks' blocks (each
    block assigned by its own rank's centroids: the first iteration starts
    from each block's own quantile init, as in the reference)."""
    from repro_torch.core import kmeans
    W, _ = _matrix()
    for r in ranks:
        np.testing.assert_array_equal(r["km"], ranks[0]["km"])
    col = torch.from_numpy(W[:, 3]).contiguous()
    blocks = col.reshape(len(ranks), -1)
    cs = [kmeans._quantile_init(torch.sort(b).values[None], 4,
                                torch.tensor([4], dtype=torch.int32))[0]
          for b in blocks]
    for _ in range(3):
        sums = torch.zeros(4)
        cnt = torch.zeros(4)
        for b, c in zip(blocks, cs):
            oh = torch.nn.functional.one_hot(kmeans._assign(b, c), 4).float()
            sums += (oh * b[:, None]).sum(0)
            cnt += oh.sum(0)
        cs = [torch.where(cnt > 0, sums / torch.clamp(cnt, min=1e-9), c)
              for c in cs]
    np.testing.assert_allclose(ranks[0]["km"], np.sort(cs[0].numpy()),
                               rtol=1e-5, atol=1e-6)


def test_compressed_psum_mean_error_and_residual(ranks):
    """``tests/test_dist.py``'s assertions on a tree: every rank holds the
    same mean, within one int8 step (the global scale) of the true mean,
    and the residual is what the compression dropped."""
    n = len(ranks)
    flat = [tree_lib.tensors(r["grads"]) for r in ranks]
    for i in range(len(flat[0])):
        true = sum(f[i] for f in flat) / n
        scale = max(float(f[i].abs().max()) for f in flat) / 127.0 + 1e-12
        got = [tree_lib.tensors(r["mean"])[i] for r in ranks]
        assert all(torch.equal(g, got[0]) for g in got)
        assert float((got[0] - true).abs().max()) <= scale + 1e-6
        for r, f in zip(ranks, flat):
            e = tree_lib.tensors(r["err"])[i]
            assert float(e.abs().max()) <= scale + 1e-6
            q = torch.clamp(torch.round(f[i] / scale), -127, 127)
            torch.testing.assert_close(e, f[i] - q * scale, rtol=0,
                                       atol=1e-6)
    assert isinstance(ranks[0]["mean"]["b"], list)


def test_dataclass_shapes_survive_the_port():
    """``PlanShard`` is frozen and compares by value, as the plan that
    holds it; ``PartitionSpec()`` is the empty tuple, as JAX's."""
    a = tplan.PlanShard(2, 1, 64)
    assert a == tplan.PlanShard(2, 1, 64)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.parts = 3
    assert tuple(tshd.PartitionSpec()) == ()

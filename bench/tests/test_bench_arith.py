"""The yardstick's arithmetic on hand-made inputs: traffic draws, tails and
rates, spreads, device busy and idle time from a trace, and K1's bound."""
import types

import numpy as np
import pytest
import torch

from bench import devtrace, harness, roofline, stats, traffic, weights
from bench.serve_loop import Run, Served, Step

MIX = {"source": "CPU test", "clients": 3, "slots": 3, "max_len": 64,
       "prompt_tokens": {"median": 10, "sigma": 0.5, "min": 4, "max": 20},
       "output_tokens": {"median": 5, "sigma": 0.5, "min": 3, "max": 9},
       "requests_per_client": 5, "shape_seed": 11,
       "warmup": {"prompt_tokens": 4, "output_tokens": 3}}


def test_traffic_same_seed_same_requests_other_seed_other_tokens():
    a, b = traffic.generate(MIX, 42, 100), traffic.generate(MIX, 42, 100)
    c = traffic.generate(MIX, 2 ** 31 + 17, 100)
    assert a == b
    assert a != c
    # every seed serves the same set of lengths, dealt to other clients
    def shapes(t):
        return sorted((len(r.prompt), r.max_new) for reqs in t.clients
                      for r in reqs)
    assert shapes(a) == shapes(c)
    lens = traffic.lengths(MIX)
    assert lens[..., 0].min() >= 4 and lens[..., 0].max() <= 20
    assert lens[..., 1].min() >= 3 and lens[..., 1].max() <= 9


def test_log_normal_lengths_keep_their_median_and_clip():
    mix = dict(MIX, clients=40, requests_per_client=50, max_len=4096,
               prompt_tokens={"median": 1500, "sigma": 0.8, "min": 64,
                              "max": 3840},
               output_tokens={"median": 13, "sigma": 1.0, "min": 3,
                              "max": 256})
    lens = traffic.lengths(mix)
    assert lens.shape == (40, 50, 2) and lens.dtype == np.int64
    p, o = lens[..., 0], lens[..., 1]
    assert 64 <= p.min() and p.max() == 3840      # the tail is clipped
    assert 3 <= o.min() and o.max() <= 256
    assert 1300 <= np.median(p) <= 1700 and 11 <= np.median(o) <= 15
    # heavy-tailed: the mean lies well above the median
    assert o.mean() > 1.4 * np.median(o)
    assert (traffic.lengths(mix) == lens).all()
    with pytest.raises(ValueError):
        traffic.lengths(dict(mix, output_tokens=dict(
            mix["output_tokens"], max=300)))


def test_traffic_refuses_requests_that_cannot_be_seen_or_fit():
    with pytest.raises(ValueError):
        traffic.lengths(dict(MIX, output_tokens=dict(MIX["output_tokens"],
                                                      min=2)))
    with pytest.raises(ValueError):
        traffic.lengths(dict(MIX, prompt_tokens=dict(MIX["prompt_tokens"],
                                                      max=60)))


def test_percentile_and_spread_on_hand_made_samples():
    xs = [float(v) for v in range(1, 101)]
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    # statistics.quantiles (exclusive): 25.25 and 75.75 about 50.5
    assert stats.spread(xs) == pytest.approx((75.75 - 25.25) / 50.5)
    assert stats.merge_intervals([(5, 7), (0, 2), (1, 3), (6, 9)]) == [
        (0, 3), (5, 9)]


def _run():
    """Two requests over a window (10, 20]: one sent before it opened."""
    a = Served(0, [1] * 4, 4, submit_t=8.0, in_window=False,
               times=[9.0, 9.0, 12.0, 15.0], state="finished")
    b = Served(1, [1] * 6, 3, submit_t=12.0, in_window=True,
               times=[13.0, 13.0, 21.0], state="running")
    steps = [Step(8.5, 9.0, [[0, 0]], 4, 1, False),
             Step(12.5, 13.0, [[1, 1]], 6, 2, True),
             Step(20.5, 21.0, [], 0, 1, True)]
    return Run({0: a, 1: b}, steps, 0, 10.0, 20.0, 2)


def test_rates_and_tails_of_a_hand_made_run():
    e2e = harness.end_to_end(_run(), setup_s=3.5)
    # tokens in (10, 20]: a at 12 and 15, b at 13 and 13
    assert e2e["out_tok_s"] == pytest.approx(4 / 10)
    # only b was sent in the window: 13 - 12 s
    assert e2e["ttft_p95_ms"] == pytest.approx(1000.0)
    # gaps ending in the window: a 9->12, 12->15; b 13->13
    assert e2e["tpot_p95_ms"] == pytest.approx(
        np.percentile([3000.0, 3000.0, 0.0], 95))
    assert e2e["setup_s"] == 3.5
    assert harness.attempted_failed(_run()) == (1, 0)
    assert harness.served_by_close(_run())[1] == []
    assert harness.finished_by_close(_run()) == [0]


def _event(name, start, dur, cpu=True, cid=0, link=0, tid=1):
    """A kineto event: host ops link to nothing, runtime calls and device
    work to the op that made them (``link``); a runtime call and its
    device work share a correlation id (``cid``)."""
    kind = torch.autograd.DeviceType.CPU if cpu else \
        torch.autograd.DeviceType.CUDA
    return types.SimpleNamespace(
        device_type=lambda: kind, linked_correlation_id=lambda: link,
        start_ns=lambda: start, duration_ns=lambda: dur,
        start_thread_id=lambda: tid, name=lambda: name,
        correlation_id=lambda: cid)


def test_busy_scopes_and_idle_gaps_of_a_hand_made_trace():
    us = 1000
    ev = [_event("bench::step", 0, 100 * us, cid=1),
          _event("repro_torch::dequant_matmul[aligned]", 10 * us, 20 * us,
                 cid=2),
          _event("aten::mm", 40 * us, 10 * us, cid=3),
          # K1 is launched by ctypes: it and its runtime call link to no op
          _event("cudaLaunchKernel", 11 * us, 1 * us, cid=9),
          _event("k1_kernel", 20 * us, 30 * us, cpu=False, cid=9),
          _event("cudaLaunchKernel", 41 * us, 1 * us, cid=10, link=3),
          _event("gemm", 45 * us, 10 * us, cpu=False, cid=10, link=3),
          # the device's copy of an annotation is no operation
          _event("bench::step", 0, 100 * us, cpu=False, link=1)]
    s = devtrace.summarize(ev, ["repro_torch::dequant_matmul"])
    assert s.busy_s == pytest.approx(35e-6)          # [20, 55) us
    assert s.scope_s["repro_torch::dequant_matmul"] == pytest.approx(30e-6)
    assert s.device_ops[0] == ("k1_kernel", pytest.approx(30e-6))
    idle = dict(s.idle_gaps)
    assert sum(idle.values()) == pytest.approx(65e-6)  # 100 - 35 us
    # the leading gap's middle (10 us) falls in the K1 scope
    assert idle["bench::step > repro_torch::dequant_matmul[aligned]"] == \
        pytest.approx(20e-6)


def test_scope_time_from_the_device_copy_of_its_annotation():
    """A kernel whose launch the trace does not show is counted by the
    device's copy of the annotation it ran in."""
    us = 1000
    ev = [_event("bench::step", 0, 100 * us, cid=1),
          _event("repro_torch::dequant_matmul[gathered]", 10 * us, 20 * us,
                 cid=2),
          _event("k1_kernel", 20 * us, 30 * us, cpu=False, cid=50),
          _event("other", 60 * us, 10 * us, cpu=False, cid=51),
          _event("repro_torch::dequant_matmul[gathered]", 20 * us, 30 * us,
                 cpu=False, cid=52)]
    s = devtrace.summarize(ev, ["repro_torch::dequant_matmul"])
    assert s.busy_s == pytest.approx(40e-6)
    assert s.scope_s["repro_torch::dequant_matmul"] == pytest.approx(30e-6)


def test_k1_bound_against_a_hand_count():
    from repro_torch.core.packing import plane_widths
    from repro_torch.kernels.plan import prepare_for_inference
    from bench import program
    rows, cols, m = 96, 512, 7
    qt = program._claq(weights.draw_parts(3, "t", rows, cols, device="cpu"))
    pqt = prepare_for_inference(qt)
    n_bytes, flops = roofline.chain_bytes_flops(pqt, m, 2)
    hand = m * cols * 2 + m * pqt.n_padded * 4            # x in, f32 y out
    for g in pqt.groups:
        kp = g.k_padded
        hand += sum(pqt.n_padded // (32 // w) * kp * 4
                    for w in plane_widths(g.bits))         # int32 planes
        hand += kp * 2 ** g.bits * 4                        # f32 codebook
        if g.out_idx is not None:
            hand += g.out_idx.shape[0] * kp * (4 + 4)       # idx + value
        if g.x_idx is not None:
            hand += kp * 4                                  # gather table
    assert n_bytes == hand
    assert flops == 2 * m * rows * cols
    assert roofline.bound_s(n_bytes, flops) == pytest.approx(
        max(hand / 3.35e12, flops / 989e12))


def test_model_flops_of_a_prompt_and_a_token():
    m = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab": 10, "n_layers": 2, "family": "dense"}
    per = 2 * (8 * (2 + 2) * 4 + 2 * 4 * 8 + 3 * 8 * 16)    # 2 x weights
    assert roofline.decode_flops(m, 5) == 2 * (per + 4 * 2 * 4 * 5) + 160
    assert roofline.prefill_flops(m, 3) == pytest.approx(
        sum(2 * (per + 4 * 2 * 4 * (c + 1)) for c in range(3)) + 160)


def test_parts_dequantize_to_codebook_entries_and_reserved_values():
    p = weights.draw_parts(5, "x", 24, 40, stack=(2,), device="cpu")
    W = weights.dequantize(p)
    e, r, c = 1, 7, 13
    want = (p.Q[e, r, c] if p.mask[e, r, c]
            else p.codebooks[e, c, p.codes[e, r, c]])
    assert W[e, r, c] == want
    assert torch.isfinite(W).all()
    assert (p.mask.sum(-2).numpy() == p.counts).all()
    assert set(np.unique(p.column_bits)) == {2, 3, 4}


def test_a_metric_is_found_by_its_file_name(tmp_path):
    (tmp_path / "steps.window.py").write_text(
        "def read(rec):\n    return len(rec.run.window_steps())\n")
    mod = harness.metric_module("steps.window", tmp_path)
    assert mod.read(harness.Record({}, _run(), None, {})) == 2

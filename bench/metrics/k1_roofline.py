"""K1/K1e (``csrc/dequant_matmul.cu`` through ``kernels/dequant_matmul.py``):
the least time of every K1 matmul of the traced window, each the larger of
its bytes (plan operands and x read once, the f32 y written once) over
3.35 TB/s and its 2 M N K over 989 TFLOP/s, over the device time of the
kernels under the ``repro_torch::dequant_matmul`` scopes, in %.

Each matmul's plan and M are read where ``kernels.ops`` hands a prepared
plan to the kernel chain (``prepared_qmatmul``), by a probe that wraps
that function for the traced window only."""
import contextlib

from bench import roofline

SCOPES = ("repro_torch::dequant_matmul",)


class Probe(contextlib.AbstractContextManager):
    def __init__(self):
        self.bound_s = 0.0
        self.calls = 0
        self._sizes = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._orig = ops, ops.prepared_qmatmul
        orig = self._orig

        def probed(x, pqt, **kw):
            m = x.numel() // x.shape[-1]
            key = (id(pqt), m, x.element_size())
            b = self._sizes.get(key)
            if b is None:
                b = roofline.bound_s(*roofline.chain_bytes_flops(
                    pqt, m, 1 if kw.get("act_dtype") == "int8"
                    else x.element_size()))
                self._sizes[key] = b
            self.bound_s += b
            self.calls += 1
            return orig(x, pqt, **kw)
        ops.prepared_qmatmul = probed
        return self

    def __exit__(self, *exc):
        self._ops.prepared_qmatmul = self._orig
        return False


def probe():
    return Probe()


def read(rec):
    t = rec.trace.scope_s.get(SCOPES[0], 0.0)
    p = rec.probes["k1_roofline"]
    if t <= 0 or not p.calls:
        return None
    return 100.0 * p.bound_s / t

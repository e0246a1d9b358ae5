"""Roofline and MFU arithmetic on known shapes, and the reduction of a trace."""

import json
from types import SimpleNamespace

import pytest

from perfbench import models
from perfbench.core import bounds, cell, trace

SPEC = cell.Spec(cell.HERE.parent)
CFG = SPEC.config("freqfusion-f32")
MODEL = models.load(CFG["model"])


def test_launch_bound_takes_the_largest_of_three():
    # 1 TFLOP of products at 495 TFLOP/s beats 1 GFLOP of CUDA-core work and 1 MB
    assert bounds.launch_s(1e9, 1e12, 2.5e5, "float32") == pytest.approx(1e12 / 495e12)
    # bytes bound: 1e9 float32 elements at 3.35 TB/s
    assert bounds.launch_s(0, 0, 1e9, "float32") == pytest.approx(4e9 / 3.35e12)
    assert bounds.launch_s(0, 0, 1e9, "bfloat16") == pytest.approx(2e9 / 3.35e12)
    assert bounds.launch_s(67e12, 0, 0, "bfloat16") == pytest.approx(1.0)
    # float32 at default: products on bf16 operands at bf16's peak, float32 elements
    assert bounds.launch_s(0, 989e12, 0, "float32", "default") == pytest.approx(1.0)
    assert bounds.launch_s(0, 0, 1e9, "float32", "default") == pytest.approx(4e9 / 3.35e12)
    with pytest.raises(ValueError):
        bounds.launch_s(0, 0, 0, "float32", "high")


def test_precision_sets_the_control():
    from perfbench.core.precision import numerics
    assert [numerics(d, p).control for d, p in [("float32", "highest"), ("float32", "default"),
                                                ("bfloat16", "highest")]] == [
        "tf32", "fp8_e4m3", "fp8_e4m3"]


def test_conv3x3_counts():
    cuda, tc, elems = bounds.conv3x3(1, 352, 512, 180, 180)
    assert cuda == 0 and tc == 352 * 512 * 18 * 180 * 180
    assert elems == 352 * 512 * 360 + 9 * 180 * 180 + 180
    cuda, tc, _ = bounds.conv3x3(1, 1408, 2048, 3, 64)      # narrow: CUDA cores
    assert tc == 0 and cuda == 1408 * 2048 * 18 * 3 * 64


def test_forward_launches_per_image():
    names = [k for k, _ in MODEL.launches(CFG, 1, 352, 512)]
    count = {k: names.count(k) for k in set(names)}
    assert count == {"naf_stage_a": 14, "naf_stage_b": 14, "conv3x3": 22,
                     "window_attention_xqkv": 36, "aim_conv_branch": 36, "aim_gates_proj": 36,
                     "sgfn_tail": 36, "cab_chain": 72, "hab_block": 72,
                     "overlap_attention": 12, "residual_ln_mlp": 12, "band_mha": 1,
                     "lka_gate": 1}
    f32 = bounds.forward_bound(MODEL, CFG, 1, 352, 512, "float32")
    bf16 = bounds.forward_bound(MODEL, CFG, 1, 352, 512, "bfloat16")
    assert 0.03 < f32 < 0.2 and bf16 < f32          # far under the 1.27 s a forward takes


def test_roofline_and_mfu_readers():
    run = SimpleNamespace(model=MODEL, cfg=CFG, dtype="float32", forwards=[(1, 352, 512)] * 2,
                          trace={"port_s": 2.0, "device_s": 2.5,
                                 "busy_s": {0: 2.5}, "window_s": 3.0})
    least = 2 * bounds.forward_bound(MODEL, CFG, 1, 352, 512, "float32")
    assert cell.reader("kernels.port_roofline")(run) == pytest.approx(100 * least / 2.0)
    assert cell.reader("kernels.glue_share")(run) == pytest.approx(20.0)
    assert cell.reader("device.idle_share")(run) == pytest.approx(100 / 6)

    import perfbench.core.flops as flops
    calls = []

    def fake(cfg, b, h, w):
        calls.append((b, h, w))
        return 1e12 * b * h * w / (352 * 512)

    mfu = cell.reader("device.mfu")
    mfu.__globals__["forward_flops"] = fake
    run = SimpleNamespace(cfg=CFG, dtype="float32", trace={}, window_s=2.0,
                          n_devices=1, requests=[(0, (339, 510), 0, 1), (1, (540, 960), 1, 2)],
                          mix=SPEC.traffic("tiled-540p"))
    # a 512x352 bucket (1 TFLOP) and a 540p frame in 12 chunks of 2 x 192^2
    want = (1e12 + 12 * 1e12 * 2 * 192 * 192 / (352 * 512)) / 2.0 / 495e12 * 100
    assert mfu(run) == pytest.approx(want)
    assert calls == [(1, 352, 512), (2, 192, 192)]
    assert flops.forward_flops is not fake


def test_model_flops_scale_with_the_batch_and_the_shape():
    from perfbench.core.flops import forward_flops
    small = json.loads(json.dumps(CFG))
    small["hat"].update(depths=[1], num_heads=[6])
    small["dat"].update(depths=[1], num_heads=[6])
    small["nafnet"].update(enc_blk_nums=[1, 1, 1, 1], middle_blk_num=1,
                           dec_blk_nums=[1, 1, 1, 1])
    f1 = forward_flops(json.dumps(small), 1, 64, 64)
    f2 = forward_flops(json.dumps(small), 2, 64, 64)
    # twice the images, twice the FLOPs, but for the position-bias MLPs (once a forward)
    assert f1 > 1e9 and abs(f2 - 2 * f1) < 1e-5 * f2
    # the served model: about 173 MFLOP an LR pixel, whatever the bucket
    full = forward_flops(json.dumps(CFG), 1, 352, 512)
    assert full / (352 * 512) == pytest.approx(172.67e6, rel=1e-3)


class Ev:
    def __init__(self, kind, name, start, end, dev=0, annotation=False):
        self.k, self.n, self.s, self.e, self.d, self.a = kind, name, start, end, dev, annotation

    def device_type(self):
        return f"DeviceType.{self.k}"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def duration_ns(self):
        return self.e - self.s

    def device_index(self):
        return self.d

    def is_user_annotation(self):
        return self.a


def test_trace_reduction():
    evs = [Ev("CPU", trace.WINDOW, 0, 1000, annotation=True),
           Ev("CPU", "serve.dispatch", 0, 400, annotation=True),
           Ev("CPU", "aten::copy_", 0, 150),
           Ev("CUDA", trace.WINDOW, 0, 1000, annotation=True),
           Ev("CUDA", "void (anonymous namespace)::band_mha_kernel<float>(Args)", 200, 500),
           Ev("CUDA", "sm90_xmma_gemm_f32", 450, 700),
           Ev("CUDA", "void rows_kernel<float, 3>(x)", 850, 1100)]
    r = trace.reduce(evs, {"band_mha_kernel", "rows_kernel"}, [0])
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"][0] == pytest.approx(650e-9)        # [200, 700] and [850, 1000]
    assert r["port_s"] == pytest.approx(450e-9) and r["device_s"] == pytest.approx(700e-9)
    assert r["kernel_s"]["band_mha_kernel"] == pytest.approx(300e-9)
    assert r["idle_gaps"] == [["serve.dispatch > aten::copy_", pytest.approx(200e-9)],
                              ["nothing traced", pytest.approx(150e-9)]]

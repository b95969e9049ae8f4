"""The operation and byte counts, and the mfu, roofline and idle arithmetic,
against values worked out by hand."""

from __future__ import annotations

import pytest

from harness import files
from harness.trace import Kernel, Reading, parse

VITG = files.cell("cryovit_vitg14.infer")["config_spec"]


def flops_of(name):
    return files.load_module("flops", name)


def test_vitg_per_slice():
    # 1029 tokens (cls, 4 registers, 32x32 patches), width 1536, SwiGLU 4096, 40 blocks:
    # qkv 2*1029*1536*4608, attention 4*1029^2*1536, proj 2*1029*1536^2,
    # w12 2*1029*1536*8192, w3 2*1029*4096*1536; patch embed 2*1024*196*1536
    block = (14_566_293_504 + 6_505_519_104 + 4_855_431_168 + 25_895_632_896
             + 12_947_816_448)
    want = 40 * block + 616_562_688
    assert flops_of("cryovit_vitg14").backbone_flops_per_slice(VITG, 32) == want
    assert want == pytest.approx(2.5914e12, rel=1e-4)


def test_attention_launch_and_bound():
    from flops import kernels as K

    flops, nbytes = K.flash_attention(64, 1029, 24, 64)
    assert flops == 4 * 64 * 24 * 1029 ** 2 * 64
    assert nbytes == 2 * (4 * 64 * 1029 * 1536 + 3 * 1536)
    assert K.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)  # bound by operations
    assert K.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.42098, rel=1e-4)


def test_conv_kernels():
    from flops import kernels as K

    # 8 voxels, 16 -> 32 channels: 2*27*16*32*8 products; x, y and weights in bf16
    assert K.conv3d_dm(8, 16, 32) == (221_184.0, 2 * (8 * 48 + 27 * 16 * 32))
    assert K.conv3d_dm_dw(8, 16, 32) == (221_184.0, 2 * 8 * 48 + 4 * 27 * 16 * 32)
    assert K.convt2x_dm(8, 16, 32) == (2 * 4 * 16 * 32 * 8, 2 * (8 * 16 + 8 * 4 * 32 + 4 * 16 * 32))
    assert K.bound_s(1.0, 3.35e12) == pytest.approx(1.0)  # one second of bytes


def test_decoder_train_step():
    f = flops_of("cryovit_vitg14")
    # the projection's forward and weight gradient only; 3x every conv
    proj = 2 * 1536 * 1024 * 128 * 32 * 32
    front = 2 * 27 * 1024 * 192 * 128 * 32 * 32
    total = f.decoder_flops(VITG, 128, 32, train=True)
    assert total == pytest.approx(9.137e12, rel=1e-3)
    assert total > 2 * proj + 3 * front
    work = f.train_work(VITG, 128, 512, 2)
    assert work["launches"] == {"conv3d_dm": 24, "conv3d_dm_dw": 12, "convt2x_dm": 4,
                                "convt2x_dm_bwd": 4}
    assert work["model_flops"] == 2 * total


def test_infer_work_tail_batches():
    f = flops_of("cryovit_vitg14")
    work = f.infer_work(VITG, [160], 512, 64)  # batches 64, 64, 32
    assert work["launches"]["flash_attention"] == 3 * 40
    full = f.infer_work(VITG, [128], 512, 64)["bounds_s"]["flash_attention"]
    assert work["bounds_s"]["flash_attention"] == pytest.approx(full * 2.5 / 2)


def _reading(**kw):
    base = dict(entry="train_step", window_s=2.0, busy_s=1.5, kernels=[], spans={},
                port_kernels=set(), launches={}, work={}, breakdown={})
    return Reading(**{**base, **kw})


def test_mfu_and_idle():
    readers = files.metric_readers()
    t = _reading(work={"model_flops": 989e12 * 0.5})  # half a second of peak in 2 s
    assert readers["mfu.train"].read(t) == pytest.approx(25.0)
    assert readers["idle_pct.train"].read(t) == pytest.approx(25.0)
    assert readers["mfu.infer"].read(t) is None  # another entry's metric reads nothing


def test_roofline_share():
    reader = files.metric_readers()["conv_dm_roofline"]
    kernels = [Kernel("conv3d_dm_kernel(a)", "conv3d_dm_kernel", 0.0, 4000.0, 0.0),
               Kernel("sum_partials_kernel(b)", "sum_partials_kernel", 5000.0, 1000.0, 1.0)]
    t = _reading(kernels=kernels, port_kernels={"conv3d_dm_kernel", "sum_partials_kernel"},
                 launches={"conv3d_dm": 1}, work={"bounds_s": {"conv_dm": 0.002},
                                                  "launches": {"conv3d_dm": 1}})
    assert reader.read(t) == pytest.approx(40.0)  # 2 ms of bound over 5 ms of kernels
    t.launches = {"conv3d_dm": 2}  # launches the work did not count: no reading
    assert reader.read(t) is None


def test_parse_union_and_gaps():
    ev = lambda cat, name, ts, dur, **a: {"ph": "X", "cat": cat, "name": name, "ts": ts,  # noqa: E731
                                          "dur": dur, "args": a}
    trace = {"traceEvents": [
        ev("user_annotation", "benchmark.window", 0, 1000),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 2, correlation=1),
        ev("kernel", "void k1<1>(int)", 10, 300, correlation=1),
        ev("kernel", "k2(int)", 200, 300),  # overlaps k1: counted once
        ev("gpu_memcpy", "Memcpy HtoD", 700, 100),
        ev("cpu_op", "aten::copy_", 500, 150),
    ]}
    r = parse(trace, "train_step", {"k1"}, {}, {})
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s == pytest.approx(590e-6)  # [10, 500) and [700, 800)
    assert r.kernels[0].base == "k1" and r.kernels[0].launch == 5
    gaps = dict(r.breakdown["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(200e-6)  # [500, 700)
    assert gaps["host code outside any torch op"] == pytest.approx(210e-6)  # [0,10) + [800,1000)

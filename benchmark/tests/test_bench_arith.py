"""The yardstick's arithmetic: model work, the percentile and rate rules,
the idle share as a union of intervals."""

import pytest
import torch

from harness import stats, trace
from reference import field, render


def test_flops_per_sample_hand_count():
    arch = {"netdepth": 8, "netwidth": 256, "skips": [4], "freqs_xyz": 10}
    macs = (63 * 256            # xyz_0 on the 63-wide encoding
            + 6 * 256 * 256     # xyz_1-3, xyz_5-7
            + (256 + 63) * 256  # xyz_4, the encoding joined again
            + 256 * 1           # sigma
            + 256 * 256         # xyz_final
            + 256 * 128         # dir_0
            + 128 * 3)          # rgb
    assert field.flops_per_sample(arch) == 2 * macs == 1179904


def test_model_work_two_rays():
    # one vertex 0.15 m off the first ray's axis, 0.25 m off the second's
    verts = torch.tensor([[[0.0, 0.15, 0.0]]])
    rays = torch.tensor([[[0.0, 0.0, 3.0, 0.0, 0.0, -1.0, 2.0, 4.0],
                          [0.0, 0.4, 3.0, 0.0, 0.0, -1.0, 2.0, 4.0]]])
    hit = render.rays_near_points(rays, verts, 0.2)
    assert hit.tolist() == [[True, False]]
    # the segment ends before the vertex: 1 m short of it
    short = rays.clone()
    short[..., 7] = 2.0
    short[..., 6] = 1.0
    assert not render.rays_near_points(short, verts, 0.2).any()
    # model work: the counted ray's samples (64 coarse + 96 fine) x FLOPs
    arch = {"netdepth": 8, "netwidth": 256, "skips": [4], "freqs_xyz": 10}
    work = float(hit.sum()) * (2 * 64 + 32) * field.flops_per_sample(arch)
    assert work == 160 * 1179904


def test_percentile_nearest_rank():
    v = list(range(1, 101))           # 1..100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_all_work_over_all_time():
    assert stats.rate(3 * 16384, 1.5) == pytest.approx(32768.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_quartiles():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9, 10, 10, 11]) > 0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_share_is_a_union_of_intervals():
    ev = [_ev("user_annotation", trace.WINDOW_SPAN, 0.0, 100.0),
          _ev("kernel", "void mlp_fwd_bf16<1>(float*)", 10.0, 30.0),
          _ev("kernel", "void knn_sweep::go<4>(int)", 20.0, 30.0),
          _ev("gpu_user_annotation", trace.WINDOW_SPAN, 0.0, 100.0),
          _ev("kernel", "late", 90.0, 50.0),
          _ev("cpu_op", "aten::nonzero", 55.0, 30.0),
          _ev("cpu_op", "aten::outer", 50.0, 40.0)]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    # kernels cover [10, 50] and [90, 100]: 50 us busy, not the 70 us sum
    assert r["busy_s"] == pytest.approx(50e-6)
    assert trace.device_seconds(r["by_name"], ("mlp_fwd",)) \
        == pytest.approx(30e-6)
    assert r["device_ops"][0] == ["mlp_fwd_bf16", pytest.approx(30e-6)]
    gaps = dict(r["idle_gaps"])
    # [0, 10] is launch latency; [50, 90] runs under aten::nonzero at 70
    assert gaps["aten::nonzero"] == pytest.approx(40e-6)
    assert gaps["launch gaps under 20 us"] == pytest.approx(10e-6)


def test_device_pass_is_bounded_by_its_markers():
    # no host span: the sub-window runs from the first marker's end to
    # the last marker's start, and the markers are not busy time
    ev = [_ev("kernel", "at::cuda::(anonymous namespace)::spin_kernel(long)",
              0.0, 5.0),
          _ev("cuda_runtime", "cudaLaunchKernel", 6.0, 2.0),
          _ev("kernel", "void mlp_fwd_bf16<1>(float*)", 15.0, 30.0),
          _ev("kernel", "void knn_sweep::go<4>(int)", 60.0, 40.0),
          _ev("kernel", "at::cuda::(anonymous namespace)::spin_kernel(long)",
              105.0, 5.0)]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(70e-6)
    assert [n for n, _ in r["device_ops"]] == ["knn_sweep::go",
                                                "mlp_fwd_bf16"]

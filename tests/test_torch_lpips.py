"""The port's LPIPS-AlexNet (``models/lpips.py``) and the evaluation that
reports it, against the JAX package's ``models/lpips_jax.py`` on the CPU.

Weights are ``random_params`` draws or fabricated torch files in the
layouts the lpips ecosystem ships (the pretrained ones are downloads).
Bounds: ``random_params`` and the converter's ``.npz`` bit-equal to the
JAX package's; the distance within 1e-5 absolute of
``lpips_jax.lpips_distance`` (64x64 and a non-square 72x96, three seeds),
each stage's activations within 1e-5 of the stage's largest magnitude;
``evaluate``'s LPIPS within 1e-5 of JAX ``evaluate``'s on the same
checkpoint, its PSNR and SSIM within 1e-4 as tests/test_torch_loop.py
holds them.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from animnerf_tpu_torch.models import lpips as L

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(1)

SEEDS = (0, 1, 2)
SHAPES = ((64, 64), (72, 96))


def _pair(seed: int, shape) -> tuple:
    rng = np.random.default_rng(100 + seed)
    img0 = rng.uniform(size=shape + (3,)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(scale=0.1, size=img0.shape), 0, 1
                   ).astype(np.float32)
    return img0, img1


def _cpu(params: dict) -> L.LPIPS:
    return L.LPIPS(params).eval()


def test_random_params_are_the_jax_draws():
    from animnerf_tpu.models.lpips_jax import random_params as jrp

    for seed in SEEDS:
        got, want = L.random_params(seed), jrp(seed)
        assert list(got) == list(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_distance_matches_lpips_jax(seed, shape):
    """One pair, and the same pair in a batch of two beside its swap."""
    from animnerf_tpu.models.lpips_jax import lpips_distance

    params = L.random_params(seed)
    img0, img1 = _pair(seed, shape)
    want = float(lpips_distance(params, img0, img1))
    model = _cpu(params)
    with torch.no_grad():
        got = model(L.to_batch(img0, "cpu"), L.to_batch(img1, "cpu"))
        both = model(torch.cat([L.to_batch(img0, "cpu"),
                                L.to_batch(img1, "cpu")]),
                     torch.cat([L.to_batch(img1, "cpu"),
                                L.to_batch(img0, "cpu")]))
    assert got.shape == (1,) and both.shape == (2,)
    assert want > 0
    assert abs(float(got[0]) - want) <= 1e-5, (float(got[0]), want)
    assert abs(float(both[0]) - want) <= 1e-5
    assert abs(float(both[1]) - want) <= 1e-5
    with torch.no_grad():
        same = model(L.to_batch(img0, "cpu"), L.to_batch(img0, "cpu"))
    assert abs(float(same[0])) < 1e-7


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stage_activations_match_jax(shape):
    """The five stages after their ReLU (and so the pools between them)
    against ``lpips_jax._features`` on the same scaled image."""
    from animnerf_tpu.models.lpips_jax import _features

    params = L.random_params(1)
    img, _ = _pair(1, shape)
    x = (img[None] - L.SHIFT) / L.SCALE
    want = _features(params, x)
    with torch.no_grad():
        got = _cpu(params).features(
            torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy().transpose(0, 2, 3, 1)
        w = np.asarray(w)
        assert g.shape == w.shape, i
        scale = float(np.abs(w).max())
        assert scale > 0
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, i


def _torch_files(tmp_path, seed=3):
    """torchvision's alexnet features and lpips' alex.pth heads from a
    seed, as torch tensors, and the full lpips.LPIPS state dict."""
    rng = np.random.default_rng(seed)
    alex, lin, full = {}, {}, {
        "scaling_layer.shift": torch.tensor(L.SHIFT).view(1, 3, 1, 1),
        "scaling_layer.scale": torch.tensor(L.SCALE).view(1, 3, 1, 1)}
    cin = 3
    for i, (cout, kk, _, _) in enumerate(L.ALEX_LAYERS):
        ti = L.TORCH_INDEX[i]
        w = torch.tensor(rng.normal(scale=0.05, size=(cout, cin, kk, kk))
                         .astype(np.float32))
        b = torch.tensor(rng.normal(scale=0.01, size=cout).astype(np.float32))
        h = torch.tensor(rng.uniform(0, 0.1, size=(1, cout, 1, 1))
                         .astype(np.float32))
        alex[f"features.{ti}.weight"], alex[f"features.{ti}.bias"] = w, b
        lin[f"lin{i}.model.1.weight"] = h
        full[f"net.slice{i + 1}.{ti}.weight"] = w
        full[f"net.slice{i + 1}.{ti}.bias"] = b
        full[f"lins.{i}.model.1.weight"] = h
        cin = cout
    paths = {name: str(tmp_path / f"{name}.pth")
             for name in ("alexnet", "alex", "full", "wrapped")}
    torch.save(alex, paths["alexnet"])
    torch.save(lin, paths["alex"])
    torch.save(full, paths["full"])
    torch.save({"state_dict": full, "epoch": 0}, paths["wrapped"])
    return paths


LAYOUTS = {
    # torchvision features + the package's alex.pth heads
    "torchvision": ("alexnet", "alex"),
    # one full lpips.LPIPS state dict as both arguments
    "full_module": ("full", "full"),
    # the full module's convolutions, the separate heads file
    "full_and_heads": ("full", "alex"),
    # a Lightning-style {"state_dict": ...} wrapper of the full module
    "wrapped": ("wrapped", "wrapped"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_converter_matches_jax(tmp_path, layout):
    """The port's .npz and the JAX converter's: the same keys in the same
    order, dtypes, shapes and arrays bit for bit; either package reads
    the other's file to the same distance."""
    from animnerf_tpu.models.lpips_jax import convert_torch_lpips as jconv
    from animnerf_tpu.models.lpips_jax import load_weights as jload
    from animnerf_tpu.models.lpips_jax import lpips_distance

    paths = _torch_files(tmp_path)
    a, b = (paths[n] for n in LAYOUTS[layout])
    got = L.convert_torch_lpips(a, b, str(tmp_path / "port.npz"))
    want = jconv(a, b, str(tmp_path / "jax.npz"))
    pg, pw = L.load_params(got), L.load_params(want)
    assert list(pg) == list(pw)
    for k in pw:
        assert pg[k].dtype == pw[k].dtype and pg[k].shape == pw[k].shape, k
        np.testing.assert_array_equal(pg[k], pw[k], err_msg=k)
    img0, img1 = _pair(0, (64, 64))
    d_jax = float(lpips_distance(jload(got), img0, img1))
    d_port = L.LPIPSMetric(want, "cpu")(img0, img1)
    assert abs(d_port - d_jax) <= 1e-5


def test_converter_command_line_and_missing_weights(tmp_path, capsys):
    """``python -m animnerf_tpu_torch.models.lpips``: --lin defaults to
    the --alexnet file, the output directory is made; a file without a
    stage's weights names it."""
    paths = _torch_files(tmp_path)
    out = tmp_path / "assets" / "lpips_alex.npz"
    L.main(["--alexnet", paths["full"], "--out", str(out)])
    assert str(out) in capsys.readouterr().out
    want = L.load_params(L.convert_torch_lpips(
        paths["alexnet"], paths["alex"], str(tmp_path / "split.npz")))
    got = L.load_params(str(out))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError, match="lin0"):
        L.convert_torch_lpips(paths["alexnet"], paths["alexnet"],
                              str(tmp_path / "x.npz"))
    with pytest.raises(KeyError, match="conv0"):
        L.convert_torch_lpips(paths["alex"], paths["alex"],
                              str(tmp_path / "y.npz"))


def _npz(tmp_path, seed=0) -> str:
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **L.random_params(seed))
    return path


def test_evaluator_reports_lpips_only_with_a_weights_file(tmp_path,
                                                          monkeypatch):
    """With a weights file (given, or from $ANIMNERF_LPIPS_WEIGHTS, or at
    assets/lpips_alex.npz) the evaluator reports lpips, within 1e-5 of the
    JAX Evaluator's on that file, its psnr and ssim equal; without one the
    key is left out; a file that exists but cannot be read raises. The
    convolutions leave cuDNN's TF32 setting as it was."""
    from animnerf_tpu.models.evaluator import Evaluator as JaxEvaluator
    from animnerf_tpu_torch.models.evaluator import Evaluator

    monkeypatch.delenv("ANIMNERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(40, 48, 3)).astype(np.float32)
    gt = rng.uniform(size=(40, 48, 3)).astype(np.float32)
    assert sorted(Evaluator(device="cpu")(img, gt)) == ["psnr", "ssim"]
    assert sorted(Evaluator(lpips_weights=str(tmp_path / "none.npz"),
                            device="cpu")(img, gt)) == ["psnr", "ssim"]

    npz = _npz(tmp_path)
    tf32 = torch.backends.cudnn.allow_tf32
    got = Evaluator(lpips_weights=npz, device="cpu")(img, gt)
    assert torch.backends.cudnn.allow_tf32 == tf32
    want = JaxEvaluator(lpips_weights=npz)(img, gt)
    assert sorted(got) == sorted(want) == ["lpips", "psnr", "ssim"]
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5 and got["lpips"] > 0
    assert not Evaluator(use_lpips=False, lpips_weights=npz,
                         device="cpu")(img, gt).get("lpips")

    monkeypatch.setenv("ANIMNERF_LPIPS_WEIGHTS", npz)
    assert Evaluator(device="cpu")(img, gt)["lpips"] == got["lpips"]
    monkeypatch.delenv("ANIMNERF_LPIPS_WEIGHTS")
    os.makedirs("assets")
    os.rename(npz, os.path.join("assets", "lpips_alex.npz"))
    assert Evaluator(device="cpu")(img, gt)["lpips"] == got["lpips"]

    bad = tmp_path / "corrupt.npz"
    bad.write_bytes(b"not an npz file")
    with pytest.raises(Exception):
        Evaluator(lpips_weights=str(bad), device="cpu")
    partial = str(tmp_path / "partial.npz")
    params = L.random_params(0)
    params.pop("lin4_w")
    np.savez(partial, **params)
    with pytest.raises(KeyError):
        Evaluator(lpips_weights=partial, device="cpu")


SIZE = 32  # the smallest images LPIPS-AlexNet takes are ~31 pixels


def _opts(root, out):
    return ["root_dir", root, "model_path", os.path.join(root, "models"),
            "gender", "neutral", "n_samples", "8", "n_importance", "4",
            "freqs_xyz", "4", "img_wh", f"({SIZE},{SIZE})",
            "exp_name", "lp", "checkpoints_dir", os.path.join(out, "ck"),
            "logs_dir", os.path.join(out, "lg"),
            "outputs_dir", os.path.join(out, "outputs"),
            "train.frame_start_ID", "1", "train.frame_end_ID", "2",
            "train.frame_skip", "1", "train.subsamplesize", "4",
            "train.batch_size", "2", "train.max_steps", "1",
            "train.log_every", "1", "val.frame_start_ID", "3",
            "val.frame_end_ID", "3", "val.frame_skip", "1",
            "test.frame_start_ID", "3", "test.frame_end_ID", "4",
            "test.frame_skip", "1"]


def test_evaluate_test_cli_and_parity_check_report_lpips(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """On a 32x32 synthetic dataset and a one-step ``fit`` checkpoint with
    $ANIMNERF_LPIPS_WEIGHTS set: ``evaluate`` on the CPU gives JAX
    ``evaluate``'s lpips within 1e-5 (psnr, ssim within 1e-4), the test
    CLI prints it, ``parity_check --ref_lpips`` reports lpips_ref and
    lpips_delta beside psnr's, and ``evaluate``'s stats time the scores;
    without the variable the key is gone again."""
    import jax

    from animnerf_tpu.config import finalize as jax_finalize
    from animnerf_tpu.config import get_default_config as jax_cfg
    from animnerf_tpu.training.loop import evaluate as jax_evaluate
    from animnerf_tpu_torch.cli import test as test_cli
    from animnerf_tpu_torch.config import finalize, get_default_config
    from animnerf_tpu_torch.data.synthetic import write_synthetic_dataset
    from animnerf_tpu_torch.tools import parity_check as PC
    from animnerf_tpu_torch.training import loop as TL

    root = str(tmp_path / "ds")
    write_synthetic_dataset(root, num_frames=4, img_wh=(SIZE, SIZE),
                            num_verts=128, num_joints=8, seed=7)
    out = str(tmp_path / "out")
    cfg = get_default_config()
    cfg.merge_from_list(_opts(root, out))
    cfg = finalize(cfg)
    last = os.path.join(TL.fit(cfg, device="cpu"), "last")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ANIMNERF_LPIPS_WEIGHTS", _npz(tmp_path, seed=4))

    jcfg = jax_cfg()
    jcfg.merge_from_list(_opts(root, out))
    want = jax_evaluate(jax_finalize(jcfg), last)
    jax.clear_caches()
    stats: dict = {}
    got = TL.evaluate(cfg, last, device="cpu", stats=stats)
    assert sorted(got) == sorted(want) == ["lpips", "psnr", "ssim"]
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5 and got["lpips"] > 0
    for k in ("psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-4, k
    assert len(stats["score_s"]) == len(stats["frame_s"]) == 2
    capsys.readouterr()
    means = test_cli.main(["--ckpt_path", last, "--device", "cpu"])
    assert means == got
    assert f"lpips: {got['lpips']:.4f}" in capsys.readouterr().out

    PC.main(["--data_dir", root, "--smpl_pkl", os.path.join(root, "models"),
             "--ckpt", last, "--ref_psnr", "12.0", "--ref_lpips", "0.25",
             "--out_dir", str(tmp_path / "parity"), "--device", "cpu"])
    printed = capsys.readouterr().out
    report = json.loads(printed[printed.index("{"):printed.rindex("}") + 1])
    assert report["lpips"] == got["lpips"]
    assert report["lpips_ref"] == 0.25
    assert report["lpips_delta"] == pytest.approx(got["lpips"] - 0.25)
    assert report["psnr_delta"] == pytest.approx(got["psnr"] - 12.0)

    monkeypatch.delenv("ANIMNERF_LPIPS_WEIGHTS")
    assert sorted(TL.evaluate(cfg, last, device="cpu")) == ["psnr", "ssim"]

"""One-command real-data parity check — counterpart of
``animnerf_tpu/tools/parity_check.py``.

Takes the three assets a user of the reference has on disk (a prepared
People-Snapshot data dir, the SMPL model pkl, a trained reference
Lightning ``.ckpt``), converts the checkpoint without torch's unpickler
(``tools/convert_checkpoint.py``), evaluates the split with the port's
``training/loop.py::evaluate`` (on the card unless ``--device cpu``) and
prints the PSNR / SSIM / LPIPS means and their deltas against the
reference's printed numbers (reference test.py:91-93). LPIPS is in the
report where its weights file exists (``$ANIMNERF_LPIPS_WEIGHTS`` or
``assets/lpips_alex.npz``, made by ``python -m
animnerf_tpu_torch.models.lpips``); without it the report has no
``lpips`` key.

    python -m animnerf_tpu_torch.tools.parity_check \
        --data_dir data/male-3-casual \
        --smpl_pkl smplx/models/smpl/SMPL_MALE.pkl \
        --ckpt checkpoints/male-3-casual/last.ckpt \
        --cfg_file configs/people_snapshot/male-3-casual.yaml \
        --ref_psnr 29.47
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from animnerf_tpu_torch.cli.common import resolve_cfg
from animnerf_tpu_torch.tools.convert_checkpoint import convert
from animnerf_tpu_torch.training.loop import evaluate
from animnerf_tpu_torch.utils.device import DeviceLike


def run_parity_check(data_dir: str, smpl_pkl: str, ckpt: str,
                     cfg_file: str | None = None, opts: list | None = None,
                     ref_psnr: float | None = None,
                     ref_ssim: float | None = None,
                     ref_lpips: float | None = None, split: str = "test",
                     out_dir: str | None = None, vis: bool = False,
                     device: DeviceLike = None) -> dict:
    """Convert -> evaluate -> report: the metric means, with ``<m>_ref``
    and ``<m>_delta`` for each reference number given and
    ``psnr_within_0.1dB`` with a PSNR reference."""
    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="animnerf_parity_")
    conv_dir = ckpt
    if not os.path.isdir(ckpt):  # a Lightning .ckpt file: convert it first
        conv_dir = os.path.join(out_dir, "converted_ckpt")
        convert(ckpt, conv_dir)

    # the checkpoint's hyper-parameters, then the YAML, then the options,
    # the asset paths of this machine winning over the reference run's
    cfg = resolve_cfg(conv_dir, cfg_file, list(opts or []) + [
        "root_dir", data_dir,
        "model_path", _model_root(smpl_pkl),
        "outputs_dir", out_dir,
    ])
    means = evaluate(cfg, conv_dir, split=split, save_vis=vis,
                     out_dir=os.path.join(out_dir, "vis"), device=device)
    report = {k: float(v) for k, v in means.items()}
    for name, ref in (("psnr", ref_psnr), ("ssim", ref_ssim),
                      ("lpips", ref_lpips)):
        if ref is not None and name in report:
            report[f"{name}_ref"] = float(ref)
            report[f"{name}_delta"] = report[name] - float(ref)
    if "psnr_delta" in report:
        report["psnr_within_0.1dB"] = bool(abs(report["psnr_delta"]) <= 0.1)
    return report


def _model_root(smpl_pkl: str) -> str:
    """The model root of a concrete pkl path: the loader takes the pkl
    itself or a smplx-style ``models/`` root, so a pkl under
    ``.../smpl/`` (or smplh, smplx, mano, flame) gives that root, any
    other pkl itself."""
    if os.path.isdir(smpl_pkl):
        return smpl_pkl
    parent = os.path.dirname(os.path.abspath(smpl_pkl))
    if os.path.basename(parent) in ("smpl", "smplh", "smplx", "mano",
                                    "flame"):
        return os.path.dirname(parent)
    return smpl_pkl


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True,
                   help="prepared People-Snapshot dir (cam000/, smpls/, ...)")
    p.add_argument("--smpl_pkl", required=True,
                   help="SMPL model pkl (or smplx models/ root)")
    p.add_argument("--ckpt", required=True,
                   help="reference Lightning .ckpt (converted first) or a "
                        "converted checkpoint dir")
    p.add_argument("--cfg_file", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--ref_psnr", type=float, default=None,
                   help="the reference test.py's printed mean PSNR")
    p.add_argument("--ref_ssim", type=float, default=None)
    p.add_argument("--ref_lpips", type=float, default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--vis", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    report = run_parity_check(
        args.data_dir, args.smpl_pkl, args.ckpt, cfg_file=args.cfg_file,
        opts=args.opts, ref_psnr=args.ref_psnr, ref_ssim=args.ref_ssim,
        ref_lpips=args.ref_lpips, split=args.split, out_dir=args.out_dir,
        vis=args.vis, device=args.device)
    print(json.dumps(report, indent=2, sort_keys=True))
    if "psnr_delta" in report:
        verdict = "PASS" if report["psnr_within_0.1dB"] else "FAIL"
        print(f"PSNR delta vs reference: {report['psnr_delta']:+.3f} dB "
              f"[{verdict} at 0.1 dB]")


if __name__ == "__main__":
    main()

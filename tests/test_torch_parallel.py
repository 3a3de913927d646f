"""The port's data parallelism (``animnerf_tpu_torch/parallel/``) on the
CPU: gloo in 2-4 spawned processes (a ``file://`` rendezvous under the
test's temporary directory, one thread each), against the one-process
step and against the JAX package's sharded steps at ``make_mesh(2)``.

The setup is ``tests/test_parallel.py``'s (``_tiny_setup``: the tiny
flagship rig, B = 8 rows of 32 rays), its parameters drawn by the JAX
package and converted (``utils/convert.py::params_from_jax``). The
spawned ranks import neither JAX nor the JAX package: the parent writes
their inputs (numpy batches, converted parameters, noise drawn along the
JAX key path) to a pickle. Every spawned run has its own time limit
(``SPAWN_TIMEOUT``), so a hung collective fails its test.

Bounds: SGD-momentum after three steps, world 2 and 4 against world 1
within max |d param| 1e-5 (``test_train_1dev_vs_8dev_param_equivalence_sgd``'s
bound), world 2 against JAX's ``make_sharded_train_step`` within loss
rtol 5e-5 and params rtol 1e-4 / atol 1e-6 (``test_torch_train_sgd.py``);
Adam's first gradients, world 2 against world 1, within rel-L2 1e-3 (JAX's
2-vs-8 bound); the replicas and each rank's noise rows bit-equal; the
sharded evaluation against JAX's at ``make_mesh(2)``: the coarse outputs
within atol / rtol 1e-5 (``test_sharded_eval_matches_single_device``),
the fine outputs within ``tests/test_torch_dense_render.py``'s f32 bound
(atol 1e-4, depths 5e-4): at random weights the fine pass's inverse-CDF
sampling amplifies the two packages' f32 roundings past 1e-5, a
difference that is there in one process too; the sharded evaluation and
``Renderer(mesh=)`` bit-equal to the one-process ones.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

sys.path.insert(0, os.path.dirname(__file__))

from animnerf_tpu_torch.parallel import mesh as PM  # noqa: E402
from animnerf_tpu_torch.parallel import train_pjit as PP  # noqa: E402
from animnerf_tpu_torch.training import loop as TL  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, R, STEPS, KEY = 8, 32, 3, 7
SPAWN_TIMEOUT = 240  # seconds a spawned run may take, start-up included
SGD = {"type": "sgd", "momentum": 0.9}


# ------------------------------------------------------------ the ranks

def _child(rank, world, init, out, task, inputs):
    """One spawned rank: join the gloo group, run the task, pickle what it
    returns."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        res = TASKS[task](inp)
        with open(os.path.join(out, f"{task}-{world}-{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(task: str, world: int, inputs: str, tmp_dir,
          timeout: float = SPAWN_TIMEOUT) -> list:
    """TASKS[task] on ``world`` gloo ranks -> each rank's result. A rank
    that raises, or a run past ``timeout``, fails the test."""
    out = str(tmp_dir)
    init = f"file://{os.path.join(out, f'rdv-{task}-{world}')}"
    ctx = tmp.start_processes(_child, args=(world, init, out, task, inputs),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            ctx.join(timeout=10)
            pytest.fail(f"{task} on {world} ranks ran past {timeout} s")
    res = []
    for r in range(world):
        with open(os.path.join(out, f"{task}-{world}-{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _system(inp: dict, optimizer: dict = None):
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.system import AnimNeRFSystem

    cfg = dict(inp["cfg"], pose_dim=3 * (inp["nj"] - 1))
    if optimizer is not None:
        cfg["train"] = dict(cfg["train"], optimizer=optimizer)
    system = AnimNeRFSystem(cfg, make_body_model(128, inp["nj"], seed=0),
                            device="cpu")
    system.load_params(inp["params"])
    return system


def _params(system) -> dict:
    return {k: v.detach().clone() for k, v in system.named_parameters()}


def _grads(system) -> dict:
    return {k: None if v.grad is None else v.grad.detach().clone()
            for k, v in system.named_parameters()}


def _train_task(inp: dict) -> dict:
    """On this process's mesh (all ranks; one process without a group):
    the engine ``auto`` picks (rows-compacted) with SGD-momentum for
    STEPS steps on the trainer's own noise (step 1's noise rows kept);
    one Adam step's averaged gradients; the dense step
    (``make_sharded_train_step``) with SGD-momentum on the JAX noise;
    the sharded evaluation at R and at R - 1 rays (padded);
    ``Renderer(mesh=)`` on R - 1 rays."""
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.training.system import make_optimizer

    mesh = PM.make_mesh(device="cpu")
    res = {"rank": mesh.rank, "size": mesh.size}

    system = _system(inp, SGD)
    opt, sched = make_optimizer(system, 10)
    step, place_state, place_batch = PP.make_sharded_trainer(
        system, opt, sched, mesh)
    trainer = step.__self__
    seen = []
    loss_fn = trainer.loss_fn

    def capture(system, batch, noise):
        seen.append(noise)
        return loss_fn(system, batch, noise)

    trainer.loss_fn = capture
    place_state(system)
    res["sgd_losses"] = [float(step(place_batch(b))["loss"])
                         for b in inp["batches"]]
    res["sgd_params"] = _params(system)
    res["noise_rows"] = seen[0]

    system = _system(inp)
    opt, sched = make_optimizer(system, 10)
    step, place_state, place_batch = PP.make_sharded_trainer(
        system, opt, sched, mesh)
    place_state(system)
    res["adam_details"] = step(place_batch(inp["batches"][0]))
    res["adam_grads"] = _grads(system)

    system = _system(inp, SGD)
    opt, sched = make_optimizer(system, 10)
    step, place_state, place_batch = PP.make_sharded_train_step(
        system, opt, sched, mesh)
    place_state(system)
    res["dense_losses"] = [float(step(place_batch(b), n)["loss"])
                           for b, n in zip(inp["batches"], inp["noise"])]
    res["dense_params"] = _params(system)

    system = _system(inp)
    eval_step = PP.make_sharded_eval_step(system, mesh)
    b = inp["batches"][0]
    res["eval"] = {k: v.numpy() for k, v in eval_step(b).items()}
    cut = {k: v[:, :R - 1] if k in PM.RAY_KEYS else v for k, v in b.items()}
    res["eval_padded"] = {k: v.numpy() for k, v in eval_step(cut).items()}
    f = inp["frame"]
    res["view"] = Renderer(system, mesh=mesh).render_frame(
        f["body_params"], f["body_tmpl"], f["rays"])
    return res


def _fit_task(inp: dict) -> dict:
    """fit on a batch that splits over fewer ranks than the world, then
    evaluate over every rank."""
    mesh = PM.mesh_for_batch(inp["cfg"].train.batch_size, "cpu")
    ckpt = TL.fit(inp["cfg"], device="cpu")
    means = TL.evaluate(inp["cfg"], os.path.join(ckpt, "last"),
                        device="cpu")
    return {"active": mesh.active, "rank": mesh.rank, "size": mesh.size,
            "means": means}


def _visible_task(inp: dict) -> dict:
    """check_visible on a path every rank sees, then on one that only
    rank 0 sees -> what each raised."""
    mesh = PM.make_mesh(device="cpu")
    PM.check_visible(mesh, inp["shared"])
    try:
        PM.check_visible(mesh, inp["shared"] if mesh.rank == 0
                         else inp["missing"])
    except FileNotFoundError as e:
        return {"raised": str(e)}
    return {"raised": None}


TASKS = {"train": _train_task, "fit": _fit_task, "visible": _visible_task}


# --------------------------------------------------------------- inputs

def _plain(d):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in d.items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The tiny setup, its JAX-drawn parameters converted, three batches,
    the global noise of each step along the JAX key path, and one frame
    for the renderer, pickled for the ranks."""
    import jax

    from test_parallel import _tiny_setup
    from test_torch_split_render import jax_noise

    from animnerf_tpu.models.body_params import init_body_params
    from animnerf_tpu.utils import rng as prng
    from animnerf_tpu_torch.utils.convert import params_from_jax

    cfg, system, nj, _ = _tiny_setup()
    state = system.init_state(
        jax.random.PRNGKey(0),
        init_body_params(cfg.num_frames, pose_dim=3 * (nj - 1)),
        steps_per_epoch=10)
    params = jax.tree.map(np.array, state.params)
    batches = [_tiny_setup(seed=s)[3] for s in range(STEPS)]
    key = jax.random.PRNGKey(KEY)
    noise = [jax_noise(prng.elem_keys(jax.random.fold_in(key, i), B), B, R,
                       cfg.n_samples, cfg.n_importance, 0, 128)
             for i in range(STEPS)]
    b = batches[0]
    frame = {"body_params": {k: b[k][:1] for k in
                             ("global_orient", "body_pose", "betas",
                              "transl")},
             "body_tmpl": {k: b[k + "_template"][:1] for k in
                           ("global_orient", "body_pose", "betas",
                            "transl")},
             "rays": b["rays"][0, :R - 1]}
    inp = {"cfg": _plain(cfg), "nj": nj, "params": params_from_jax(params),
           "batches": batches, "noise": noise, "frame": frame}
    path = tmp_path_factory.mktemp("parallel") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return {"path": str(path), "inp": inp, "jax_cfg": cfg, "jax_system":
            system, "jax_params": params}


@pytest.fixture(scope="module")
def one(inputs):
    """The train task in this process: a mesh of one."""
    return _train_task(inputs["inp"])


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The train task on 2 and on 4 gloo ranks."""
    d = tmp_path_factory.mktemp("ranks")
    return {n: spawn("train", n, inputs["path"], d) for n in (2, 4)}


# ---------------------------------------------------------------- tests

def _max_abs(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("n", [2, 4])
def test_sgd_trajectory_over_ranks_matches_one_process(one, world, n):
    """Three SGD-momentum steps of the rows-compacted engine on n ranks:
    every parameter within 1e-5 of one process, each step's mean loss
    within rtol 1e-5."""
    ranks = world[n]
    assert [r["rank"] for r in ranks] == list(range(n))
    assert all(r["size"] == n for r in ranks)
    assert one["size"] == 1
    np.testing.assert_allclose(ranks[0]["sgd_losses"], one["sgd_losses"],
                               rtol=1e-5)
    assert _max_abs(ranks[0]["sgd_params"], one["sgd_params"]) <= 1e-5


@pytest.mark.parametrize("n", [2, 4])
def test_replicas_bit_equal_across_ranks(world, n):
    """After the SGD steps, the Adam step and the dense steps every rank
    holds the same parameters, gradients and details, bit for bit."""
    ranks = world[n]
    for r in ranks[1:]:
        for key in ("sgd_params", "dense_params", "adam_grads"):
            for k, v in ranks[0][key].items():
                assert torch.equal(v, r[key][k]), (key, k)
        assert r["sgd_losses"] == ranks[0]["sgd_losses"]
        assert r["dense_losses"] == ranks[0]["dense_losses"]
        assert {k: float(v) for k, v in r["adam_details"].items()} == {
            k: float(v) for k, v in ranks[0]["adam_details"].items()}


@pytest.mark.parametrize("n", [2, 4])
def test_rank_noise_rows_bit_equal_to_one_process_draw(one, world, n):
    """Each rank's noise is its rows of the one-process draw (every field
    of TrainNoise, the (B, V, 3) normal jitters included)."""
    full = one["noise_rows"]
    for rank, r in enumerate(world[n]):
        mine = r["noise_rows"]
        for f in ("coarse_u", "fine_u", "sigma_c", "sigma_f", "normal_pts",
                  "normal_nbr"):
            want = getattr(full, f)[rank * B // n:(rank + 1) * B // n]
            assert torch.equal(getattr(mine, f), want), (rank, f)
            assert getattr(mine, f).shape[0] == B // n


def test_adam_gradients_world_2_match_world_1(one, world):
    """The averaged gradients of the first Adam step on two ranks within
    rel-L2 1e-3 of one process (gradient by gradient), the mean loss
    terms within rtol 1e-5, ``compact_count`` (the largest row's
    survivors) the largest of the ranks', so one process's. (``psnr`` is
    the mean of the shards' PSNRs, as JAX's pmean of the details gives it,
    not the PSNR of the whole batch.)"""
    g2, g1 = world[2][0]["adam_grads"], one["adam_grads"]
    assert sorted(g2) == sorted(g1)
    for k in g1:
        if g1[k] is None:
            assert g2[k] is None, k
            continue
        den = float(g1[k].double().norm())
        num = float((g2[k].double() - g1[k].double()).norm())
        assert num <= 1e-3 * den or num < 1e-9, (k, num, den)
    d2, d1 = world[2][0]["adam_details"], one["adam_details"]
    assert sorted(d2) == sorted(d1)
    assert isinstance(d2["compact_count"], int)
    assert d2["compact_count"] == d1["compact_count"] > 0
    for k in d1:
        if k.startswith("loss"):
            np.testing.assert_allclose(float(d2[k]), float(d1[k]),
                                       rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_sgd(inputs):
    """Three steps of JAX's make_sharded_train_step on make_mesh(2) with
    SGD-momentum from the same parameters and batches."""
    import jax

    from test_parallel import _tiny_setup

    from animnerf_tpu.models.body_params import init_body_params
    from animnerf_tpu.parallel.mesh import make_mesh
    from animnerf_tpu.parallel.train_pjit import make_sharded_train_step
    from animnerf_tpu.training.system import AnimNeRFSystem as JSys

    cfg, system, nj, _ = _tiny_setup()
    cfg.train.optimizer.type = "sgd"
    cfg.train.optimizer.momentum = 0.9
    system = JSys(cfg, system.body_model)
    state = system.init_state(
        jax.random.PRNGKey(0),
        init_body_params(cfg.num_frames, pose_dim=3 * (nj - 1)),
        steps_per_epoch=10)
    tx = system.make_optimizer(steps_per_epoch=10)
    step, place_state, place_batch = make_sharded_train_step(
        system, tx, make_mesh(2))
    state = place_state(state)
    losses = []
    for b in inputs["inp"]["batches"]:
        state, d = step(state, place_batch(b), jax.random.PRNGKey(KEY))
        losses.append(float(d["loss"]))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    jax.clear_caches()
    return losses, params


def test_sgd_world_2_matches_jax_sharded_train_step(inputs, world, jax_sgd):
    """The port's dense step on two ranks with the JAX noise against JAX's
    make_sharded_train_step on make_mesh(2): each step's loss within rtol
    5e-5, every parameter within rtol 1e-4 / atol 1e-6."""
    from animnerf_tpu_torch.utils.convert import params_from_jax

    losses, jparams = jax_sgd
    r = world[2][0]
    np.testing.assert_allclose(r["dense_losses"], losses, rtol=5e-5)
    want = _system(inputs["inp"])
    want.load_params(params_from_jax(jparams))
    got = r["dense_params"]
    for k, v in want.named_parameters():
        np.testing.assert_allclose(got[k].numpy(), v.detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_sharded_eval_matches_jax_sharded_eval(inputs, one, world):
    """make_sharded_eval_step on two ranks against JAX's on make_mesh(2)
    (its rows path, kernels in interpret mode): the coarse outputs within
    atol / rtol 1e-5, the fine ones within atol 1e-4 (depths 5e-4); and
    bit-equal to the port's one-process evaluation."""
    import jax

    from test_rows_pipeline import rows_path_forced

    from animnerf_tpu.parallel.mesh import make_mesh
    from animnerf_tpu.parallel.train_pjit import make_sharded_eval_step

    system = inputs["jax_system"]
    with rows_path_forced():
        system.scene.__dict__["use_fused_mlp"] = True
        try:
            ref = make_sharded_eval_step(system, make_mesh(2))(
                jax.tree.map(np.array, inputs["jax_params"]),
                dict(inputs["inp"]["batches"][0]))
            ref = {k: np.asarray(v) for k, v in ref.items()}
        finally:
            system.scene.__dict__.pop("use_fused_mlp", None)
    jax.clear_caches()
    got = world[2][0]["eval"]
    assert sorted(got) == sorted(ref)
    for k in ref:
        fine = k.endswith("_fine")
        atol = (5e-4 if k.startswith("depths") else 1e-4) if fine else 1e-5
        np.testing.assert_allclose(got[k], ref[k], atol=atol,
                                   rtol=0 if fine else 1e-5, err_msg=k)
    for n in (2, 4):
        for r in world[n]:
            for k, v in one["eval"].items():
                np.testing.assert_array_equal(r["eval"][k], v, k)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_eval_pads_the_rays(one, world, n):
    """R - 1 rays on n ranks: padded to a multiple of n by repeating the
    last ray, the padding trimmed, the outputs bit-equal to one
    process's."""
    for r in world[n]:
        for k, v in one["eval_padded"].items():
            assert v.shape[1] == R - 1
            np.testing.assert_array_equal(r["eval_padded"][k], v, k)


@pytest.mark.parametrize("n", [2, 4])
def test_renderer_mesh_matches_one_process_dense_render(inputs, world, n):
    """Renderer(mesh=) on n ranks against the one-process
    Renderer(compact_samples=False, cull_rays=False): image, mask and
    depth bit-equal on every rank."""
    from animnerf_tpu_torch.render.inference import Renderer

    f = inputs["inp"]["frame"]
    want = Renderer(_system(inputs["inp"]), device="cpu",
                    compact_samples=False, cull_rays=False).render_frame(
        f["body_params"], f["body_tmpl"], f["rays"])
    for r in world[n]:
        for a, b in zip(r["view"], want):
            np.testing.assert_array_equal(a, b)


def test_renderer_mesh_turns_compaction_and_the_cull_off(inputs):
    """Under a mesh of several ranks the renderer takes the dense route
    without the cull, on the mesh's device; a mesh of one changes
    nothing."""
    from animnerf_tpu_torch.render.inference import Renderer

    system = _system(inputs["inp"])
    two = PM.Mesh(None, 0, 2, torch.device("cpu"))
    r = Renderer(system, mesh=two)
    assert not r.compact_samples and not r.cull_rays
    assert r.device.type == "cpu" and r.mesh is two
    r = Renderer(system, mesh=PM.make_mesh(device="cpu"))
    assert r.compact_samples and r.cull_rays and r.mesh is None


# ------------------------------------------- fit and the torchrun start-up

NJ, NV, SIZE = 8, 128, 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from animnerf_tpu_torch.data.synthetic import write_synthetic_dataset

    root = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_dataset(root, num_frames=4, img_wh=(SIZE, SIZE),
                            num_verts=NV, num_joints=NJ, seed=7)
    return root


def _opts(root, out, exp, batch=2, *extra):
    return ["root_dir", root, "model_path", os.path.join(root, "models"),
            "gender", "neutral", "n_samples", "8", "n_importance", "4",
            "freqs_xyz", "4", "img_wh", f"({SIZE},{SIZE})", "exp_name", exp,
            "checkpoints_dir", os.path.join(out, "ck"),
            "logs_dir", os.path.join(out, "lg"),
            "train.frame_start_ID", "1", "train.frame_end_ID", "2",
            "train.frame_skip", "1", "train.subsamplesize", "4",
            "train.batch_size", str(batch), "train.max_steps", "3",
            "train.log_every", "1", "train.optimizer.type", "sgd",
            "val.frame_start_ID", "3", "val.frame_end_ID", "3",
            "val.frame_skip", "1", "test.frame_start_ID", "3",
            "test.frame_end_ID", "4", "test.frame_skip", "1", *extra]


def _cfg(*args):
    from animnerf_tpu_torch.config import finalize, get_default_config

    cfg = get_default_config()
    cfg.merge_from_list(_opts(*args))
    return finalize(cfg)


def _logged_losses(cfg) -> list:
    path = os.path.join(cfg.logs_dir, cfg.exp_name, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["train/loss"]) for r in rows if "train/loss" in r]


def _npz(path: str) -> dict:
    out = {}
    for name in ("anim_nerf", "body_params"):
        with np.load(os.path.join(path, f"{name}.npz")) as d:
            out.update({f"{name}:{k}": d[k] for k in d.files})
    return out


def test_mesh_for_batch_leaves_a_rank_idle(dataset, tmp_path):
    """A batch of 2 on 3 ranks: fit trains on the first two (the third's
    mesh is inactive and it waits at the end), rank 0 writes ``last``,
    evaluate then runs on all three and returns the same means on each,
    and every rank leaves the group cleanly."""
    cfg = _cfg(dataset, str(tmp_path), "idle")
    path = tmp_path / "fit.pkl"
    with open(path, "wb") as f:
        pickle.dump({"cfg": cfg}, f)
    ranks = spawn("fit", 3, str(path), tmp_path)
    assert [(r["active"], r["rank"], r["size"]) for r in ranks] == [
        (True, 0, 2), (True, 1, 2), (False, -1, 2)]
    assert ranks[0]["means"] and all(np.isfinite(list(
        ranks[0]["means"].values())))
    assert all(r["means"] == ranks[0]["means"] for r in ranks)
    assert os.path.isfile(os.path.join(cfg.checkpoints_dir, "idle", "last",
                                       "anim_nerf.npz"))
    assert [s for s, _ in _logged_losses(cfg)] == [1, 2, 3]


def test_torchrun_cli_train_matches_one_process_fit(dataset, tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m
    animnerf_tpu_torch.cli.train --device cpu`` with SGD-momentum: one
    ``last`` and one log line a step, written by rank 0; its logged losses
    within rtol 5e-5 and its ``last`` within rtol 1e-4 / atol 1e-6 of a
    one-process fit of the same steps."""
    two = _cfg(dataset, str(tmp_path / "two"), "tr")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "animnerf_tpu_torch.cli.train",
         "--device", "cpu", *_opts(dataset, str(tmp_path / "two"), "tr")],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("trainer engine: rows") == 1
    assert "mesh=2dev, backend=gloo" in r.stdout
    one = _cfg(dataset, str(tmp_path / "one"), "tr")
    TL.fit(one, device="cpu")
    got, want = _logged_losses(two), _logged_losses(one)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=5e-5)
    ck = os.path.join(two.checkpoints_dir, "tr")
    assert sorted(os.listdir(ck)).count("last") == 1
    a = _npz(os.path.join(ck, "last"))
    b = _npz(os.path.join(one.checkpoints_dir, "tr", "last"))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------ the helpers

def test_one_process_mesh():
    """Without a process group: a mesh of one on the asked device; a mesh
    over several devices raises; mesh_for_batch gives the mesh of one."""
    assert not dist.is_initialized()
    m = PM.make_mesh(device="cpu")
    assert (m.group, m.rank, m.size, m.device.type) == (None, 0, 1, "cpu")
    assert m.active and m.is_main
    assert PM.mesh_for_batch(7, "cpu").size == 1
    with pytest.raises(ValueError, match="process group"):
        PM.make_mesh(2, device="cpu")


def test_shard_batch_and_padding_match_the_jax_layout():
    """shard_batch's rows (axis "batch") and ray shards (axis "rays")
    against numpy slicing, pad_rays_for_mesh against the JAX package's
    (edge padding, the unpadded length)."""
    from animnerf_tpu.parallel.mesh import make_mesh
    from animnerf_tpu.parallel.mesh import pad_rays_for_mesh as jax_pad

    rng = np.random.default_rng(0)
    batch = {"rays": rng.normal(size=(4, 6, 8)).astype(np.float32),
             "rgbs": rng.normal(size=(4, 6, 3)).astype(np.float32),
             "frame_idx": np.arange(4), "scale": np.float32(2.0)}
    for rank in range(2):
        m = PM.Mesh(None, rank, 2, torch.device("cpu"))
        rows = PM.shard_batch(m, batch)
        for k in ("rays", "rgbs", "frame_idx"):
            np.testing.assert_array_equal(rows[k].numpy(),
                                          batch[k][2 * rank:2 * rank + 2])
        assert float(rows["scale"]) == 2.0
        rays = PM.shard_batch(m, batch, axis="rays")
        np.testing.assert_array_equal(rays["rays"].numpy(),
                                      batch["rays"][:, 3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(rays["frame_idx"].numpy(),
                                      batch["frame_idx"])
    for n in (2, 4, 5):
        m = PM.Mesh(None, 0, n, torch.device("cpu"))
        got, k = PM.pad_rays_for_mesh(batch["rays"], m)
        want, kj = jax_pad(batch["rays"], make_mesh(n))
        assert k == kj == 6
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="split"):
        PM.shard_batch(PM.Mesh(None, 0, 3, torch.device("cpu")), batch)


def test_pad_rays_for_mesh_pads_tensors_as_arrays():
    """The one padding of the sharded evaluation and of Renderer(mesh=):
    a tensor padded as its numpy array, on its device, and gather_rays
    trims the padding."""
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    for n in (1, 2, 3, 5):
        m = PM.Mesh(None, 0, n, torch.device("cpu"))
        got, k = PM.pad_rays_for_mesh(torch.from_numpy(x), m)
        want, kn = PM.pad_rays_for_mesh(x, m)
        assert k == kn == 5 and got.shape[1] % n == 0
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want[:, 5:], np.repeat(
            x[:, 4:5], want.shape[1] - 5, axis=1))
        np.testing.assert_array_equal(
            PM.gather_rays(m, got, k).numpy(), x)


def test_check_visible_raises_on_every_rank(tmp_path):
    """A checkpoint that one rank cannot see: every rank raises together
    (none waits in a collective); a path every rank sees passes."""
    (tmp_path / "shared").mkdir()
    path = tmp_path / "visible.pkl"
    with open(path, "wb") as f:
        pickle.dump({"shared": str(tmp_path / "shared"),
                     "missing": str(tmp_path / "missing")}, f)
    ranks = spawn("visible", 2, str(path), tmp_path)
    assert all(r["raised"] and "every rank" in r["raised"] for r in ranks)


def test_init_distributed_needs_torchrun_and_nccl(monkeypatch):
    """Without torchrun's environment it raises; on the card without NCCL
    it raises rather than falling back to gloo."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        PM.init_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        PM.init_distributed()
    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    assert not PM.distributed_requested()
    monkeypatch.setenv("ANIMNERF_MULTIHOST", "1")
    assert PM.distributed_requested()

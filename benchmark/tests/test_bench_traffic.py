"""The traffic kinds' generators are deterministic for each seed: the
same seed gives the same inputs, another seed the same work in another
order."""

import numpy as np
import torch

from harness import rig
from harness.manifest import Bench
from kinds import train, view
from reference import body


def _pool(root, seed):
    b = Bench(root)
    c = b.config("tiny")
    r = body.Rig(rig.config_rig(c), c["model_type"], "cpu")
    return train.train_pool(b.traffic("tiny_train"), c, r, seed, "cpu")


def test_train_pool_deterministic(tiny):
    big = 2 ** 31 + 11
    a, b, c = _pool(tiny, big), _pool(tiny, big), _pool(tiny, 5)
    assert a["order"] == b["order"]
    for x, y in zip(a["batches"], b["batches"]):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    # another seed: the same pool of rays, in the seed's order
    rays = lambda p: sorted(tuple(bb["rays"].flatten()[:8].tolist())
                            for bb in p["batches"])
    assert rays(a) == rays(c)
    assert not all(torch.equal(x["rgbs"], y["rgbs"])
                   for x, y in zip(a["batches"], c["batches"]))
    # patches sit on the body: some alpha targets are set
    assert all(float(bb["alphas"].sum()) > 0 for bb in a["batches"])
    n1 = train.draw_noise(a["generator"], 2, 16, Bench(tiny).config(
        "tiny"), 300, "cpu")
    n2 = train.draw_noise(b["generator"], 2, 16, Bench(tiny).config(
        "tiny"), 300, "cpu")
    assert all(torch.equal(n1[k], n2[k]) for k in n1)


def test_view_stream_deterministic(tiny):
    b = Bench(tiny)
    c = b.config("tiny")
    t = b.traffic("tiny_view")
    s1 = view.view_stream(t, c, 2 ** 31 + 3, tiny)
    s2 = view.view_stream(t, c, 2 ** 31 + 3, tiny)
    assert (s1["first"], s1["check"]) == (s2["first"], s2["check"])
    assert np.array_equal(s1["rays"], s2["rays"])
    for k in s1["body_params"]:
        assert np.array_equal(s1["body_params"][k], s2["body_params"][k])
    assert len(s1["check"]) == t["check_views"]

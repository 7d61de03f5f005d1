"""The generator gives every seed the same sizes in another order, the
same inputs from the same seed, and the counts match a hand count."""

from __future__ import annotations

import json

import numpy as np

from portbench import counts, loops, registry, traffic as gen
from portbench.reference.common import receptive_field


def _deal(seed: int, n: int = 3000) -> list[int]:
    t = registry.traffic("serve")
    deck = gen.Deck(gen.clip_lengths(t), np.random.default_rng(seed))
    return [int(deck.deal()) for _ in range(n)]


def test_same_seed_same_clips_and_every_seed_the_same_sizes():
    a, b, c = _deal(2**40 + 5), _deal(2**40 + 5), _deal(17)
    assert a == b and a != c
    t = registry.traffic("serve")
    D = t["deck"]
    assert sorted(a[:D]) == sorted(c[:D]) == sorted(gen.clip_lengths(t).tolist())
    lo, hi = t["clip_seconds"]
    assert min(a) >= lo * t["sample_rate"] - 1 and max(a) <= hi * t["sample_rate"] + 1


def test_same_seed_same_corpus():
    t = dict(registry.traffic("train"), corpus_clips=2, clip_seconds=0.1)
    x = loops.corpus(t, 2**33 + 9, 256, "cpu")
    y = loops.corpus(t, 2**33 + 9, 256, "cpu")
    z = loops.corpus(t, 3, 256, "cpu")
    assert all(np.array_equal(u, v) for u, v in zip(x, y))
    assert not all(np.array_equal(u, v) for u, v in zip(x, z))
    assert all(c.min() >= 0 and c.max() < 256 and len(c) == 1600 for c in x)
    assert gen.seeds(2**31 + 7) == gen.seeds(2**31 + 7) != gen.seeds(2**31 + 8)


def test_decode_counts_by_hand():
    m = json.loads((registry.HERE / "configs" / "wavenet.json").read_text())["model"]
    # causal 2*256*32, fg 40*2*32*64, dense 40*32*32, skip 40*32*512, post1 512*512, post2 512*256
    params = 16384 + 163840 + 40960 + 655360 + 262144 + 131072
    assert params == 1_269_760
    assert counts.decode_flops_per_sample(m) == 2 * 1_269_760
    launch = counts.decode_launch(m, 2112, 4096, "bfloat16")
    assert launch["flops"] == 2112 * 4095 * 2 * 1_269_760
    assert launch["bytes"] == 1_269_760 * 2 + 2112 * 4092 * 32 * 2 + 2112 * 4096 * 4
    ae = json.loads((registry.HERE / "configs" / "wavenet_ae.json").read_text())["model"]
    assert counts.decode_flops_per_sample(ae) == 2 * 1_269_760
    assert counts.cond_params(ae) == 40 * 512 * 64 + 512 * 512


def test_train_counts_by_hand():
    m = json.loads((registry.HERE / "configs" / "wavenet.json").read_text())["model"]
    rf = receptive_field(m)
    T = rf + 40000 - 1  # the window's inputs
    n, fwd = T - 1, 2 * 2 * 256 * 32 * (T - 1)
    for d in m["dilations"]:
        n -= d
        fwd += 2 * n * (2 * 32 * 64 + 32 * 32)
    fwd += 2 * 40000 * (40 * 32 * 512 + 512 * 512 + 512 * 256)
    assert counts.train_flops(m, 40000, 4) == 3 * 4 * fwd
    # about 2 x parameters an output position, three times over
    assert abs(counts.train_flops(m, 40000, 4) / (3 * 4 * 40000 * 2 * 1_269_760) - 1) < 0.03

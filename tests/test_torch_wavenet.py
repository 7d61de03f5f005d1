"""The port's WaveNet model (music_tpu_torch.models.wavenet) held against
music_tpu.models.wavenet: forward, loss_fn, decode_step and
generate_tokens, on the same weights."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.models import wavenet as jwn
from music_tpu.ops import conv as jconv
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.ops import conv as tconv
from music_tpu_torch.ops import sampling
from music_tpu_torch.utils.parity import tie_aware_check
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], dilation_channels=8,
    residual_channels=8, skip_channels=16, quantization_channels=32, use_bias=False,
)
JTINY = jwn.WaveNetConfig.from_json(TINY_JSON)
TTINY = twn.WaveNetConfig.from_json(TINY_JSON)


def _params(cfg_json, seed=0):
    jcfg = jwn.WaveNetConfig.from_json(cfg_json)
    jp = jwn.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.use_bias:  # random biases, so the bias paths are exercised
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
                  if k.endswith("_b") else v) for k, v in jp.items()}
    npp = {k: np.asarray(v) for k, v in jp.items()}
    return jp, twn.params_from_numpy(npp, cfg=twn.WaveNetConfig.from_json(cfg_json))


def test_config_mirrors_jax():
    for cfg_json in (TINY_JSON, {**TINY_JSON, "use_bias": True}):
        j = dataclasses.asdict(jwn.WaveNetConfig.from_json(cfg_json))
        t = dataclasses.asdict(twn.WaveNetConfig.from_json(cfg_json))
        assert j == t
    assert twn.WaveNetConfig().receptive_field == jwn.WaveNetConfig().receptive_field == 4094
    assert twn.WaveNetConfig().n_blocks == 40


@pytest.mark.parametrize("fuse_taps", [False, True])
def test_conv_primitives_match_jax(fuse_taps):
    # tolerance 1e-5: float32 sums taken in another order
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 50, 8)).astype(np.float32)
    w = rng.standard_normal((2, 8, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    for d in (1, 3, 7):
        ref = jconv.dilated_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        dilation=d, fuse_taps=fuse_taps)
        ours = tconv.dilated_causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(b), dilation=d, fuse_taps=fuse_taps)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tconv.conv1x1(torch.from_numpy(x), torch.from_numpy(w[0])).numpy(),
        np.asarray(jconv.conv1x1(jnp.asarray(x), jnp.asarray(w[0]))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tconv.causal_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jconv.causal_conv(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    toks = rng.integers(0, 32, (2, 40)).astype(np.int32)
    we = rng.standard_normal((2, 32, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tconv.token_causal_conv(torch.from_numpy(toks), torch.from_numpy(we), dilation=2).numpy(),
        np.asarray(jconv.token_causal_conv(jnp.asarray(toks), jnp.asarray(we), dilation=2)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_bias", [False, True])
def test_forward_and_loss_match_jax_tiny(use_bias):
    # tolerance 1e-5: float32 forward over 8 layers, sums in another order
    cfg_json = {**TINY_JSON, "use_bias": use_bias}
    jp, tp = _params(cfg_json)
    jcfg, tcfg = jwn.WaveNetConfig.from_json(cfg_json), twn.WaveNetConfig.from_json(cfg_json)
    toks = np.random.default_rng(2).integers(0, 32, (2, 60)).astype(np.int32)
    ref = np.asarray(jax.jit(functools.partial(jwn.forward, cfg=jcfg))(jp, jnp.asarray(toks)))
    ours = twn.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert ours.shape == ref.shape == (2, 60 - 32 + 1, 32)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    ref_loss = float(jax.jit(functools.partial(jwn.loss_fn, cfg=jcfg))(jp, jnp.asarray(toks)))
    our_loss = float(twn.loss_fn(tp, torch.from_numpy(toks), tcfg))
    np.testing.assert_allclose(our_loss, ref_loss, rtol=1e-5)
    module = twn.WaveNet(tcfg, tp)
    assert sorted(dict(module.named_parameters())) == sorted(tp)
    np.testing.assert_allclose(module(torch.from_numpy(toks)).detach().numpy(), ours)


def test_forward_full_width_matches_jax():
    # shipped width (40 blocks, Cs=512, Q=256), batch 1, T = receptive field + 8;
    # tolerance 1e-4 absolute: 40 float32 layers of 32-512 wide sums in
    # another order (logits are O(0.1))
    jcfg, tcfg = jwn.WaveNetConfig(), twn.WaveNetConfig()
    jp = jwn.init_params(jax.random.PRNGKey(3), jcfg)
    tp = twn.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=tcfg)
    toks = np.random.default_rng(3).integers(0, 256, (1, tcfg.receptive_field + 8))
    toks = toks.astype(np.int32)
    ref = np.asarray(jax.jit(functools.partial(jwn.forward, cfg=jcfg))(jp, jnp.asarray(toks)))
    ours = twn.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert ours.shape == (1, 9, 256)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_bias", [False, True])
def test_decode_step_logits_teacher_forced(use_bias):
    # tolerance 1e-5: per-step float32 products in another order
    cfg_json = {**TINY_JSON, "use_bias": use_bias}
    jp, tp = _params(cfg_json, seed=4)
    jcfg, tcfg = jwn.WaveNetConfig.from_json(cfg_json), twn.WaveNetConfig.from_json(cfg_json)
    toks = np.random.default_rng(4).integers(0, 32, (3, 48)).astype(np.int32)
    jcache, tcache = jwn.init_cache(jcfg, 3), twn.init_cache(tcfg, 3)
    jstep = jax.jit(functools.partial(jwn.decode_step, cfg=jcfg))
    for t in range(toks.shape[1]):
        jcache, jl = jstep(jp, jcache, jnp.asarray(toks[:, t]))
        tcache, tl = twn.decode_step(tp, tcache, torch.from_numpy(toks[:, t]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def _jax_teacher_forced(jp, jcfg, prime):
    """logits_fn for tie_aware_check: the JAX model's scores for each
    candidate token given the prime and the candidates before it."""
    fwd = jax.jit(functools.partial(jwn.forward, cfg=jcfg))

    def logits_fn(tokens):
        toks = np.asarray(tokens)
        seq = np.concatenate([prime, toks[:, :-1]], axis=1)
        return np.asarray(fwd(jp, jnp.asarray(seq[:, prime.shape[1] - jcfg.receptive_field:])))

    return logits_fn


def test_plain_generate_tokens_tie_aware_vs_jax():
    """music_tpu_torch generate_tokens (plain step loop) vs
    music_tpu.models.wavenet.generate_tokens, argmax.  Tolerance 1e-5 on
    the teacher-forced JAX logits: float32 order differences only."""
    jp, tp = _params(TINY_JSON, seed=5)
    P = TTINY.receptive_field + max(TTINY.dilations) + 4
    prime = np.random.default_rng(5).integers(0, 32, (4, P)).astype(np.int32)
    ref = np.asarray(jwn.generate_tokens(jp, jnp.asarray(prime), jax.random.PRNGKey(0),
                                         cfg=JTINY, n_steps=120, prime_len=P))
    ours = twn.generate_tokens(tp, torch.from_numpy(prime), cfg=TTINY, n_steps=120,
                               prime_len=P).numpy()
    report = tie_aware_check(ours, _jax_teacher_forced(jp, JTINY, prime), tol=1e-5)
    assert report["ok"], report
    assert report["n"] == ours.size
    # exact agreement reported beside the tie-aware verdict
    print("exact token equality with JAX:", (ours == ref).mean(), report)


def test_init_params_distribution():
    # the JAX init's distribution (U(+-1/sqrt(fan_in)), zero biases), not its values
    cfg = twn.WaveNetConfig.from_json({**TINY_JSON, "use_bias": True})
    p = twn.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jwn.init_params(jax.random.PRNGKey(0), jwn.WaveNetConfig.from_json(
        {**TINY_JSON, "use_bias": True}))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    big = twn.init_params(twn.WaveNetConfig(), torch.Generator().manual_seed(1))
    for k, fan_in in (("causal", 512), ("fg", 64), ("skip", 32), ("post1", 512)):
        bound = 1 / np.sqrt(fan_in)
        v = big[k].numpy()
        assert np.abs(v).max() <= bound
        # uniform: mean 0, variance bound^2/3 (5% on >= 65k draws)
        assert abs(v.mean()) < 0.02 * bound
        np.testing.assert_allclose(v.var(), bound**2 / 3, rtol=0.05)
    assert all(float(v.abs().sum()) == 0 for k, v in p.items() if k.endswith("_b"))
    back = twn.params_to_numpy(p)
    assert all(np.array_equal(back[k], p[k].numpy()) for k in p)


def test_sampling_primitives():
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    # first index on ties, like jnp.argmax
    assert sampling.argmax_sample(logits).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    probs = torch.tensor([0.1, 0.6, 0.3])
    draws = sampling.gumbel_argmax(g, torch.log(probs).expand(20000, 3))
    freq = np.bincount(draws.numpy(), minlength=3) / 20000
    # 5 sigma of a 20000-draw binomial proportion is < 0.02
    np.testing.assert_allclose(freq, probs.numpy(), atol=0.02)
    draws = sampling.categorical(g, torch.log(probs).expand(20000, 3) * 2.0, temperature=2.0)
    np.testing.assert_allclose(np.bincount(draws.numpy(), minlength=3) / 20000,
                               probs.numpy(), atol=0.02)

"""The plain references against the port at a tiny size on the CPU (the
tests may import the port; the references never do)."""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import philox, wavenet as ref_wn, wavenet_ae as ref_ae
from portbench.tests import tiny


def _params(mod, m, seed=3):
    return weights.make(mod.param_shapes(m), mod.fan_in(m), seed, "cpu")


def test_wavenet_logits_and_loss_match_the_port():
    from music_tpu_torch.models import wavenet as wn

    m = tiny.WAVENET["model"]
    p = _params(ref_wn, m)
    tokens = torch.randint(0, 256, (2, 80), generator=torch.Generator().manual_seed(1))
    cfg = wn.WaveNetConfig.from_json(m)
    torch.testing.assert_close(ref_wn.logits(p, tokens, m), wn.forward(p, tokens, cfg),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ref_wn.loss(p, tokens, m), wn.loss_fn(p, tokens, cfg),
                               rtol=1e-6, atol=1e-6)


def test_autoencoder_matches_the_port():
    from music_tpu_torch.models import wavenet_ae as ae

    m = tiny.WAVENET_AE["model"]
    p = _params(ref_ae, m)
    tokens = torch.randint(0, 256, (2, 200), generator=torch.Generator().manual_seed(2))
    cfg = ae.WaveNetAEConfig.from_json(m)
    frames = ref_ae.encode(p, tokens, m)
    torch.testing.assert_close(frames, ae.encode(p, tokens, cfg), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ref_ae.loss(p, tokens, m), ae.loss_fn(p, tokens, cfg),
                               rtol=1e-6, atol=1e-6)
    out_w = 200 - cfg.receptive_field + 1
    torch.testing.assert_close(ref_ae.logits(p, tokens, frames, m),
                               ae.decode(p, tokens, frames, cfg, out_w), rtol=1e-5, atol=1e-6)


def test_noise_matches_the_port_draws():
    from music_tpu_torch.ops.philox import decode_uniforms, gumbel

    rows = torch.tensor([0, 5, 2111])
    for step in (0, 1, 4095):
        want = gumbel(decode_uniforms(2**31 - 3, rows, step, 256))
        got = philox.gumbel(2**31 - 3, rows, torch.full((3,), step), 256)
        assert torch.equal(got, want)


def test_fp8_control_rounds_coarser_than_bf16():
    from portbench.reference.common import fp8

    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (fp8(x) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 4 * e16

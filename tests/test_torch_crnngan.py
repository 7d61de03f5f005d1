"""The port's C-RNN-GAN (music_tpu_torch.models.crnngan, train.crnngan_train,
generate.crnngan_generate and the ``crnngan`` commands) against music_tpu's
on the same weights and noise at a tiny config (H = 8, noise 4, T = 6,
B = 4), unconditioned and conditioned on 3 meta columns, on the CPU.

The noise is JAX's own: ``jax.random.uniform`` over the key (or key
split) each JAX function draws from, fed to the port."""

import dataclasses
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu import cli as jcli
from music_tpu.generate import crnngan_generate as jgen
from music_tpu.models import crnngan as jcg
from music_tpu.train import crnngan_train as jtrain
from music_tpu_torch import cli
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.data import midi as tmidi
from music_tpu_torch.generate import crnngan_generate as tgen
from music_tpu_torch.models import crnngan as tcg
from music_tpu_torch.train import crnngan_train as ttrain
from test_torch_seqgan import split_mesh
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5  # forwards, losses and gradients, float32 on both sides
REL = 1e-5  # params and Adam state after one update, per leaf
B, T, NOISE, H = 4, 6, 4, 8
META_DIMS = [0, 3]


def cfgs(meta_dim: int):
    kw = dict(noise_dim=NOISE, hidden_dim=H, song_length=T, meta_dim=meta_dim)
    return jcg.CRnnGanConfig(**kw), tcg.CRnnGanConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def params(meta_dim: int):
    jc, _ = cfgs(meta_dim)
    k1, k2 = jax.random.split(jax.random.PRNGKey(meta_dim))
    jg, jd = jcg.init_generator(k1, jc), jcg.init_discriminator(k2, jc)
    return jg, jd, tcg.params_from_numpy(_np(jg)), tcg.params_from_numpy(_np(jd))


def events(seed: int, n: int = B) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, (n, T, 4)).astype(np.float32)


def meta_rows(seed: int, meta_dim: int, n: int = B):
    """One-hot-like rows (None when unconditioned), numpy."""
    if meta_dim == 0:
        return None
    return (np.random.default_rng(seed).uniform(0, 1, (n, meta_dim)) > 0.5).astype(np.float32)


def uniform(key, batch: int = B, length: int = T) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.uniform(key, (length, batch, NOISE))))


def jarr(x):
    return None if x is None else jnp.asarray(x)


def tarr(x):
    return None if x is None else torch.from_numpy(x)


def leaves_by_path(tree, jax_tree: bool):
    if jax_tree:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    return {p: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in tck._flatten(tree)}


def assert_tree_close(ours, theirs, rel=REL):
    """The same key paths; each leaf within ``rel`` of its largest
    magnitude (integers, such as Adam's count, equal)."""
    a, b = leaves_by_path(ours, False), leaves_by_path(theirs, True)
    assert list(a) == list(b)
    for path, want in b.items():
        got = a[path]
        assert got.shape == want.shape, path
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                                       atol=rel * max(float(np.abs(want).max()), 1e-30))


def assert_grads_close(live, jgrads):
    ours = jax.tree.map(lambda t: t.grad.numpy(), live)
    assert jax.tree.structure(ours) == jax.tree.structure(_np(jgrads))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(_np(jgrads))):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_config_from_json_both_schemas():
    """``noise_dim`` or the reference's ``random_input_dim``; missing keys
    default; the train config has JAX's fields and defaults."""
    for raw in ({"noise_dim": 7, "hidden_dim": 5, "song_length": 9, "meta_dim": 2},
                {"random_input_dim": 7, "hidden_dim": 5, "song_length": 9},
                {"num_song_features": 4}, {}):
        ours, theirs = tcg.CRnnGanConfig.from_json(raw), jcg.CRnnGanConfig.from_json(raw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tcg.CRnnGanConfig.from_json({"random_input_dim": 7}).noise_dim == 7
    ours, theirs = ttrain.CRnnGanTrainConfig(), jtrain.CRnnGanTrainConfig()
    assert ({k: v for k, v in vars(ours).items() if k != "cfg"}
            == {k: v for k, v in vars(theirs).items() if k != "cfg"})


@pytest.mark.parametrize("meta_dim", META_DIMS)
def test_init_has_jax_layout(meta_dim):
    """The inits' trees and leaf shapes equal JAX's; the torch default
    bounds (1/sqrt(H) for the LSTMs, 1/sqrt(in) for the linears)."""
    jc, tc = cfgs(meta_dim)
    jg, jd, _, _ = params(meta_dim)
    gen = torch.Generator().manual_seed(0)
    tg, td = tcg.init_generator(gen, tc), tcg.init_discriminator(gen, tc)
    for ours, theirs in ((tg, jg), (td, jd)):
        ours = tcg.params_to_numpy(ours)
        assert jax.tree.structure(ours) == jax.tree.structure(_np(theirs))
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(_np(theirs))):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert float(tg["lstm1"]["wh"].abs().max()) <= 1 / H ** 0.5
    assert float(td["out"]["w"].abs().max()) <= 1 / (2 * H) ** 0.5


REAL, FAKE, KEY = 4, 5, 6  # the seeds of the model tests' inputs


def start_threads(fns: dict):
    """Run every ``fn`` of ``{name: fn}`` in a thread of its own; returns a
    ``join()`` that waits and gives ``{name: fn()}`` (re-raising a thread's
    error).  JAX compiles the threads' programs at once (XLA's compiler does
    not hold the interpreter lock), where one after another they add up."""
    out, errors = {}, {}

    def call(name, fn):
        try:
            out[name] = fn()
        except BaseException as e:  # re-raised by join, in the caller's thread
            errors[name] = e

    threads = [threading.Thread(target=call, args=item) for item in fns.items()]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        for e in errors.values():
            raise e
        return out

    return join


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every JAX program of the file's comparisons, compiled at once: the
    model references of both meta widths (:func:`_model_reference`) in
    threads beside the shared trainer state's steps (:func:`_shared_state`),
    then the GAN step in every branch's configuration."""
    models = start_threads({m: functools.partial(_model_reference, m) for m in META_DIMS})
    shared = _shared_state(tmp_path_factory.mktemp("crnngan_state"))
    gan = start_threads({b: functools.partial(_branch_step, shared, BRANCHES[b][0])
                         for b in BRANCHES})
    return {"models": models(), "shared": shared, "gan": gan()}


@pytest.fixture(scope="module", params=META_DIMS, ids=lambda m: f"meta{m}")
def model_case(request, jax_side):
    """JAX's forwards, losses and gradients at one meta width, on the same
    inputs as the port's; and the port's side."""
    return jax_side["models"][request.param]


def _model_reference(meta_dim):
    """JAX's side of :func:`model_case` at ``meta_dim``, in one jitted
    program, and the port's inputs."""
    jc, tc = cfgs(meta_dim)
    jg, jd, tg, td = params(meta_dim)
    real, fake, meta = events(REAL), events(FAKE), meta_rows(REAL, meta_dim)
    key = jax.random.PRNGKey(KEY)

    @jax.jit
    def reference(jg, jd, real, fake, meta):
        meta = None if meta_dim == 0 else meta
        return {
            "generate": jcg.generate(jg, key, jc, B, meta=meta),
            "generate 2x9": jcg.generate(jg, key, jc, 2, length=9,
                                         meta=None if meta is None else meta[:2]),
            "teacher_forced": jcg.generator_teacher_forced(jg, key, real, jc, meta=meta),
            "discriminator": jcg.discriminator_forward(jd, real, jc, meta=meta),
            "condition_events": jcg.condition_events(real, meta, jc),
            "d_loss": jax.value_and_grad(jcg.d_loss)(jd, real, fake, jc, meta=meta),
            "g_adv_loss": jax.value_and_grad(
                lambda g: jcg.g_adv_loss(g, jd, key, B, jc, meta=meta))(jg),
            "g_feature_matching_loss": jax.value_and_grad(
                lambda g: jcg.g_feature_matching_loss(g, jd, key, real, jc, meta=meta))(jg),
            "g_pretrain_loss": jax.value_and_grad(
                lambda g: jcg.g_pretrain_loss(g, key, real, jc, meta=meta))(jg),
        }

    ref = reference(jg, jd, jnp.asarray(real), jnp.asarray(fake),
                    jnp.zeros((B, 0)) if meta is None else jnp.asarray(meta))
    return tc, tg, td, real, fake, tarr(meta), uniform(key), jax.tree.map(np.asarray, ref)


def test_generators_match_jax(model_case):
    """Free-running ``generate`` (JAX's uniform noise from its key; also 2
    songs of 9 steps) and ``generator_teacher_forced`` within 1e-5; the
    noise's shape checked."""
    tc, tg, _, real, _, meta, noise, ref = model_case
    ours = tcg.generate(tg, tc, B, meta=meta, noise=noise)
    assert ours.shape == (B, T, 4)
    np.testing.assert_allclose(ours.numpy(), ref["generate"], atol=ATOL, rtol=0)
    ours = tcg.generate(tg, tc, 2, 9, None if meta is None else meta[:2],
                        noise=uniform(jax.random.PRNGKey(KEY), 2, 9))
    np.testing.assert_allclose(ours.numpy(), ref["generate 2x9"], atol=ATOL, rtol=0)
    ours = tcg.generator_teacher_forced(tg, torch.from_numpy(real), tc, meta, noise=noise)
    np.testing.assert_allclose(ours.numpy(), ref["teacher_forced"], atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="noise"):
        tcg.generate(tg, tc, B + 1, noise=noise)


def test_discriminator_matches_jax(model_case):
    """Decisions ``[B, T]`` and features ``[B, T, 2H]`` within 1e-5; the
    meta rows tiled onto every step."""
    tc, _, td, real, _, meta, _, ref = model_case
    tp, tf = tcg.discriminator_forward(td, torch.from_numpy(real), tc, meta=meta)
    assert tp.shape == (B, T) and tf.shape == (B, T, 2 * H)
    np.testing.assert_allclose(tp.numpy(), ref["discriminator"][0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tf.numpy(), ref["discriminator"][1], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        tcg.condition_events(torch.from_numpy(real), meta, tc).numpy(), ref["condition_events"])
    # real and fake in one forward: the values of two forwards; fakes of
    # another length take two
    fake = torch.from_numpy(events(FAKE))
    for other in (fake, fake[:, :4]):
        pair = tcg.discriminator_pair(td, torch.from_numpy(real), other, tc, meta)
        for got, x in zip(pair, (torch.from_numpy(real), other)):
            for a, b in zip(got, tcg.discriminator_forward(td, x, tc, meta)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


LOSSES = ["d_loss", "g_adv_loss", "g_feature_matching_loss", "g_pretrain_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_its_gradient_match_jax(model_case, name):
    """Each loss and its gradient for the net it trains (D for ``d_loss``,
    G for the others), on JAX's noise, within 1e-5."""
    tc, tg, td, real, fake, meta, noise, ref = model_case
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                        td if name == "d_loss" else tg)
    real, fake = torch.from_numpy(real), torch.from_numpy(fake)
    if name == "d_loss":
        tl = tcg.d_loss(live, real, fake, tc, meta=meta)
    elif name == "g_adv_loss":
        tl = tcg.g_adv_loss(live, td, B, tc, meta, noise=noise)
    elif name == "g_feature_matching_loss":
        tl = tcg.g_feature_matching_loss(live, td, real, tc, meta, noise=noise)
    else:
        tl = tcg.g_pretrain_loss(live, real, tc, meta, noise=noise)
    tl.backward()
    jl, jgrad = ref[name]
    assert float(tl.detach()) == pytest.approx(float(jl), abs=ATOL)
    assert_grads_close(live, jgrad)


def test_feature_scaler_matches_jax():
    data = np.random.default_rng(7).normal([10, 96, 440, 80], [5, 30, 100, 20],
                                           (9, T, 4)).astype(np.float32)
    ours, theirs = ttrain.FeatureScaler(data), jtrain.FeatureScaler(data)
    np.testing.assert_array_equal(ours.mean, theirs.mean)
    np.testing.assert_array_equal(ours.std, theirs.std)
    normed = ours.transform(data)
    np.testing.assert_array_equal(normed, theirs.transform(data))
    np.testing.assert_array_equal(ours.inverse(normed), theirs.inverse(normed))
    np.testing.assert_allclose(ours.inverse(normed), data, rtol=1e-5)


# ---------------------------------------------------------------------------
# The trainer: one update of each step from a shared state
# ---------------------------------------------------------------------------

META = 3
JC, TC = cfgs(META)


def _jtc(**kw):
    return jtrain.CRnnGanTrainConfig(cfg=JC, batch_size=B, **kw)


def _ttc(**kw):
    return ttrain.CRnnGanTrainConfig(cfg=TC, batch_size=B, **kw)


def _jax_gan_step(jt, real, meta, key):
    """JAX's single-program GAN step from ``jt``'s state: the new state (as
    ``state()``), G's and D's losses and D's accuracy."""
    out = jt._gan_single_step(jt.g_params, jt.d_params, jt.g_opt, jt.d_opt,
                              jnp.asarray(real), jnp.asarray(meta), key)
    return dict(zip(("g_params", "d_params", "g_opt", "d_opt"), out[:4])), *out[4:]


def _shared_state(path):
    """A JAX trainer one pretrain step and one GAN step (D trained) in, so
    that both Adam states hold non-zero moments, saved to ``path``."""
    jt = jtrain.CRnnGanTrainer(_jtc(), seed=0)
    jt.g_params, jt.g_opt, _ = jt._pre_step(jt.g_params, jt.g_opt, jnp.asarray(events(8)),
                                            jnp.asarray(meta_rows(8, META)),
                                            jax.random.PRNGKey(8))
    state = _jax_gan_step(jt, events(9), meta_rows(9, META), jax.random.PRNGKey(9))[0]
    jt.g_params, jt.d_params, jt.g_opt, jt.d_opt = (state[k] for k in state)
    assert int(jt.d_opt[1][0].count) == 1
    jt.save(path, 2)
    return jt, path


@pytest.fixture(scope="module")
def shared(jax_side):
    """The shared JAX trainer and the checkpoint it saved."""
    return jax_side["shared"]


def _port_trainer(shared, **kw):
    jt, path = shared
    tt = ttrain.CRnnGanTrainer(_ttc(**kw), seed=0, device="cpu")
    assert tt.restore(path) == 2
    assert_tree_close(tt.state(), jt.state(), rel=0)
    return tt


def test_pre_step_matches_jax(shared):
    jt = shared[0]
    tt = _port_trainer(shared)
    real, meta, key = events(10), meta_rows(10, META), jax.random.PRNGKey(10)
    g, opt, loss = jt._pre_step(jt.g_params, jt.g_opt, jnp.asarray(real), jnp.asarray(meta),
                                key)
    tl = tt.pre_step(torch.from_numpy(real), torch.from_numpy(meta), noise=uniform(key)[None])
    assert float(tl) == pytest.approx(float(loss), abs=ATOL)
    assert_tree_close({"g": tt.g_params, "opt": tt.g_opt}, {"g": g, "opt": opt})


def assert_d_acc(ours: float, theirs: float, p_real, p_fake):
    """``d_acc`` tie-aware: a decision within 1e-6 of 0.5 may count either
    way (the two packages sum in another order), each moving the accuracy
    by 0.5 / (B T)."""
    near = int((np.abs(p_real - 0.5) < 1e-6).sum() + (np.abs(p_fake - 0.5) < 1e-6).sum())
    assert abs(ours - theirs) <= 0.5 * near / p_real.size + 1e-7, (ours, theirs, near)


BRANCHES = {  # label: (train config overrides, D trained, G by feature matching)
    "D trained, auto -> adv": ({}, True, False),  # the defaults, at this state
    "D frozen, auto -> fm": (dict(d_too_strong=0.0, feature_matching_below=1.0), False, True),
    "D trained, fm": (dict(d_too_strong=1.01, g_objective="fm"), True, True),
    "D frozen, adv": (dict(d_too_strong=0.0, g_objective="adv"), False, False),
}


GAN_REAL, GAN_META, GAN_SEED = events(11), meta_rows(11, META), 11


def _branch_step(shared, overrides):
    """JAX's single-program GAN step from the shared state in a branch's
    configuration (a trainer each: its gates are baked into its program)."""
    j, path = shared
    if overrides:
        j = jtrain.CRnnGanTrainer(_jtc(**overrides), seed=0)
        j.restore(path)
    return _jax_gan_step(j, GAN_REAL, GAN_META, jax.random.PRNGKey(GAN_SEED))


@pytest.fixture(scope="module")
def gan_refs(jax_side):
    return jax_side["gan"]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_gan_step_matches_jax(shared, gan_refs, branch):
    """JAX's single-program GAN step on a key; the port's on the uniforms
    of that key's three splits (fakes from ``k1``, feature matching's from
    ``k2``, the adversarial loss's from ``k3``): the same gate branches,
    losses, params and both Adam states (a frozen D's count unmoved)."""
    overrides, trained, fm = BRANCHES[branch]
    tt = _port_trainer(shared, **overrides)
    real, meta, key = GAN_REAL, GAN_META, jax.random.PRNGKey(GAN_SEED)
    noise = torch.stack([uniform(k) for k in jax.random.split(key, 3)])
    treal, tmeta = torch.from_numpy(real), torch.from_numpy(meta)
    with torch.no_grad():  # D's decisions that the gates read
        fake = tcg.generate(tt.g_params, TC, B, meta=tmeta, noise=noise[0])
        p_real, p_fake = (tcg.discriminator_forward(tt.d_params, x, TC, tmeta)[0].numpy()
                          for x in (treal, fake))
    state, gl, dl, d_acc = gan_refs[branch]
    step = tt.gan_step(treal, tmeta, noise=noise)
    assert (step.d_trained, step.feature_matching) == (trained, fm)
    assert_d_acc(float(step.d_acc), float(d_acc), p_real, p_fake)
    assert float(step.d_loss) == pytest.approx(float(dl), abs=ATOL)
    assert float(step.g_loss) == pytest.approx(float(gl), abs=ATOL)
    assert_tree_close(tt.state(), state)
    assert int(tt.d_opt[1][0].count) == (2 if trained else 1)


def test_checkpoints_cross_packages(shared, tmp_path):
    """The port's checkpoint has the JAX ``state()``'s key paths and dtypes,
    and the JAX trainer restores it leaf for leaf (the other direction:
    every trainer test above restores the JAX trainer's save)."""
    tt = _port_trainer(shared)
    tt.pre_step(torch.from_numpy(events(12)), torch.from_numpy(meta_rows(12, META)),
                generator=torch.Generator().manual_seed(0))
    tt.save(tmp_path / "t", 3)
    shared[0].save(tmp_path / "j", 3)
    manifests = [json.loads((tmp_path / w / "step_3" / "manifest.json").read_text())
                 for w in ("j", "t")]
    assert ([(l["path"], l["dtype"]) for l in manifests[0]["leaves"]]
            == [(l["path"], l["dtype"]) for l in manifests[1]["leaves"]])
    back = jtrain.CRnnGanTrainer(_jtc(), seed=5)
    assert back.restore(tmp_path / "t") == 3
    assert_tree_close(tt.state(), back.state(), rel=0)


def test_trainer_phases_run_and_learn():
    """Pretraining lowers the MSE on its data, GAN epochs give finite
    losses with JAX's batch order; a bad objective refused, and a model
    size that does not divide the hidden width."""
    data = events(13, 12) * 0.3
    meta = meta_rows(13, META, 12)
    tt = ttrain.CRnnGanTrainer(_ttc(), seed=1, device="cpu")
    real, m = torch.from_numpy(data), torch.from_numpy(meta)
    gen = torch.Generator().manual_seed(0)
    noise = torch.rand((T, 12, NOISE), generator=gen)
    before = float(tcg.g_pretrain_loss(tt.g_params, real, TC, m, noise=noise))
    tt.pretrain(data, epochs=6, meta=meta)
    assert float(tcg.g_pretrain_loss(tt.g_params, real, TC, m, noise=noise)) < before
    assert np.isfinite(tt.gan_epoch(data, meta=meta)).all()
    assert int(tt.g_opt[1][0].count) == 6 * 3 + 3
    with pytest.raises(ValueError, match="g_objective"):
        ttrain.CRnnGanTrainer(_ttc(g_objective="both"), device="cpu")
    with pytest.raises(ValueError, match="hidden 8 not divisible by model axis 3"):
        ttrain.CRnnGanTrainer(_ttc(), mesh=split_mesh(3), device="cpu")


# ---------------------------------------------------------------------------
# Generation to MIDI and the commands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("meta_dim", META_DIMS)
def test_generate_to_midi_matches_jax(meta_dim, tmp_path):
    """``crnngan_generate.generate`` given JAX's noise (its ``PRNGKey(seed)``)
    returns JAX's events within 1e-5 (after the scaler and the clamps); and
    ``events_to_midi`` writes JAX's bytes from the same events array.
    (Events can land within 1e-5 of a half tick, so the two generated
    files are compared through these two checks, not byte for byte.)"""
    jc, tc = cfgs(meta_dim)
    jg, _, tg, _ = params(meta_dim)
    scaler = jtrain.FeatureScaler(np.random.default_rng(14).normal(
        [100, 200, 440, 70], [50, 80, 200, 20], (8, T, 4)).astype(np.float32))
    meta = None if meta_dim == 0 else np.eye(meta_dim, dtype=np.float32)[1]
    theirs = jgen.generate(jg, jc, tmp_path / "j.mid", scaler=scaler, seed=3, meta=meta)
    ours = tgen.generate(tg, tc, tmp_path / "t.mid", scaler=scaler, meta=meta,
                         noise=uniform(jax.random.PRNGKey(3), 1), device="cpu")
    assert (np.abs(ours - theirs) <= ATOL * np.abs(theirs).max(axis=0)).all()
    tmidi.events_to_midi(theirs, tmp_path / "t_same.mid")
    assert (tmp_path / "t_same.mid").read_bytes() == (tmp_path / "j.mid").read_bytes()
    assert len(tmidi.midi_to_song_data(tmp_path / "t.mid")) == T


def _tiny_params_dir(tmp_path, midi_dir):
    d = tmp_path / "params"
    d.mkdir()
    (d / "crnngan_params.json").write_text(json.dumps(
        {"num_song_features": 4, "noise_dim": NOISE, "hidden_dim": H, "song_length": T}))
    (d / "dataset_params.json").write_text(json.dumps(
        {"root_dir": str(midi_dir), "song_length": T, "output_ticks_per_quarter_note": 384,
         "batch_size": B}))
    (d / "train_params.json").write_text(json.dumps(
        {"num_epochs": 2, "pretrain_epochs": 1, "g_lr": 0.001, "d_lr": 0.001}))
    return d


def _corpus(root, n_songs=8, seed=15):
    """Seeded songs under ``root/genre/composer/``: 2 genres x 2 composers."""
    rng = np.random.default_rng(seed)
    for i in range(n_songs):
        n = int(rng.integers(T + 2, T + 9))
        ev = np.stack([rng.integers(0, 200, n), rng.integers(24, 400, n),
                       [tmidi.tone_to_freq(t) for t in rng.integers(40, 90, n)],
                       rng.integers(30, 120, n)], axis=1)
        tmidi.events_to_midi(ev, root / f"g{i % 2}" / f"c{i // 2 % 2}" / f"song{i}.mid")
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``crnngan train --device cpu`` on a tiny params dir and 8 seeded
    songs (meta_dim 4); its params dir and checkpoint."""
    tmp = tmp_path_factory.mktemp("crnngan_cli")
    d = _tiny_params_dir(tmp, _corpus(tmp / "midi"))
    cli.main(["crnngan", "train", "--params-dir", str(d), "--checkpoint", str(tmp / "ck"),
              "--device", "cpu"])
    return d, tmp / "ck"


def test_cli_train_then_generate_on_cpu(trained, tmp_path, capsys):
    """``crnngan train`` then ``crnngan generate`` through ``cli.main`` on
    the CPU: the conditioning width (4) read back from the checkpoint, a
    MIDI file of ``song_length`` notes."""
    d, ck = trained
    assert tck.latest_step(ck) == 2
    assert tck.leaf_shapes(ck, prefix="['g_params']")["['fc1']['w']"] == (NOISE + 4 + 4, H)
    cli.main(["crnngan", "generate", "--params-dir", str(d), "--checkpoint", str(ck),
              "--out", str(tmp_path / "o.mid"), "--device", "cpu"])
    assert f"wrote {tmp_path / 'o.mid'}" in capsys.readouterr().out
    assert len(tmidi.midi_to_song_data(tmp_path / "o.mid")) == T
    back = jtrain.CRnnGanTrainer(_jtc_meta(4), seed=0)
    assert back.restore(ck) == 2  # the JAX trainer resumes the port's CLI checkpoint


def _jtc_meta(meta_dim):
    return jtrain.CRnnGanTrainConfig(cfg=dataclasses.replace(JC, meta_dim=meta_dim),
                                     batch_size=B)


def test_both_clis_write_normalized_events_clamped_alike(trained, tmp_path, monkeypatch):
    """A fault of the JAX command, kept by the port's (ROADMAP.md §C):
    ``crnngan generate`` has no feature scaler (the checkpoint does not hold
    it), so it writes G's normalized events clamped to velocity >= 1,
    length >= 1 and 8.18 Hz.  Both commands, given the same events array
    from G, write the same bytes.  (The JAX command on the CPU first raises:
    without a scaler it clamps the read-only ``np.asarray`` of a jax array
    in place; ROADMAP.md §C.  Its G is handed a numpy array here.)"""
    d, ck = trained
    argv = ["crnngan", "generate", "--params-dir", str(d), "--checkpoint", str(ck)]
    with pytest.raises(ValueError, match="read-only"):
        jcli.main([*argv, "--out", str(tmp_path / "x.mid")])
    raw = np.random.default_rng(16).normal(0, 1.5, (T, 4)).astype(np.float32)
    monkeypatch.setattr(jcg, "generate", lambda *a, **k: raw.copy()[None])
    monkeypatch.setattr(tcg, "generate", lambda *a, **k: torch.from_numpy(raw.copy())[None])
    jcli.main([*argv, "--out", str(tmp_path / "j.mid")])
    cli.main([*argv, "--out", str(tmp_path / "t.mid"), "--device", "cpu"])
    assert (tmp_path / "t.mid").read_bytes() == (tmp_path / "j.mid").read_bytes()
    song = np.asarray(tmidi.midi_to_song_data(tmp_path / "t.mid"))
    assert song[:, tmidi.VELOCITY].max() <= 2 and song[:, tmidi.FREQ].max() < 20

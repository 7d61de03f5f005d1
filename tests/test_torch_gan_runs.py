"""The port's GAN quality runs (music_tpu_torch.runs.crnngan_quality_run,
seqgan_quality_run, leakgan_oracle_run) against the JAX package's scripts
(benchmarks/*): the corpus and distance helpers equal theirs, the
C-RNN-GAN per-condition distances and the LeakGAN oracle's self-NLL equal
JAX's computations on the same parameters and draws, and each run's
``main`` at its tiny config on the CPU prints one JSON line with the JAX
script's keys plus the card's and exits 0 exactly when its pass flag is
true."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import crnngan_quality_run as jcr_run
from music_tpu.data import midi as jmidi
from music_tpu.models import crnngan as jcg
from music_tpu.models import leakgan as jlg
from music_tpu.models import seqgan as jsg
from music_tpu.train import crnngan_train as jcr_train
from music_tpu.train import leakgan_train as jlg_train
from music_tpu_torch.data import midi as tmidi
from music_tpu_torch.models import crnngan as tcg
from music_tpu_torch.models import seqgan as tsg
from music_tpu_torch.runs import crnngan_quality_run, leakgan_oracle_run, seqgan_quality_run
from music_tpu_torch.train import crnngan_train as tcr_train
from test_torch_crnngan import uniform
from test_torch_seqgan import gumbel
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5  # float32 forwards on both sides; the distances are float64 sums of them
CARD_KEYS = {"device", "card", "wall_s"}
CRNNGAN_KEYS = {"metric", "songs", "pretrain_loss", "gan_g_loss", "gan_d_loss", "d_real_acc",
                "moment_distance_init", "moment_distance_after_pretrain",
                "moment_distance_final_epoch", "moment_distance_best_ckpt", "best_ckpt_epoch",
                "eval_trajectory", "conditioning_steers_generation",
                "generated_events_reparsed", "wall_s"}
SEQGAN_KEYS = {"metric", "init_oracle_nll", "mle_only_oracle_nll", "mle_best_oracle_nll",
               "adv_best_oracle_nll", "adv_final_oracle_nll", "adv_beats_mle", "ln_vocab",
               "mle_epochs", "adv_rounds", "corpus_size", "wall_s", "backend"}
LEAKGAN_KEYS = {"metric", "oracle_self_nll", "ln_vocab", "init_oracle_nll",
                "pretrain_oracle_nll", "best_adv_oracle_nll", "final_adv_oracle_nll",
                "metric_range_nats", "schedule", "wall_s", "backend"}
T = 6  # song length of the C-RNN-GAN distance test


def test_helpers_equal_jax():
    assert crnngan_quality_run.PATTERNS == jcr_run.PATTERNS
    for note in range(0, 128, 7):
        assert crnngan_quality_run.tone_freq(note) == jcr_run.tone_freq(note)
    rng = np.random.default_rng(3)
    for shape in ((8, 20, 4), (5, 4)):
        gen = rng.normal(1, 2, shape).astype(np.float32)
        real = rng.normal(0, 1, (3, *shape[-2:])) * [1, 10, 100, 1000][: shape[-1]]
        assert crnngan_quality_run.moment_distance(gen, real) == jcr_run.moment_distance(gen, real)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Both packages' corpora at 2 songs a composer from ``default_rng(0)``."""
    root = tmp_path_factory.mktemp("gan_runs_corpus")
    crnngan_quality_run.synthesize_corpus(root / "port", 2, np.random.default_rng(0))
    jcr_run.synthesize_corpus(root / "jax", 2, np.random.default_rng(0))
    return root


def test_corpus_writes_jax_bytes_and_loads_alike(corpus):
    ours = sorted(p.relative_to(corpus / "port") for p in (corpus / "port").rglob("*.mid"))
    assert ours == sorted(p.relative_to(corpus / "jax") for p in (corpus / "jax").rglob("*.mid"))
    assert len(ours) == 2 * len(jcr_run.PATTERNS)
    for rel in ours:
        assert (corpus / "port" / rel).read_bytes() == (corpus / "jax" / rel).read_bytes()
    data, metas = tmidi.load_midi_dataset(corpus / "port", song_length=100)
    jdata, jmetas = jmidi.load_midi_dataset(corpus / "port", song_length=100)
    np.testing.assert_array_equal(data, jdata)
    assert [(m["genre"], m["composer"]) for m in metas] == [
        (m["genre"], m["composer"]) for m in jmetas]
    meta, genres, composers = tmidi.build_meta_onehots(metas)
    jmeta, jgenres, jcomposers = jmidi.build_meta_onehots(jmetas)
    np.testing.assert_array_equal(meta, jmeta)
    assert (genres, composers) == (jgenres, jcomposers)


def test_cond_distances_equal_jax(corpus):
    """The script's ``cond_distances`` closure, written out here with JAX's
    pieces (8 songs a condition from ``PRNGKey(seed * 31 + ci)``), against
    the port's on the same parameters and uniforms at H = 8, noise 4,
    T = 6, meta_dim 4: within and contrast equal within 1e-5 (unrounded;
    the scripts round them to 4 places)."""
    data, metas = jmidi.load_midi_dataset(corpus / "jax", song_length=T)
    meta, genres, composers = jmidi.build_meta_onehots(metas)
    kw = dict(noise_dim=4, hidden_dim=8, song_length=T, meta_dim=meta.shape[1])
    jcfg, tcfg = jcg.CRnnGanConfig(**kw), tcg.CRnnGanConfig(**kw)
    jg = jcg.init_generator(jax.random.PRNGKey(7), jcfg)
    tg = tcg.params_from_numpy(jax.tree.map(np.asarray, jg))
    jscaler, tscaler = jcr_train.FeatureScaler(data), tcr_train.FeatureScaler(data)
    rows = crnngan_quality_run.condition_rows(meta.shape[1], genres, composers)
    cond_data = [data[[i for i, m in enumerate(metas) if (m["genre"], m["composer"]) == pair]]
                 for pair in jcr_run.PATTERNS]
    for seed in (1, 104):
        within, contrast = [], []
        for ci, row in enumerate(rows):
            ev = np.asarray(jcg.generate(jg, jax.random.PRNGKey(seed * 31 + ci), jcfg, batch=8,
                                         meta=jnp.asarray(np.tile(row, (8, 1)))))
            ev = jscaler.inverse(ev)
            within.append(jcr_run.moment_distance(ev, cond_data[ci]))
            contrast.append(np.mean([jcr_run.moment_distance(ev, cond_data[cj])
                                     for cj in range(len(rows)) if cj != ci]))
        ours = crnngan_quality_run.cond_distances(
            tg, tcfg, tscaler, rows, cond_data, seed,
            noise=lambda ci, seed=seed: uniform(jax.random.PRNGKey(seed * 31 + ci), 8, T))
        np.testing.assert_allclose(ours, (np.mean(within), np.mean(contrast)), atol=ATOL,
                                   rtol=0)


def test_leakgan_oracle_self_nll_equals_jax():
    """The script's self-NLL (8 batches of the oracle's samples from
    ``PRNGKey(i)`` under the oracle) on the JAX trainer's tiny oracle, and
    the port's on the same parameters and Gumbel draws, within 1e-5."""
    cfg = leakgan_oracle_run.CONFIGS["tiny"]
    jtc = jlg_train.LeakGanTrainConfig(
        cfg=jlg.LeakGanConfig(**{f: getattr(cfg["cfg"], f) for f in (
            "vocab_size", "seq_len", "step_size", "goal_size", "worker_emb_dim",
            "worker_hidden", "manager_hidden", "dis_emb_dim", "filter_sizes", "num_filters")}),
        batch_size=cfg["batch_size"])
    jt = jlg_train.LeakGanTrainer(jtc, seed=233)
    B, ocfg = jtc.batch_size, jt.oracle_cfg
    samples = [jsg.generate(jt.oracle_params, jax.random.PRNGKey(i), ocfg, B) for i in range(8)]
    theirs = float(np.mean([float(jsg.generator_nll(jt.oracle_params, s, ocfg))
                            for s in samples]))
    tparams = tsg.params_from_numpy(jax.tree.map(np.asarray, jt.oracle_params))
    tcfg = tsg.GeneratorConfig(vocab_size=ocfg.vocab_size, emb_dim=ocfg.emb_dim,
                               hidden_dim=ocfg.hidden_dim, seq_len=ocfg.seq_len,
                               start_token=ocfg.start_token)
    noise = [gumbel(jax.random.PRNGKey(i), ocfg.seq_len, (B, ocfg.vocab_size)) for i in range(8)]
    for i in range(8):  # the same samples
        np.testing.assert_array_equal(tsg.generate(tparams, tcfg, B, noise=noise[i]).numpy(),
                                      np.asarray(samples[i]))
    ours = leakgan_oracle_run.oracle_self_nll(tparams, tcfg, B, noise=noise)
    assert ours == pytest.approx(theirs, abs=ATOL)


RUNS = {
    "crnngan_quality_run": (crnngan_quality_run, CRNNGAN_KEYS, "conditioning_steers_generation",
                            ["--songs", "2", "--epochs", "2", "--pretrain", "1", "--batch", "4",
                             "--eval-every", "1"]),
    "seqgan_quality_run": (seqgan_quality_run, SEQGAN_KEYS, "adv_beats_mle",
                           ["--mle-epochs", "2", "--adv-rounds", "2", "--corpus", "64",
                            "--eval-every", "1"]),
    "leakgan_oracle_run": (leakgan_oracle_run, LEAKGAN_KEYS, "adv_beats_pretrain",
                           ["--pre-g", "2", "--pre-d", "1", "--adv", "2", "--corpus", "32",
                            "--eval-every", "1"]),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_main_on_cpu_prints_jax_keys(name, tmp_path, capsys):
    """``main([..., "--config", "tiny", "--device", "cpu"])``: the last line
    holds the JAX script's keys, the device, the card (none) and the wall;
    the exit code is 0 exactly when the pass flag is true."""
    module, keys, flag, argv = RUNS[name]
    rc = module.main([*argv, "--out", str(tmp_path), "--config", "tiny", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert keys | CARD_KEYS <= set(out), sorted(keys | CARD_KEYS - set(out))
    assert out["device"] == "cpu" and out["card"] is None and out["wall_s"] >= 0
    assert rc == (0 if out[flag] else 1)
    if name == "crnngan_quality_run":
        assert out["generated_events_reparsed"] == [32] * 4
        assert sorted(p.name for p in tmp_path.glob("gen_*.mid")) == sorted(
            f"gen_{g}_{c}.mid" for g, c in crnngan_quality_run.PATTERNS)
    else:
        assert (tmp_path / "trajectory.json").exists()
        assert np.isfinite([v for k, v in out.items() if k.endswith("oracle_nll")]).all()
    if name == "seqgan_quality_run":
        assert (tmp_path / "adv_samples.txt").read_text().count("\n") == 64
    assert set(out["steps"]) and all(s["busy_share"] is None for s in out["steps"].values())

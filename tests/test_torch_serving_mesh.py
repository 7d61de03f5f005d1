"""Serving on a data mesh of 2 gloo ranks on the CPU (the decode kernels'
plain versions): WaveNet and autoencoder ``generate_batch(mesh=...)``
equal ``mesh=None`` code for code (argmax, and categorical by the Philox
stream of each stream's global row), each rank returning its own rows and
writing only their wavs; the sessions' row partition against the JAX
package's for every process id; ``DecodeSession`` and ``AEDecodeSession``
on the mesh, with streams joining and leaving, equal to the single-device
sessions.  One spawned group of 2 ranks runs every case."""

import numpy as np
import pytest
import torch

import jax

from music_tpu.generate import serving as jserving
from music_tpu_torch.generate import serving as tserving
from music_tpu_torch.generate import wavenet_ae_generate as aegen
from music_tpu_torch.generate import wavenet_generate as wngen
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.ops.mulaw import mu_law_decode
from music_tpu_torch.parallel import launch
from music_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

TINY = wn.WaveNetConfig(dilations=(1, 2, 4, 8, 1, 2, 4, 8), dilation_channels=8,
                        residual_channels=8, skip_channels=16, quantization_channels=32)
AE_TINY = ae.WaveNetAEConfig(
    dilations=(1, 2, 4, 8, 1, 2, 4, 8), en_residual_channel=8, en_dilation_channel=8,
    de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16, en_bottleneck_width=12,
    en_pool_kernel_size=16, quantization_channel=32)
N = 5          # streams: rank 0 decodes rows 0-2, rank 1 rows 3-4
STEPS = 24     # samples a stream
K = 16         # session steps a call
P = TINY.receptive_field + max(TINY.dilations)
BATCH_CASES = {  # name: (sample_mode, dtype)
    "argmax f32": ("argmax", torch.float32),
    "categorical bf16": ("categorical", torch.bfloat16),
    "categorical f32": ("categorical", torch.float32),
}


def _params():
    return wn.init_params(TINY, torch.Generator().manual_seed(0))


def _ae_params():
    return ae.init_params(AE_TINY, torch.Generator().manual_seed(1))


def _primes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 32, (n, P + 3)).astype(np.int32)


def _clips():
    t = np.arange(120) / 16000
    return np.stack([0.6 * np.sin(2 * np.pi * f * t) for f in (440, 660, 990)]).astype(
        np.float32)


def _generate(mesh=None, out_dir=None):
    return {name: wngen.generate_batch(
        cfg=TINY, params=_params(), n=N, start_pieces=_primes(N), duration=STEPS / 16000,
        sample_mode=mode, dtype=dtype, seed=11, device="cpu", mesh=mesh,
        out_dir=None if out_dir is None else out_dir / name.replace(" ", "_"))
        for name, (mode, dtype) in BATCH_CASES.items()}


def _ae_generate(mesh=None, out_dir=None):
    return aegen.generate_batch(cfg=AE_TINY, params=_ae_params(), source_audios=_clips(),
                                device="cpu", mesh=mesh, out_dir=out_dir)


def _churn(session, primes, first):
    """Three calls over the streams ``first``, ``first + 1``: the second
    joins at the second call, the first leaves before the third, where
    stream ``first + 2`` joins.  ``{stream: codes}``."""
    out, sids = {}, {first: session.add(primes[first])}
    for call in range(3):
        if call == 1:
            sids[first + 1] = session.add(primes[first + 1])
        if call == 2:
            session.finish(sids.pop(first))
            sids[first + 2] = session.add(primes[first + 2])
        got = session.step()
        for stream, sid in sids.items():
            out.setdefault(stream, []).append(got[sid])
    return {s: np.concatenate(c) for s, c in out.items()}


def _ae_churn(session, codes, first):
    out, sids = {}, {first: session.add(codes[first])}
    for call in range(2):
        if call == 1:
            sids[first + 1] = session.add(codes[first + 1])
        got = session.step()
        for stream, sid in sids.items():
            out.setdefault(stream, []).append(got[sid])
    return {s: np.concatenate(c) for s, c in out.items()}


def _rank_cases(tmp):
    mesh = make_mesh(MeshSpec(data=2), device="cpu")
    r = mesh.index("data")
    out = {"generate": _generate(mesh, tmp / f"rank{r}"),
           "ae": _ae_generate(mesh, tmp / f"rank{r}" / "ae")}
    sess = tserving.DecodeSession(TINY, _params(), capacity=4, dtype=torch.float32,
                                  sample_mode="argmax", steps_per_call=K, device="cpu",
                                  mesh=mesh)
    out["capacity"] = sess.capacity
    out["session"] = _churn(sess, _primes(6, seed=2), first=3 * r)
    codes = [c for c in aegen._encode_sources(_ae_params(), _clips(), AE_TINY, "cpu")[0].numpy()]
    aes = tserving.AEDecodeSession(AE_TINY, _ae_params(), capacity=4, steps_per_call=K,
                                   device="cpu", mesh=mesh)
    out["ae_session"] = _ae_churn(aes, codes + codes, first=2 * r)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_mesh")
    return {"tmp": tmp, "ranks": launch.run(_rank_cases, 2, (tmp,))}


def _rows(rank):
    return range(0, 3) if rank == 0 else range(3, 5)


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_generate_batch_on_mesh_equals_mesh_none(run, name):
    """Each rank's rows equal ``mesh=None``'s exactly (categorical: stream
    ``i`` draws Philox ``(seed, i)`` on whichever rank decodes it); the
    other rows hold zero codes' audio; each rank wrote its rows' wavs."""
    ref = _generate()[name]
    zero = mu_law_decode(torch.zeros(STEPS, dtype=torch.int32), 32).numpy()
    for rank, r in enumerate(run["ranks"]):
        audio = r["generate"][name]
        assert audio.shape == (N, STEPS)
        for i in range(N):
            np.testing.assert_array_equal(audio[i], ref[i] if i in _rows(rank) else zero)
        wavs = sorted(p.name for p in (run["tmp"] / f"rank{rank}" / name.replace(" ", "_"))
                      .iterdir())
        assert wavs == [f"gen_{i:03d}.wav" for i in _rows(rank)]


def test_ae_generate_batch_on_mesh_equals_mesh_none(run):
    """Three clips on 2 ranks: rank 0 encodes and reconstructs clips 0-1,
    rank 1 clip 2, each equal to ``mesh=None``'s."""
    ref = _ae_generate()
    zero = mu_law_decode(torch.zeros(ref.shape[1], dtype=torch.int32), 32).numpy()
    for rank, r in enumerate(run["ranks"]):
        mine = range(0, 2) if rank == 0 else range(2, 3)
        for i in range(3):
            np.testing.assert_array_equal(r["ae"][i], ref[i] if i in mine else zero)
        wavs = sorted(p.name for p in (run["tmp"] / f"rank{rank}" / "ae").iterdir())
        assert wavs == [f"recon_{i:03d}.wav" for i in mine]


@pytest.mark.parametrize("rows,capacity,nproc", [(8, 8, 2), (8, 5, 2), (12, 7, 3), (16, 3, 4),
                                                 (4, 4, 4), (6, 1, 2)])
def test_partition_host_rows_matches_jax(monkeypatch, rows, capacity, nproc):
    """Every process id's ``(host_rows, host_capacity)``; the capacities sum
    to ``capacity``."""
    caps = []
    for pid in range(nproc):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        ours = tserving._partition_host_rows(rows, capacity, nproc, pid)
        assert ours == jserving._partition_host_rows(rows, capacity, nproc)
        caps.append(ours[1])
    assert sum(caps) == capacity
    with pytest.raises(ValueError, match="not divisible"):
        tserving._partition_host_rows(rows + 1, capacity, nproc, 0)


def test_decode_session_on_mesh_equals_single_device(run):
    """A total capacity of 4 is 2 a rank; on each rank a stream joins, one
    leaves and one joins over three calls, and every stream's codes equal
    the single-device session's under the same churn."""
    primes = _primes(6, seed=2)
    for rank, r in enumerate(run["ranks"]):
        assert r["capacity"] == 2
        ref = _churn(tserving.DecodeSession(TINY, _params(), capacity=2, dtype=torch.float32,
                                            sample_mode="argmax", steps_per_call=K,
                                            device="cpu"), primes, first=3 * rank)
        assert sorted(r["session"]) == sorted(ref)
        for s in ref:
            np.testing.assert_array_equal(r["session"][s], ref[s])


def test_ae_session_on_mesh_equals_single_device(run):
    codes = [c for c in aegen._encode_sources(_ae_params(), _clips(), AE_TINY, "cpu")[0].numpy()]
    for rank, r in enumerate(run["ranks"]):
        ref = _ae_churn(tserving.AEDecodeSession(AE_TINY, _ae_params(), capacity=2,
                                                 steps_per_call=K, device="cpu"),
                        codes + codes, first=2 * rank)
        for s in ref:
            np.testing.assert_array_equal(r["ae_session"][s], ref[s])


def test_serving_mesh_must_be_data_only():
    class Mesh:
        shape = {"data": 1, "seq": 2, "model": 1}

    with pytest.raises(ValueError, match="data-only"):
        wngen.generate_batch(cfg=TINY, params=_params(), n=1, mesh=Mesh())
    with pytest.raises(ValueError, match="data-only"):
        tserving.DecodeSession(TINY, _params(), mesh=Mesh())

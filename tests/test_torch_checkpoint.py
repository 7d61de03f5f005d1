"""The port's checkpoint I/O (music_tpu_torch.core.checkpoint) held against
music_tpu.core.checkpoint.save / restore_subtree: each package reads what
the other writes, exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.core import checkpoint as jckpt
from music_tpu.models import wavenet as jwn
from music_tpu.train.wavenet_train import TrainState
from music_tpu_torch.core import checkpoint as tckpt

TINY = jwn.WaveNetConfig(
    dilations=(1, 2, 4, 8, 1, 2, 4, 8), dilation_channels=8, residual_channels=8,
    skip_channels=16, quantization_channels=32,
)


@dataclasses.dataclass
class PortTrainState:
    params: dict
    step: int


def _params():
    return jwn.init_params(jax.random.PRNGKey(0), TINY)


@pytest.mark.parametrize("container", ["train_state", "dict"])
def test_port_reads_jax_checkpoint(tmp_path, container):
    # tolerance: none — the arrays travel through the same npz bytes
    params = _params()
    if container == "train_state":
        # the trainer's own state: leaves keyed .params['fg'], .opt_state...
        state = TrainState(params=params, opt_state={"mu": params["fg"] * 0.5},
                           step=jnp.asarray(7))
        prefix = ".params"
    else:
        state = {"params": params, "step": jnp.asarray(7)}
        prefix = "['params']"
    jckpt.save(tmp_path, 7, state)
    got = tckpt.restore_subtree(tmp_path, prefix=prefix)
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    assert tckpt.latest_step(tmp_path) == 7 == jckpt.latest_step(tmp_path)


def test_jax_reads_port_checkpoint(tmp_path):
    # tolerance: none
    g = torch.Generator().manual_seed(0)
    params = {k: torch.rand(np.asarray(v).shape, generator=g) for k, v in _params().items()}
    tckpt.save(tmp_path, 3, PortTrainState(params=params, step=3))
    example = jwn.init_params(jax.random.PRNGKey(1), TINY)
    got = jckpt.restore_subtree(tmp_path, example, prefix=".params")
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())
    assert int(tckpt.restore_subtree(tmp_path, prefix=".step")) == 3


@dataclasses.dataclass
class _EmaState:
    params: dict
    params_ema: dict


def test_prefix_selects_whole_keys(tmp_path):
    # ".params" is a string prefix of ".params_ema['w']", not a key path prefix
    tckpt.save(tmp_path, 1, _EmaState(params={"w": np.ones(2)}, params_ema={"w": np.zeros(2)}))
    got = tckpt.restore_subtree(tmp_path, prefix=".params")
    assert list(got) == ["w"]
    np.testing.assert_array_equal(got["w"], np.ones(2))


def test_nested_lists_and_rotation(tmp_path):
    state = {"a": [np.arange(3), (np.ones(2), np.zeros(1))], "b": {"c": 1.5}}
    for step in (1, 2, 3):
        tckpt.save(tmp_path, step, state, max_checkpoints=2)
    assert tckpt.all_steps(tmp_path) == [2, 3] == jckpt.all_steps(tmp_path)
    got = tckpt.restore_subtree(tmp_path, prefix="")
    np.testing.assert_array_equal(got["a"][0], np.arange(3))
    np.testing.assert_array_equal(got["a"][1][1], np.zeros(1))
    assert float(got["b"]["c"]) == 1.5
    with pytest.raises(KeyError):
        tckpt.restore_subtree(tmp_path, prefix=".params")

"""Token-corpus pipeline: text tokenization + .npy corpus artifacts.

Replaces leak_gan/encode.py (Chinese-poem tokenizer ``poem_to_tensor``
:6-49 / pretty-printer ``tensor_to_poem`` :51-62) and leak_gan/data.py
(``Real_Data_Set`` / ``Dis_Data_Set`` .npy loaders :6-49), plus the token
batch iterators both GANs use.  Artifact formats preserved: ``corpus.npy``
int64 ``[N, seq_len]``, ``chars.pkl`` vocabulary list, pos/neg ``.npy``
sample files (leak_gan/train.py:157-165).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np


def build_corpus(
    poems: Sequence[str],
    seq_len: int = 20,
    max_chars: int = 28,
) -> tuple[np.ndarray, list[str]]:
    """Tokenize poems to a fixed-length int corpus + vocabulary.

    Semantics of leak_gan/encode.py:6-49: characters map to 1-based indices
    (0 is reserved — the start token); poems longer than ``max_chars`` are
    dropped; sequences are truncated/zero-padded to ``seq_len``.
    """
    vocab: dict[str, int] = {}
    chars: list[str] = []
    rows = []
    for poem in poems:
        text = "".join(poem.split())
        if not text or len(text) > max_chars:
            continue
        ids = []
        for ch in text[:seq_len]:
            if ch not in vocab:
                vocab[ch] = len(chars) + 1  # 1-based
                chars.append(ch)
            ids.append(vocab[ch])
        ids += [0] * (seq_len - len(ids))
        rows.append(ids)
    return np.asarray(rows, np.int64), chars


def save_corpus(out_dir: str | Path, corpus: np.ndarray, chars: list[str]):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "corpus.npy", corpus)
    with (out_dir / "chars.pkl").open("wb") as f:
        pickle.dump(chars, f)


def load_corpus(data_dir: str | Path) -> tuple[np.ndarray, list[str]]:
    data_dir = Path(data_dir)
    corpus = np.load(data_dir / "corpus.npy")
    with (data_dir / "chars.pkl").open("rb") as f:
        chars = pickle.load(f)
    return corpus, chars


def tensor_to_poem(row: np.ndarray, chars: list[str], line_len: int = 5) -> str:
    """Inverse pretty-printer (leak_gan/encode.py:51-62): 1-based ids back
    to characters, ``line_len`` chars per line, stopping at padding."""
    out = []
    for i, v in enumerate(np.asarray(row)):
        v = int(v)
        if v == 0:
            break
        out.append(chars[v - 1])
        if (i + 1) % line_len == 0:
            out.append("\n")
    return "".join(out)


def token_batches(
    data: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: int | None = 1,
) -> Iterator[np.ndarray]:
    """Shuffling batch iterator over an [N, T] token matrix (replaces the
    DataLoader wrappers, leak_gan/data.py:37-49)."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(data)) if shuffle else np.arange(len(data))
        end = len(order) - (len(order) % batch_size) if drop_remainder else len(order)
        for i in range(0, end, batch_size):
            yield data[order[i : i + batch_size]]
        epoch += 1


def split_corpus(
    corpus: np.ndarray,
    *,
    eval_fraction: float = 1274 / 11274,
    gen_size: int = 128,
    test_size: int = 128,
    seed: int = 0,
    out_dir: str | Path | None = None,
) -> dict[str, np.ndarray]:
    """Train/eval/gen/test corpus splits — the reference's shipped artifact
    set (leak_gan/data/{train,eval,gen,test}_corpus.npy, sized
    [10000/1274/128/128] for its 11274-poem corpus; SURVEY.md §2.3).

    A seeded shuffle partitions the corpus into train/eval; ``gen`` and
    ``test`` are small subsets drawn from the train partition (matching the
    reference's sizes).  With ``out_dir``, writes ``<split>_corpus.npy``
    files alongside ``corpus.npy``.
    """
    n = len(corpus)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_eval = min(max(int(round(n * eval_fraction)), 1), n - 1)
    train, eval_ = corpus[order[n_eval:]], corpus[order[:n_eval]]
    gen = train[rng.permutation(len(train))[: min(gen_size, len(train))]]
    test = train[rng.permutation(len(train))[: min(test_size, len(train))]]
    splits = {"train": train, "eval": eval_, "gen": gen, "test": test}
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, arr in splits.items():
            np.save(out_dir / f"{name}_corpus.npy", arr)
    return splits

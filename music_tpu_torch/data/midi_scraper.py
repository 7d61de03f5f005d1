"""MIDI corpus scraper — host-side acquisition tooling.

Replaces c-rnn-gan/download_midi.py (a BeautifulSoup crawler over per-
composer index pages with a ``downloaded.txt`` dedup ledger,
download_midi.py:636-707).  Differences by design:

- stdlib-only (html.parser + urllib; no bs4 dependency);
- the composer -> index-URL table is DATA, not code: supplied as a JSON
  file ``{"genre/composer": ["http://...", ...]}`` rather than hardcoded
  (the reference embeds ~150 URL tables and two curated file lists inline,
  download_midi.py:1-633);
- polite by default: rate limiting, max-file caps, resumable ledger.

The sandbox this framework is developed in has no network egress; the
crawler is exercised in tests against local ``file://``-style fixtures via
the ``fetch`` injection point.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import urllib.request
from html.parser import HTMLParser
from pathlib import Path
from typing import Callable


class _LinkParser(HTMLParser):
    def __init__(self):
        super().__init__()
        self.links: list[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            for name, value in attrs:
                if name == "href" and value:
                    self.links.append(value)


def extract_midi_links(html: str, base_url: str) -> list[str]:
    """All absolute ``.mid``/``.midi`` links on a page."""
    parser = _LinkParser()
    parser.feed(html)
    out = []
    for href in parser.links:
        absolute = urllib.parse.urljoin(base_url, href)
        path = urllib.parse.urlparse(absolute).path.lower()
        if path.endswith(".mid") or path.endswith(".midi"):
            out.append(absolute)
    return out


def _default_fetch(url: str, timeout: float = 30.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def download(
    data_dir: str | Path,
    sources: dict[str, list[str]] | str | Path,
    *,
    fetch: Callable[[str], bytes] = _default_fetch,
    max_files_per_source: int | None = None,
    delay_seconds: float = 0.5,
) -> list[Path]:
    """Crawl index pages and download MIDI files into
    ``data_dir/<genre>/<composer>/``, skipping anything in the
    ``downloaded.txt`` ledger (download_midi.py:644-704 semantics).

    ``sources``: mapping ``"genre/composer" -> [index urls]``, or a path to
    a JSON file with that mapping.
    """
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    if not isinstance(sources, dict):
        sources = json.loads(Path(sources).read_text())

    ledger_path = data_dir / "downloaded.txt"
    ledger = set(
        ledger_path.read_text().splitlines() if ledger_path.exists() else []
    )
    written = []
    for key, urls in sources.items():
        target = data_dir.joinpath(*key.split("/"))
        target.mkdir(parents=True, exist_ok=True)
        count = 0
        for index_url in urls:
            try:
                html = fetch(index_url).decode("utf-8", "replace")
            except Exception:
                continue
            for link in extract_midi_links(html, index_url):
                if link in ledger:
                    continue
                if max_files_per_source is not None and count >= max_files_per_source:
                    break
                name = Path(urllib.parse.urlparse(link).path).name or "unnamed.mid"
                try:
                    data = fetch(link)
                except Exception:
                    continue
                out = target / name
                out.write_bytes(data)
                written.append(out)
                ledger.add(link)
                count += 1
                with ledger_path.open("a") as f:
                    f.write(link + "\n")
                if delay_seconds:
                    time.sleep(delay_seconds)
    return written


DEFAULT_SOURCES = Path(__file__).parent.parent / "params" / "c_rnn_gan" / "midi_sources.json"


def split_files(
    files: list[str | Path],
    *,
    validation_fraction: float = 0.2,
    test_fraction: float = 0.1,
    seed: int = 0,
) -> dict[str, list[str]]:
    """Deterministic train/validation/test split of downloaded MIDI paths.

    The reference ships two hand-curated file lists (310 validation + 155
    test names inline in download_midi.py:168-633); since the corpus
    content depends on what the crawl finds, this uses a seeded
    content-independent hash of each relative path instead — stable across
    runs and machines for the same file set.
    """
    import hashlib

    val, test, train = [], [], []
    for f in sorted(str(f) for f in files):
        h = int.from_bytes(
            hashlib.sha256(f"{seed}:{f}".encode()).digest()[:8], "big"
        ) / 2**64
        if h < validation_fraction:
            val.append(f)
        elif h < validation_fraction + test_fraction:
            test.append(f)
        else:
            train.append(f)
    return {"train": train, "validation": val, "test": test}


def write_split_lists(
    data_dir: str | Path,
    splits: dict[str, list[str]] | None = None,
    **split_kwargs,
) -> dict[str, list[str]]:
    """Write ``<split>_files.txt`` lists under ``data_dir`` (the usable
    equivalent of the reference's inline curated lists).  Paths are stored
    relative to ``data_dir``."""
    data_dir = Path(data_dir)
    if splits is None:
        files = [
            str(p.relative_to(data_dir)) for p in sorted(data_dir.rglob("*.mid"))
        ]
        splits = split_files(files, **split_kwargs)
    for name, paths in splits.items():
        (data_dir / f"{name}_files.txt").write_text(
            "\n".join(str(p) for p in paths) + ("\n" if paths else "")
        )
    return splits

"""Resource cache + downloader surface of the port: counterpart of
``deeplearning4j_tpu/utils/resources.py`` (ref: ``org.nd4j.common.resources
.Resources`` / ``Downloader`` — SURVEY J14: test fixtures and pretrained
artifacts are fetched once into a ``~/.nd4j``-style cache with checksum
verification).

Zero-egress adaptation: the API shape survives — cache directory resolution,
checksum verification, idempotent materialization — but the transport is
pluggable and the default ``fetcher`` refuses network cleanly. Callers that
have a local artifact (or a custom in-cluster fetcher) get the exact
reference workflow; everyone else gets an actionable error instead of a
hang.
"""
from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path
from typing import Callable, Optional


class ResourceError(IOError):
    pass


def cache_dir() -> Path:
    """ref: ND4JSystemProperties resource-dir override, default ~/.nd4j."""
    return Path(os.environ.get(
        "DL4J_TPU_RESOURCE_DIR",
        Path.home() / ".deeplearning4j_tpu" / "resources"))


def _md5(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Downloader:
    """ref: org.nd4j.common.resources.Downloader#download — idempotent
    materialize-into-cache with checksum verification and bounded retries.

    ``fetcher(url, dest_path)`` performs the transfer; the default raises
    (this environment has no egress). Supply e.g. a shared-filesystem copy
    fetcher in clusters.
    """

    def __init__(self, fetcher: Optional[Callable] = None, retries: int = 3):
        self.fetcher = fetcher or self._no_egress
        self.retries = retries

    @staticmethod
    def _no_egress(url: str, dest: Path):
        raise ResourceError(
            f"No network egress available to fetch {url!r}. Place the file "
            f"at the destination manually ({dest}) or construct "
            f"Downloader(fetcher=...) with a custom transport.")

    def download(self, url: str, dest: Path, md5: Optional[str] = None) -> Path:
        dest = Path(dest)
        if dest.exists() and (md5 is None or _md5(dest) == md5):
            return dest                      # cache hit
        dest.parent.mkdir(parents=True, exist_ok=True)
        last: Optional[Exception] = None
        for _ in range(max(1, self.retries)):
            try:
                self.fetcher(url, dest)
                if md5 is not None and _md5(dest) != md5:
                    raise ResourceError(f"checksum mismatch for {url!r}")
                return dest
            except Exception as e:           # noqa: BLE001 — any transport
                # failure must not leave a partial file behind to be served
                # as a future md5-less cache hit
                dest.unlink(missing_ok=True)
                last = e
                if self.fetcher is Downloader._no_egress:
                    break                    # retrying egress-refusal is noise
        raise ResourceError(
            f"download of {url!r} failed after {max(1, self.retries)} "
            f"attempt(s): {last}") from last

    downloadAndVerify = download


class Resources:
    """ref: org.nd4j.common.resources.Resources — named-resource resolution
    against the local cache."""

    _downloader = Downloader()

    @classmethod
    def set_downloader(cls, d: Downloader):
        cls._downloader = d

    @classmethod
    def local_path(cls, name: str) -> Path:
        return cache_dir() / name

    localPath = local_path

    @classmethod
    def exists(cls, name: str) -> bool:
        return cls.local_path(name).exists()

    @classmethod
    def as_file(cls, name: str, url: Optional[str] = None,
                md5: Optional[str] = None) -> Path:
        """Resolve a named resource; materialize through the downloader when
        absent (ref: Resources#asFile)."""
        p = cls.local_path(name)
        if p.exists() and (md5 is None or _md5(p) == md5):
            return p
        if url is None:
            raise ResourceError(
                f"resource {name!r} not present at {p} and no source url "
                f"given")
        return cls._downloader.download(url, p, md5)

    asFile = as_file

    @classmethod
    def install(cls, src_path, name: str) -> Path:
        """Copy a locally-available artifact into the cache (the zero-egress
        substitute for a first download)."""
        dest = cls.local_path(name)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src_path, dest)
        return dest

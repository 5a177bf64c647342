"""Stateful RNG facade: counterpart of ``deeplearning4j_tpu/ndarray/random.py``
(ref: ``org.nd4j.linalg.api.rng.DefaultRandom`` / ``Nd4j.getRandom()``).

DL4J's RNG is stateful and global; so is this one. It keeps one
``torch.Generator`` for each device, each seeded by :meth:`Random.setSeed`
and advanced by every draw, so eager draws behave statefully and every
draw is reproducible from the seed. The reference's draws come from
threefry keys, which torch cannot reproduce: the two packages agree in
distribution, not bit for bit. Generators are made on first use, so
importing this module touches no device.
"""
from __future__ import annotations

import threading

import torch


class Random:
    """Stateful RNG over one ``torch.Generator`` a device; thread-safe."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.setSeed(seed)

    def setSeed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._gens = {}            # device -> generator, made lazily

    def getSeed(self) -> int:
        return self._seed

    def generator(self, device) -> torch.Generator:
        """This device's generator; draws through it advance the state."""
        dev = torch.device(device)
        key = (dev.type, dev.index if dev.index is not None else (
            torch.cuda.current_device() if dev.type == "cuda" else 0))
        with self._lock:
            gen = self._gens.get(key)
            if gen is None:
                gen = torch.Generator(device=torch.device(dev.type, key[1])
                                      if dev.type == "cuda" else dev)
                gen.manual_seed(self._seed)
                self._gens[key] = gen
            return gen

    nextKey = generator


def seeded(seed: int, device) -> torch.Generator:
    """A fresh generator for one draw at an explicit seed."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


_global = Random(0)


def get_random() -> Random:
    return _global


def set_seed(seed: int):
    _global.setSeed(seed)


def next_key(device) -> torch.Generator:
    return _global.generator(device)

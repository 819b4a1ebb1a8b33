"""Unique names: the counterpart of ``paddle_tpu/utils/unique_name.py``
(ref: ``python/paddle/fluid/unique_name.py``).

A static Program names its variables with these (``conv2d.out_0``, a
parameter ``linear_0_w_0``), so the names of a program recorded here are
the JAX package's names for the same program. The generator is
process-global, with the reference's ``guard``/``switch``.
"""
from __future__ import annotations

import contextlib

__all__ = ["UniqueNameGenerator", "generate", "switch", "guard"]


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.ids: dict[str, int] = {}
        self.prefix = prefix

    def __call__(self, key):
        self.ids[key] = self.ids.get(key, -1) + 1
        return self.prefix + "_".join([key, str(self.ids[key])])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = (new_generator if new_generator is not None
                 else UniqueNameGenerator())
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)

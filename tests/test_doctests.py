"""Executable docstring examples — the parity analogue of the reference's
~30 rustdoc doctests (SURVEY.md §4)."""

import doctest

import pytest

import ibu_jax.constructs.header
import ibu_jax.constructs.record
import ibu_jax.io.compression
import ibu_jax.io.mmap
import ibu_jax.io.reader
import ibu_jax.io.writer
import ibu_jax.ops.codec
import ibu_jax.ops.u64
import ibu_jax.parallel.processor


@pytest.mark.parametrize(
    "module",
    [
        ibu_jax.constructs.header,
        ibu_jax.constructs.record,
        ibu_jax.io.compression,
        ibu_jax.io.mmap,
        ibu_jax.io.reader,
        ibu_jax.io.writer,
        ibu_jax.ops.codec,
        ibu_jax.ops.u64,
        ibu_jax.parallel.processor,
    ],
)
def test_module_doctests(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {module}"
    assert results.attempted > 0

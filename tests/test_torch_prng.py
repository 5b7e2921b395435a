# Copyright 2026 The kubeflow-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The port's threefry against ``jax.random`` on the same keys.

Keys and bits are uint32 and must be equal; uniforms are built from the
bits by exact float operations and must be bit-equal; Gumbel noise goes
through two logs that torch and XLA may round differently, so it is held
to 2e-6 absolute; categorical draws must pick the same tokens; integers
from ``randint`` must be equal, across shapes, seeds, ranges and types.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kubeflow_tpu_torch.inference import prng

SHAPES = [(5,), (3, 7), (2, 128256)]


def test_jax_runs_the_partitionable_threefry():
    # The port reproduces the partitionable counter layout; a JAX that
    # switched schemes would draw other bits from the same key.
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 100, 2**31 - 1, 2**32 + 5, -1, -7])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 37])
def test_split(num):
    key = jax.random.PRNGKey(42)
    got = prng.split(np.asarray(key), num)
    assert got.dtype == np.uint32 and got.shape == (num, 2)
    np.testing.assert_array_equal(got, np.asarray(jax.random.split(key,
                                                                   num)))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 + 3, 2**32 - 1])
def test_fold_in(data):
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        prng.fold_in(np.asarray(key), data),
        np.asarray(jax.random.fold_in(key, data)))


def test_fold_in_vector_is_vmapped():
    key = jax.random.PRNGKey(9)
    want = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(5))
    np.testing.assert_array_equal(prng.fold_in(np.asarray(key),
                                               np.arange(5)),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits(shape):
    key = jax.random.PRNGKey(42)
    got = prng.random_bits(np.asarray(key), shape)
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint32),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))


def test_random_bits_per_row_keys_are_vmapped():
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (1000,), jnp.uint32))(keys)
    got = prng.random_bits(np.asarray(keys), (4, 1000))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bit_equal(shape):
    key = jax.random.PRNGKey(11)
    got = prng.uniform(np.asarray(key), shape).numpy()
    want = np.asarray(jax.random.uniform(key, shape))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_with_bounds_bit_equal():
    key = jax.random.PRNGKey(12)
    tiny = float(np.finfo(np.float32).tiny)
    got = prng.uniform(np.asarray(key), (3, 1000), minval=tiny).numpy()
    want = np.asarray(jax.random.uniform(key, (3, 1000), minval=tiny))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_2e_6(shape):
    key = jax.random.PRNGKey(13)
    got = prng.gumbel(np.asarray(key), shape).numpy()
    want = np.asarray(jax.random.gumbel(key, shape))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_categorical_tokens_equal_over_64_draws():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((64, 4, 8192)) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    rows = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    # One jitted program per form for all 64 draws: a draw's shared key
    # covers its [4, V] logits; per-row keys cover one row each.
    shared = np.asarray(jax.jit(jax.vmap(jax.random.categorical))(
        keys, jnp.asarray(logits)))
    per_row = np.asarray(jax.jit(jax.vmap(jax.vmap(jax.random.categorical)))(
        rows, jnp.asarray(logits)))
    for i in range(64):
        x = torch.from_numpy(logits[i])
        np.testing.assert_array_equal(
            prng.categorical(np.asarray(keys[i]), x).numpy(), shared[i])
        np.testing.assert_array_equal(
            prng.categorical(np.asarray(rows[i]), x).numpy(), per_row[i])


def test_key_shape_is_checked():
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        prng.split(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="per-row keys"):
        prng.random_bits(np.zeros((3, 2), np.uint32), (4, 5))


RANDINT_DTYPES = [np.int32, np.uint32, np.int16, np.uint16, np.int8,
                  np.uint8]


@pytest.mark.parametrize("shape,lo,hi", [
    ((8, 128), 0, 128256),      # the decode benchmark's prompt, B = 8
    ((1, 128), 0, 32000),
    ((2, 8), 0, 512),
    ((5,), -2**31, 2**31 - 1),  # the widest int32 span
    ((5,), 0, 2**16),           # the span where the multiplier wraps
    ((3, 3), 7, 7),             # an empty range gives minval
    ((3, 3), 9, -4),
])
def test_randint_equals_jax(shape, lo, hi):
    key = jax.random.PRNGKey(0)
    got = prng.randint(np.asarray(key), shape, lo, hi)
    want = np.asarray(jax.random.randint(key, shape, lo, hi))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_randint_broadcast_bounds_equal_jax():
    key = jax.random.PRNGKey(5)
    lo, hi = np.array([0, 10, -4, 100]), np.array([[5], [50], [1000]])
    np.testing.assert_array_equal(
        prng.randint(np.asarray(key), (3, 4), lo, hi),
        np.asarray(jax.random.randint(key, (3, 4), lo, hi)))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(-2**31, 2**32 - 1),
       shape=st.sampled_from([(1,), (7,), (3, 5), (2, 3, 4)]),
       lo=st.integers(-2**31, 2**31 - 1),
       width=st.one_of(st.integers(-3, 300), st.integers(2**15, 2**17),
                       st.integers(0, 2**32)),
       dtype=st.sampled_from(RANDINT_DTYPES))
def test_randint_equals_jax_across_seeds_ranges_and_types(seed, shape, lo,
                                                          width, dtype):
    hi = int(np.clip(lo + width, -2**31, 2**31 - 1))
    key = jax.random.PRNGKey(seed)
    got = prng.randint(np.asarray(key), shape, lo, hi, dtype)
    want = np.asarray(jax.random.randint(key, shape, lo, hi, dtype))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_randint_refuses_what_jax_without_x64_lacks():
    with pytest.raises(TypeError, match="32-bit"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 5, np.int64)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2**33)

"""The plain versions of the port's bit and majority kernels against the TPU
kernels they replace, run in interpret mode on the CPU through the
reference's own tiling (ops.*(use_pallas=True)), and against the
reference's jnp oracles (use_pallas=False / kernels/ref.py):

  bits_pack   vs kernels/pack.py:47 pack_bits_pallas   (ops.pack_words)
  bits_unpack vs kernels/pack.py:61 unpack_bits_pallas (ops.unpack_words)
  majority    vs kernels/sign.py:83 majority_pallas    (ops.majority_words)

No statistic and no randomness enters these kernels, so every comparison
is bitwise: odd unit sizes, random words (padding bits included), n from
1 to 8 workers (ties at even n) and all-zero padding columns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import np_bits, reference

BIT_DIMS = [1, 31, 32, 33, 700, 1027]


def _words(n, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("d", BIT_DIMS)
def test_bits_plain_matches_pallas_and_reference(d):
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack import bits_pack_plain, bits_unpack_plain
    rng = np.random.default_rng(d)
    bits = rng.integers(0, 2, (3, d)).astype(np.int32)
    words = bits_pack_plain(torch.from_numpy(bits))
    assert words.shape == (3, ops.words_per_unit(d, 1))
    rand = _words(3, ops.words_per_unit(d, 1), seed=d + 1)
    dec = bits_unpack_plain(_i32(rand), d)
    assert dec.dtype == torch.int32
    assert np.array_equal(ops.unpack_words(words, d).numpy(), bits)
    with reference() as ref:
        for use_pallas in (True, False):
            for r in range(3):
                jw = ref.ops.pack_words(jnp.asarray(bits[r]),
                                        use_pallas=use_pallas)
                assert np.array_equal(np.asarray(jw), np_bits(words[r]))
                jd = ref.ops.unpack_words(jnp.asarray(rand[r]), d,
                                          use_pallas=use_pallas)
                assert np.array_equal(np.asarray(jd), dec[r].numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_majority_plain_matches_pallas_and_reference(n):
    from repro_torch.kernels import ops
    from repro_torch.kernels.sign import majority_plain
    W = 37
    words = _words(n, W, seed=n)
    words[:, -3:] = 0                      # zero padding columns vote 0
    if n % 2 == 0:                         # exact ties in one column
        words[: n // 2, 0] = 0xFFFFFFFF
        words[n // 2:, 0] = 0
    got = majority_plain(_i32(words))
    assert torch.equal(ops.majority_words(_i32(words)), got)
    assert np.all(np_bits(got)[-3:] == 0)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    want = ((2 * bits.sum(axis=0) >= n).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(axis=1).astype(np.uint32)
    assert np.array_equal(np_bits(got), want)
    with reference() as ref:
        for use_pallas in (True, False):
            jm = ref.ops.majority_words(jnp.asarray(words),
                                        use_pallas=use_pallas)
            assert np.array_equal(np.asarray(jm), np_bits(got))
        jr = ref.ops.ref.majority_words_ref(jnp.asarray(words))
        assert np.array_equal(np.asarray(jr), np_bits(got))


def test_majority_refuses_an_empty_or_oversized_vote():
    from repro_torch.kernels.sign import MAX_VOTERS, majority
    for n in (0, MAX_VOTERS + 1):
        with pytest.raises(ValueError, match="workers"):
            majority(torch.zeros((n, 4), dtype=torch.int32))


def test_bytes_moved_of_the_bit_and_majority_kernels():
    from repro_torch.kernels import ops
    assert ops.pack_bytes_moved(4, 70, 1, "bits") == {"read": 4 * 4 * 70,
                                                      "write": 4 * 4 * 3}
    assert ops.unpack_bytes_moved(4, 70, 1, "bits") == {
        "read": 4 * 4 * 3, "write": 4 * 4 * 70}
    assert ops.majority_bytes_moved(5, 3783) == {"read": 4 * 5 * 3783,
                                                 "write": 4 * 3783}

"""Carrying state from the JAX package to the port (`repro_torch.convert`).

JAX arrays reach the port as numpy; bf16 / fp8 ones come back from
`np.asarray` as ml_dtypes arrays, which the converter reinterprets bit for
bit.  Every check here is exact (bitwise) except the losses, which are
held at rtol 1e-13 (reduction order of the matvecs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.problems import make_appendix_c_problem as jax_toy
from repro.problems import make_quadratic_problem as jax_quadratic
from repro_torch.convert import problem_from_numpy, tensor_from_numpy, tree_from_numpy
from repro_torch.problems import make_quadratic_problem

pytestmark = pytest.mark.torch

PAIRS = [
    (jnp.float64, torch.float64), (jnp.float32, torch.float32),
    (jnp.bfloat16, torch.bfloat16), (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    (jnp.int32, torch.int32),
]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: str(p[1]))
def test_tensor_from_numpy_is_bitwise(pair):
    jdt, tdt = pair
    v = np.random.default_rng(0).standard_normal((5, 7)) * 40
    a = np.asarray(jnp.asarray(v).astype(jdt))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == tdt and tuple(t.shape) == a.shape
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    tw = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.dtype.itemsize]
    assert np.array_equal(
        t.view(tw).numpy().view(width), np.ascontiguousarray(a).view(width)
    )


def test_tree_from_numpy_casts_and_keeps_structure():
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": [np.ones(2), (np.zeros(1),)]}
    got = tree_from_numpy(tree, "cpu", dtype=torch.float32)
    assert got["a"].dtype == torch.float32 and got["a"].shape == (2, 3)
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))


def test_non_contiguous_and_read_only_inputs():
    a = np.asarray(jnp.arange(12.0).reshape(3, 4).T)
    t = tensor_from_numpy(a[::2], "cpu")
    assert np.array_equal(t.numpy(), a[::2])
    b = np.asarray(jnp.asarray(np.arange(6.0)).astype(jnp.bfloat16))[::2]
    assert tensor_from_numpy(b, "cpu").tolist() == [0.0, 2.0, 4.0]


def test_quadratic_problem_from_jax_data(rng):
    jp = jax_quadratic(rng, dim=6, num_samples=15, num_agents=3)
    tp = problem_from_numpy(
        "quadratic", {k: np.asarray(v) for k, v in jp.agent_data.items()}, "cpu"
    )
    assert tp.num_agents == 3
    for k in ("G", "Ab"):
        assert np.array_equal(tp.agent_data[k].numpy(), np.asarray(jp.agent_data[k]))
    x = np.linspace(-1, 1, 6)
    y = np.cos(np.arange(6.0))
    for i in range(3):
        got = tp.loss(torch.from_numpy(x), torch.from_numpy(y), tp.agent_slice(i))
        want = jp.loss(jnp.asarray(x), jnp.asarray(y), jp.agent_slice(i))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-13)


def test_toy_problem_from_jax_data():
    jp = jax_toy()
    tp = problem_from_numpy(
        "toy", {k: np.asarray(v) for k, v in jp.agent_data.items()}, "cpu"
    )
    got = tp.global_loss(torch.tensor(0.7, dtype=torch.float64),
                         torch.tensor(-0.2, dtype=torch.float64))
    want = jp.global_loss(jnp.asarray(0.7), jnp.asarray(-0.2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-15)
    with pytest.raises(ValueError, match="unknown problem kind"):
        problem_from_numpy("robust", {}, "cpu")


def test_port_builder_draws_the_paper_distribution():
    """The port's own builder (torch.Generator draws): shapes, dtype,
    symmetric PSD G_i, and determinism in the seed."""
    p1 = make_quadratic_problem(torch.Generator().manual_seed(3), dim=5,
                                num_samples=40, num_agents=4, device="cpu")
    p2 = make_quadratic_problem(torch.Generator().manual_seed(3), dim=5,
                                num_samples=40, num_agents=4, device="cpu")
    G = p1.agent_data["G"]
    assert G.shape == (4, 5, 5) and G.dtype == torch.float64
    assert p1.agent_data["Ab"].shape == (4, 5)
    torch.testing.assert_close(G, G.transpose(1, 2), rtol=1e-13, atol=0)
    assert bool((torch.linalg.eigvalsh(G) > 0).all())
    assert torch.equal(G, p2.agent_data["G"])
    # agent i's rows have std 2/i, so trace(G_i) shrinks like 1/i^2
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1)
    assert bool((tr[:-1] > tr[1:]).all())

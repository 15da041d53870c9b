"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and skips without one (a skip is not a
pass).  The file imports torch and the port only — no JAX — so it runs on
a machine without JAX, without the repository's JAX conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import core
from repro_torch.fed import GradientTracking
from repro_torch.kernels import gt_update, ref
from repro_torch.problems import make_quadratic_problem

pytestmark = pytest.mark.torch

ETA = 3e-3
DT = {
    "f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}
PAIRS = [
    ("f64", "f64"), ("f64", "f32"), ("f64", "bf16"), ("f64", "fp8"),
    ("f32", "f32"), ("f32", "bf16"), ("f32", "fp8"),
    ("bf16", "bf16"), ("bf16", "fp8"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("numel", [1, 1000, (1 << 20) + 17])
def test_cuda_gt_update_bitwise_equals_plain(cuda_device, pair, numel):
    zdt, cdt = pair
    gen = torch.Generator(device=cuda_device).manual_seed(numel)
    z, g, c = (
        torch.randn(numel, generator=gen, device=cuda_device) * 4
        for _ in range(3)
    )
    z, g, c = z.to(DT[zdt]), g.to(DT[zdt]), c.to(DT[cdt])
    gt_update.launches = 0
    for sign in (-1.0, 1.0):
        got = gt_update(z, g, c, eta=ETA, sign=sign)
        want = ref.gt_update_ref(z, g, c, ETA, sign)
        torch.cuda.synchronize()
        assert got.dtype == z.dtype and got.shape == z.shape
        assert torch.equal(_bits(got), _bits(want))
    assert gt_update.launches == 2


def test_cuda_gt_update_takes_any_shape_and_no_empty_launch(cuda_device):
    z = torch.randn(3, 5, 7, device=cuda_device, dtype=torch.float64)
    got = gt_update(z, z, z, eta=ETA, sign=1.0)
    assert torch.equal(got, ref.gt_update_ref(z, z, z, ETA, 1.0))
    gt_update.launches = 0
    e = torch.empty(0, device=cuda_device)
    assert gt_update(e, e, e, eta=ETA, sign=1.0).numel() == 0
    assert gt_update.launches == 0


def test_cuda_gt_update_raises_on_what_it_does_not_take(cuda_device):
    z = torch.zeros(8, 4, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gt_update(z.t(), z.t(), z.t(), eta=ETA, sign=1.0)
    with pytest.raises(TypeError, match="unsupported dtypes"):
        gt_update(z.half(), z.half(), z.half(), eta=ETA, sign=1.0)
    with pytest.raises(ValueError, match="different devices"):
        gt_update(z, z, z.cpu(), eta=ETA, sign=1.0)


@pytest.mark.parametrize("cdt", [None, torch.bfloat16, torch.float8_e4m3fn])
def test_cuda_round_through_kernel_equals_default_update(cuda_device, cdt):
    """FedGDA-GT rounds through the kernel reproduce the plain
    default_update's iterates bit for bit in f64, with (K-1)*2 launches
    per round.  The data are scaled by 2^-8 (eta by 2^8) so that every
    correction lies inside fp8 e4m3's +-448 range."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    prob = make_quadratic_problem(gen, dim=32, num_samples=64, num_agents=6,
                                  device=cuda_device)
    scale = 2.0 ** -8
    data = {k: v * scale for k, v in prob.agent_data.items()}
    eta, K = 1e-5 / scale, 5
    kernel = core.make_fedgda_gt_round(prob.loss, K, eta, correction_dtype=cdt)
    plain = core.make_fedgda_gt_round(prob.loss, K, eta, correction_dtype=cdt,
                                      update_fn=core.default_update)
    x = y = torch.zeros(32, dtype=torch.float64, device=cuda_device)
    xp, yp = x, y
    gt_update.launches = 0
    for _ in range(4):
        x, y = kernel(x, y, data)
        xp, yp = plain(xp, yp, data)
        assert bool(torch.isfinite(x).all() and torch.isfinite(y).all())
        assert torch.equal(x, xp) and torch.equal(y, yp)
    assert gt_update.launches == 4 * (K - 1) * 2


def test_cuda_fp8_correction_overflow_is_nan(cuda_device):
    """Beyond fp8 e4m3's range (|c| > 464) a correction is NaN, as in JAX:
    torch's own cast on the card does so, and the port's correction cast
    gives the same bits on the card as on the CPU."""
    v = torch.tensor([-600.0, -464.1, -464.0, 448.0, 464.0, 464.01, 600.0],
                     dtype=torch.float64)
    raw = v.to(cuda_device).to(torch.float8_e4m3fn).double().cpu()
    assert raw.isnan().tolist() == [True, True, False, False, False, True, True]
    z = torch.zeros_like(v)
    on_cpu, _ = core.tracking_corrections(v[None], z[None], z, z, torch.float8_e4m3fn)
    d = [t.to(cuda_device) for t in (v[None], z[None], z, z)]
    on_card, _ = core.tracking_corrections(*d, torch.float8_e4m3fn)
    assert torch.equal(_bits(on_card.cpu()), _bits(on_cpu))
    assert on_card[0].double().isnan().cpu().tolist() == raw.isnan().tolist()


def test_cuda_engine_uses_the_kernel_by_default(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    prob = make_quadratic_problem(gen, dim=8, num_samples=16, num_agents=1,
                                  device=cuda_device)
    x = torch.zeros(8, dtype=torch.float64, device=cuda_device)
    gt_update.launches = 0
    core.make_round(prob.loss, GradientTracking(), 3, 1e-4)(x, x, prob.agent_data)
    # m == 1: no fused anchor step, every local step is an update
    assert gt_update.launches == 3 * 2

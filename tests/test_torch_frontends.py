"""The port's input frontends (`repro_torch.models.frontends` and
`embed_inputs`) against the JAX package's: `batch_struct`'s shapes and
dtypes, `random_batch`'s layout (vision_text: -1 labels on the patch
positions), and the embedded inputs of the audio and vision_text
frontends at JAX's weights (carried across with `convert`) on the same
frames / patches / tokens, made from a seed with numpy, within 1e-6 of
the largest |value|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import frontends as jfrontends
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import batch_struct, embed_inputs, random_batch
from repro_torch.models.frontends import text_len

pytestmark = pytest.mark.torch

ARCHS = ["gemma2-2b", "pixtral-12b", "hubert-xlarge"]  # text, vision_text, audio
REL = 1e-6

# JAX's int32 is the port's int64 (torch indexes with int64)
DTYPES = {"int32": torch.int64, "float32": torch.float32}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("batch,seq_len", [(2, 32), (3, 64)])
def test_batch_struct_matches_jax(name, batch, seq_len):
    cfg = get_config(name).reduced()
    want = jfrontends.batch_struct(jget_config(name).reduced(), batch, seq_len,
                                   jnp.float32)
    got = batch_struct(cfg, batch, seq_len)
    assert list(got) == list(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape, k
        assert got[k].dtype == DTYPES[str(s.dtype)], k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("name", ARCHS)
def test_random_batch_layout(name):
    cfg = get_config(name).reduced()
    B, S = 2, 24
    b = random_batch(torch.Generator().manual_seed(0), cfg, B, S)
    struct = batch_struct(cfg, B, S)
    assert list(b) == list(struct)
    for k, t in b.items():
        assert t.shape == struct[k].shape and t.dtype == struct[k].dtype, k
    labels = b["labels"]
    if cfg.frontend == "vision_text":
        P = cfg.num_patches
        assert b["tokens"].shape == (B, S - P) and b["patches"].shape == (B, P, cfg.frontend_dim)
        assert (labels[:, :P] == -1).all()
        labels = labels[:, P:]
    assert ((labels >= 0) & (labels < cfg.vocab_size)).all()
    if "tokens" in b:
        assert ((b["tokens"] >= 0) & (b["tokens"] < cfg.vocab_size)).all()
    for k in ("frames", "patches"):
        if k in b:  # normal draws
            assert abs(float(b[k].mean())) < 0.2 and 0.8 < float(b[k].std()) < 1.2
    again = random_batch(torch.Generator().manual_seed(0), cfg, B, S)
    assert all(torch.equal(again[k], b[k]) for k in b)


def test_vision_text_needs_room_for_text():
    cfg = get_config("pixtral-12b").reduced()
    for S in (cfg.num_patches, cfg.num_patches - 1):
        with pytest.raises(ValueError, match="leaves no text"):
            random_batch(torch.Generator().manual_seed(0), cfg, 1, S)
        with pytest.raises(ValueError, match="leaves no text"):
            batch_struct(cfg, 1, S)
    assert text_len(cfg, cfg.num_patches + 1) == 1
    assert text_len(get_config("gemma2-2b").reduced(), 5) == 5


def _params(name):
    jcfg = jget_config(name).reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    cfg = get_config(name).reduced()
    return jcfg, jp, cfg, model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), f"{what}: {err:.3e}"


@pytest.mark.parametrize("with_patches", [True, False])
def test_vision_text_embed_inputs_match_jax(with_patches):
    """The patches projected through `frontend_proj` and placed before the
    token embeddings; without patches (a decode step) the tokens alone."""
    jcfg, jp, cfg, params = _params("pixtral-12b")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    batch = {"tokens": toks}
    if with_patches:
        batch["patches"] = rng.standard_normal((2, cfg.num_patches, cfg.frontend_dim)
                                               ).astype(np.float32)
    want = jtf.embed_inputs(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = embed_inputs(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 12 + (cfg.num_patches if with_patches else 0), cfg.d_model)
    _close(got, want, "vision_text embed_inputs")


def test_audio_embed_inputs_match_jax_and_want_frames():
    jcfg, jp, cfg, params = _params("hubert-xlarge")
    assert params.embed is None and params.out_head is not None
    frames = np.random.default_rng(2).standard_normal((2, 16, cfg.frontend_dim)
                                                      ).astype(np.float32)
    want = jtf.embed_inputs(jp, jcfg, {"frames": jnp.asarray(frames)})
    got = embed_inputs(params, cfg, {"frames": torch.from_numpy(frames)})
    _close(got, want, "audio embed_inputs")
    with pytest.raises(ValueError, match="frames"):
        embed_inputs(params, cfg, {"tokens": torch.zeros(2, 16, dtype=torch.long)})

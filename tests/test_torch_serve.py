"""The port's serving entry point (`repro_torch.launch.serve`) on the CPU at
reduced size: it runs end to end from its command line, and at weights
carried across from the JAX package its greedy tokens equal those of
JAX's prefill-then-decode loop (`repro/launch/serve.py`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import init_caches

pytestmark = pytest.mark.torch


def _jax_greedy(cfg, params, batch, decode_tokens):
    """JAX's serve loop (`repro/launch/serve.py` main) on a given prompt
    batch ({"tokens"}, + "patches" for vision_text, numpy)."""
    B = len(batch["tokens"])
    S = sum(v.shape[1] for v in batch.values())  # patches come first
    caches = jtf.init_caches(cfg, B, S + decode_tokens, jnp.float32)

    @jax.jit
    def prefill(params, batch, caches):
        h = jtf.embed_inputs(params, cfg, batch)
        h, caches, _ = jtf.forward(params, cfg, h, caches=caches)
        return jtf.logits_from_hidden(params, cfg, h[:, -1:]), caches

    @jax.jit
    def decode(params, caches, tok, pos):
        h = jtf.embed_inputs(params, cfg, {"tokens": tok})
        h, caches, _ = jtf.forward(params, cfg, h, caches=caches, position=pos)
        return jtf.logits_from_hidden(params, cfg, h), caches

    logits, caches = prefill(params, jax.tree.map(jnp.asarray, batch), caches)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks = [tok]
    for i in range(decode_tokens - 1):
        logits, caches = decode(params, caches, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
    return np.asarray(jnp.concatenate(toks, axis=1))


@pytest.mark.parametrize("arch,prompt_len", [
    ("zamba2-7b", 64), ("gemma2-2b", 128), ("llama4-scout-17b-a16e", 64),
    ("pixtral-12b", 40),  # 8 patches, then 32 text tokens
])
def test_greedy_tokens_equal_jax(arch, prompt_len):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    B, n = 2, 10
    rng = np.random.default_rng(1)
    n_patches = cfg.num_patches if cfg.frontend == "vision_text" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, prompt_len - n_patches))}
    if n_patches:
        batch["patches"] = rng.standard_normal(
            (B, n_patches, cfg.frontend_dim)).astype(np.float32)
    want = _jax_greedy(jcfg, jparams, dict(batch, tokens=batch["tokens"].astype(np.int32)), n)
    caches = init_caches(cfg, B, prompt_len + n, torch.float32, "cpu")
    prompts = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert serve.prompt_length(prompts) == prompt_len
    out = serve.generate(params, cfg, prompts, caches, n)
    assert out["tokens"].shape == (B, n)
    assert np.array_equal(out["tokens"].numpy(), want)
    assert out["step_logits"].shape == (B, n, cfg.vocab_size)
    # greedy: each token is the argmax of the logits that chose it
    assert torch.equal(out["step_logits"].argmax(-1), out["tokens"])


def test_main_runs_end_to_end_on_the_cpu(capsys):
    _main_end_to_end("zamba2-7b", capsys)


@pytest.mark.parametrize("arch", ["pixtral-12b", "llama4-scout-17b-a16e"])
def test_main_serves_vision_text_and_moe_on_the_cpu(arch, capsys):
    _main_end_to_end(arch, capsys)


def _main_end_to_end(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "32", "--decode-tokens", "6", "--seed", "3"]
    out = serve.main(argv)
    printed = capsys.readouterr().out
    assert "prefill [2x32]" in printed and "sample:" in printed
    assert out["tokens"].shape == (2, 6) and out["decode_steps"] == 5
    assert torch.isfinite(out["step_logits"]).all()
    assert out["device"] == "cpu" and out["peak_memory_bytes"] is None
    assert out["num_params"] == sum(p.numel() for p in out["params"].parameters())
    # on CPU tensors the wrappers run their plain versions: no launch
    zero = {"flash_attention": 0, "ssm_scan": 0}
    assert out["launches"] == {"prefill": zero, "decode": zero}
    # the same seed gives the same tokens; teacher forcing them through the
    # plain versions reproduces the logits
    again = serve.main(argv)
    assert torch.equal(again["tokens"], out["tokens"])
    cfg = out["cfg"]
    # the prompt batch fills prompt-len positions: pixtral's patches first
    assert serve.prompt_length(out["prompts"]) == 32
    assert ("patches" in out["prompts"]) == (cfg.frontend == "vision_text")
    plain = serve.generate(out["params"], cfg, out["prompts"],
                           init_caches(cfg, 2, 38, torch.float32, "cpu"), 6,
                           use_kernel=False, forced=out["tokens"])
    assert torch.equal(plain["step_logits"], out["step_logits"])


def test_main_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "zamba2-7b", "--reduced"])


@pytest.mark.parametrize("argv,match", [
    (["--temperature", "0.7"], "greedy"),
    (["--arch", "hubert-xlarge"], "encoder-only"),
    (["--decode-tokens", "0"], "decode-tokens"),
])
def test_main_refuses_what_it_does_not_serve(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--reduced", "--device", "cpu", *argv])

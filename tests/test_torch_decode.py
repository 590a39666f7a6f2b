"""The port's decode loop against the reference's on the CPU:
``ServingEngine`` at ``reduced(internlm2-1.8b)``, ``reduced(zamba2-1.2b)``
and ``reduced(xlstm-125m)`` with the reference's params carried across
in f32, temperature 0, the same requests through both engines.  The
generated tokens, the engine stats and the block table
(``kv_pages.allocated``, the index state) are compared exactly.  The
caches are ``init_caches``' defaults in both (bf16 KV and SSM state,
f32 xLSTM memories), so both round alike before the next step reads
them; at the end they agree leaf by leaf.  A slot taken by a new
request keeps the recurrent state its last request left (the
reference's behaviour: one global ``cache_index``, no reset).

Also: ``launch.serve.main`` on the CPU, and sampling at temperature > 0
(a ``torch.Generator`` seeded by the round: reproducible, but not the
reference's ``jax.random`` draws)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import model_params_from_reference
from repro_torch.kernels.lookup import fused_lookup
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from test_torch_ssm import BF16_STEP, BF16_STEPS, same_caches

STATS = ("decoded_tokens", "rounds", "page_lookups", "kv_epoch",
         "kv_delta_updates", "kv_refreezes")


def _requests(cls, vocab, n, seed):
    """The launcher's traffic: prompts of 4-23 tokens uniform below
    ``vocab``, varied ``max_new_tokens`` so requests finish apart."""
    rng = np.random.default_rng(seed)
    return [cls(request_id=rid,
                prompt=rng.integers(0, vocab, rng.integers(4, 24),
                                    dtype=np.int32),
                max_new_tokens=int(rng.integers(3, 12)))
            for rid in range(1, n + 1)]


DECODE_ARCHS = ("internlm2-1.8b", "zamba2-1.2b", "xlstm-125m")


def _engines(max_batch=4, max_len=64, arch="internlm2-1.8b"):
    rcfg, cfg = ref_reduced(REF_ARCHS[arch]), reduced(ARCHS[arch])
    rmodel, model = ref_build(rcfg), build_model(cfg)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      rmodel.init_params(jax.random.PRNGKey(5)))
    ref = RefEngine(rmodel, max_batch=max_batch, max_len=max_len)
    ref.load(rp)
    port = ServingEngine(model, max_batch=max_batch, max_len=max_len,
                         device="cpu")
    port.load(model_params_from_reference(
        jax.tree.map(np.asarray, rp), device="cpu"))
    return ref, port, cfg


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_serving_engine_matches_reference(arch):
    ref, port, cfg = _engines(arch=arch)
    served = {"internlm2-1.8b": lambda c: c[0]["k"],
              "zamba2-1.2b": lambda c: c["ssm"].state,
              "xlstm-125m": lambda c: c["b0"].c}[arch](port.caches)
    assert served.dtype == (torch.float32 if arch == "xlstm-125m"
                            else torch.bfloat16)
    r_reqs = _requests(RefRequest, cfg.vocab, 10, seed=3)
    p_reqs = _requests(Request, cfg.vocab, 10, seed=3)
    for a, b in zip(r_reqs, p_reqs):
        ref.submit(a)
        port.submit(b)
    launches0 = fused_lookup.launches
    rs, ps = ref.run_until_done(), port.run_until_done()
    for a, b in zip(r_reqs, p_reqs):
        assert b.done and a.done
        assert b.generated == a.generated, b.request_id
        assert all(0 <= t < cfg.vocab for t in b.generated)
    assert {k: ps[k] for k in STATS} == {k: rs[k] for k in STATS}
    assert ps["decoded_tokens"] == sum(r.max_new_tokens for r in p_reqs)
    assert port.kv_pages.allocated == ref.kv_pages.allocated
    assert port.kv_pages.free_pages == ref.kv_pages.free_pages
    rg, pg = ref.kv_pages.index.gapped, port.kv_pages.index.gapped
    assert np.array_equal(rg.slot_key, pg.slot_key)
    assert np.array_equal(rg.payload, pg.payload)
    # the reference's queue counters; the port's adds lookup_keys (one
    # key a page lookup) and lookup_wait_ms_sum
    qs = port.aggregator.stats
    assert {k: qs[k] for k in ref.aggregator.stats} == ref.aggregator.stats
    assert qs["lookup_keys"] == ps["page_lookups"]
    # the CPU run resolves pages on the kernel's plain version
    assert fused_lookup.launches == launches0
    # 10 requests through 4 slots: slots were taken again, and the
    # caches (recurrent state carried across requests) are the
    # reference's; bf16 leaves within 8 bf16 steps of their scale
    assert len({b.slot for b in p_reqs}) == 4
    same_caches(port.caches, ref.caches, 1e-4, BF16_STEPS * BF16_STEP)


def test_sampling_at_temperature_is_reproducible():
    _ref, port, cfg = _engines()
    logits = np.random.default_rng(0).standard_normal(
        (4, 256)).astype(np.float32)
    port.temperature = 0.8
    a = port._sample(logits)
    b = port._sample(logits)
    assert np.array_equal(a, b) and a.shape == (4,)
    assert ((0 <= a) & (a < 256)).all()
    port.stats["rounds"] += 1
    draws = {tuple(port._sample(logits)) for _ in range(3)}
    assert len(draws) == 1
    port.temperature = 0.0
    assert np.array_equal(port._sample(logits), logits.argmax(-1))
    assert cfg.vocab == 256


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_serve_launcher_on_the_cpu(capsys, arch):
    stats = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                        "--requests", "5", "--max-new", "6",
                        "--max-batch", "2", "--max-len", "64"])
    assert stats["decoded_tokens"] == 30
    assert stats["page_lookups"] == 30
    assert stats["kv_epoch"] > 0
    assert "[serve] decoded=30 tokens" in capsys.readouterr().out

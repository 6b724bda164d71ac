"""The checkpoint policy on the port's training path: ``tag``,
``RematPlan.policy``, ``offload_policy`` and their realisation around each
block (``repro_torch.core.remat``).

Reduced llama3.2-3b and granite-moe-1b-a400m in fp32 at S = 48 > block_q,
so attention takes the flash path.  Remat on computes the same function as
remat off (bit for bit on the CPU), the bytes each block holds for its
backward are those of the tensors the policy keeps or offloads, and a
kernel whose output the policy keeps or offloads is not run again in the
block's replay.
"""


import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import remat  # noqa: E402
from repro_torch.core.offload import (offload_lowering,  # noqa: E402
                                      offload_policy)
from repro_torch.core.plan import MemoryPlanConfig, compile_plan  # noqa: E402
from repro_torch.core.remat_policy import (CheckpointPolicy,  # noqa: E402
                                           RematPlan, tag)
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as SK  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402

torch.set_num_threads(1)

B, S = 2, 48
ARCH_NAMES = ["llama3.2-3b", "granite-moe-1b-a400m"]
# (name, config overrides): the default plan keeps all four tags; a zero
# budget recomputes all; with the offload lane priced cheap and a small
# budget some go to the host (llama: mlp_hidden and mlp_out; granite,
# whose experts make mlp_hidden the largest: qkv and attn_out)
POLICIES = {
    "keep": dict(remat=True),
    "recompute": dict(remat=True, remat_budget_bytes=0),
    "offload": dict(remat=True, offload=True, dma_gbps=1e6,
                    remat_budget_bytes=B * S * 64 * 2 * 2),
}


def _cfg(arch, **kw):
    return reduce_config(ARCHS[arch], n_layers=2, attention_impl="pallas",
                         block_q=32, block_kv=32, dtype="float32", **kw)


def _run(cfg, seed=0):
    """(loss, grads by name, each block's RegionStats) of one backward."""
    model = build_model(cfg)
    params = model.init(seed, device="cpu", trainable=True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
    with remat.observe_regions() as stats:
        loss = model.loss_fn(params, {"tokens": toks[:, :-1],
                                      "targets": toks[:, 1:]})
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in params.named_parameters()}, \
        stats


def _tagged_bytes(cfg):
    """Bytes of each tensor the port tags in one block (fp32)."""
    if cfg.is_moe:
        cap = -(-S * cfg.top_k * 5 // (4 * cfg.n_experts))   # x 1.25
        hidden = cfg.n_experts * B * cap * cfg.moe_d_ff
    else:
        hidden = B * S * cfg.d_ff
    q = B * S * cfg.n_heads * cfg.head_dim
    return {"qkv": 4 * q, "attn_out": 4 * q, "mlp_hidden": 4 * hidden}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_on_equals_remat_off(arch, policy):
    """Every policy computes the function remat off computes: the loss and
    every gradient equal, bit for bit on the CPU."""
    loss, grads, stats = _run(_cfg(arch, **POLICIES[policy]))
    want_loss, want, none = _run(_cfg(arch, remat=False))
    assert not none and len(stats) == 2
    assert torch.equal(loss, want_loss)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_held_bytes_are_the_tagged_tensors(arch, policy):
    """Per block, the bytes kept on the device and copied to the host are
    those of the tensors the plan's decisions keep and offload (the block
    input besides); ``mlp_out`` is never a residual (only an addition
    reads it), so no plan decision about it holds a byte, as in JAX."""
    cfg = _cfg(arch, **POLICIES[policy])
    decisions = compile_plan(cfg, batch_tokens=B * S).remat_plan.decisions()
    tagged = _tagged_bytes(cfg)
    kept = {n: b for n, b in tagged.items() if decisions[n] == "keep"}
    offloaded = {n: b for n, b in tagged.items()
                 if decisions[n] == "offload"}
    if policy == "offload":
        assert offloaded
    _, _, stats = _run(cfg)
    for s in stats:
        assert s.kept == kept and s.offloaded == offloaded
        assert s.input_bytes == 4 * B * S * cfg.d_model
        assert s.dropped_residuals > 0 and s.replays == 1


@pytest.mark.parametrize("policy,again", [("keep", 0), ("recompute", 1),
                                          ("offload", 0)])
def test_replay_runs_a_kernel_only_where_the_plan_recomputes(
        monkeypatch, policy, again):
    """Forward launches plus one per block whose replay recomputes the
    kernel's output: attention and the SwiGLU hidden kept or offloaded are
    not computed again (the backwards recompute through their own plain
    formulations, which are not forward launches)."""
    calls = {"flash": 0, "swiglu": 0}
    flash_fwd, swiglu_fwd = FK.flash_attention_fwd, SK._forward

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    from repro_torch.kernels.flash_attention import ops
    monkeypatch.setattr(ops, "flash_attention_fwd", count("flash", flash_fwd))
    monkeypatch.setattr(SK, "_forward", count("swiglu", swiglu_fwd))
    cfg = _cfg("llama3.2-3b", **POLICIES[policy])
    _run(cfg)
    assert calls == {"flash": 2 * (1 + again), "swiglu": 2 * (1 + again)}


def test_policy_objects():
    """``RematPlan.policy``, ``offload_policy`` and the compiled plan's
    ``offload_policy`` say what the plan decided; the lowering is native."""
    rp = RematPlan(("qkv", "attn_out"), ("mlp_out",), 0, 0.0,
                   offloaded=("mlp_hidden",))
    assert rp.policy() == CheckpointPolicy(saved=("qkv", "attn_out"),
                                           offloaded=("mlp_hidden",))
    pol = offload_policy(["mlp_hidden"], saved=["qkv"])
    assert [pol.decision(n) for n in ("qkv", "mlp_hidden", "mlp_out",
                                      "block_out")] == \
        ["keep", "offload", "recompute", "recompute"]
    assert offload_lowering() == "native"
    cfg = _cfg("llama3.2-3b", **POLICIES["offload"])
    cp = compile_plan(cfg, batch_tokens=B * S)
    assert cp.offload_policy.offloaded == cp.remat_plan.offloaded
    assert cp.report()["offload_lowering"] == "native"
    off = compile_plan(_cfg("llama3.2-3b", remat=False),
                       MemoryPlanConfig(), batch_tokens=B * S)
    assert off.offload_policy is None


def test_tag_is_the_identity_outside_a_checkpoint():
    x = torch.ones(3, requires_grad=True)
    assert tag("qkv", x) is x
    with torch.no_grad(), remat.observe_regions() as stats:
        model = build_model(_cfg("llama3.2-3b", remat=True))
        params = model.init(0, device="cpu")
        model.forward(params, {"tokens": torch.zeros(1, S,
                                                     dtype=torch.long)})
    assert stats == []


def test_a_block_backpropagates_once():
    """The replay hands each residual over once: a second backward through
    the same graph raises instead of reading freed state."""
    cfg = _cfg("llama3.2-3b", remat=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu", trainable=True)
    toks = torch.zeros(1, S + 1, dtype=torch.long)
    loss = model.loss_fn(params, {"tokens": toks[:, :-1],
                                  "targets": toks[:, 1:]})
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="twice"):
        loss.backward()


def test_offload_policy_copies_to_the_host():
    """An offloaded residual leaves the block as a host copy of its whole
    storage, and comes back equal."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    policy = offload_policy(["h"])

    def block(x):
        h = tag("h", torch.tanh(x @ w))
        return (h @ w).sum(-1)

    out, region = remat.checkpoint(policy, block, x)
    out.sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    block(x).sum().backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)
    assert region.stats.offloaded == {"h": 4 * 8 * 4}
    assert region.stats.kept == {}

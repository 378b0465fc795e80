"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU: the three
MoE cases of ``tests/test_components.py`` (per-token reference, capacity
drops, the uniform load-balance loss) on the port, and ``moe_ffn``
against the reference's on the same inputs where capacity drops tokens
and where the router ties two experts. Routing (the chosen experts, the
keep mask and each kept choice's slot) must match exactly; outputs and
router probabilities within 1e-5 of the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as jmoe

from repro_torch.models import moe as tmoe


def _params(rng, D, E, Fh, scale=0.2, router_scale=0.5):
    return {"router": rng.normal(0, router_scale, (D, E)).astype(np.float32),
            "w1": rng.normal(0, scale, (E, D, Fh)).astype(np.float32),
            "w3": rng.normal(0, scale, (E, D, Fh)).astype(np.float32),
            "w2": rng.normal(0, scale, (E, Fh, D)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ref_route(x, router, k, C):
    """The reference's routing steps (``repro/models/moe.py:43-57``), in
    JAX: its chosen experts, keep mask and slots."""
    E = router.shape[1]
    probs = jax.nn.softmax(jnp.dot(x, router).astype(jnp.float32), axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    flat_e = top_i.reshape(-1)
    Tk = flat_e.shape[0]
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    onehot_starts = jnp.zeros((E,), jnp.int32).at[sorted_e].add(1)
    starts = jnp.cumsum(onehot_starts) - onehot_starts
    rank_sorted = jnp.arange(Tk, dtype=jnp.int32) - starts[sorted_e]
    rank = jnp.zeros((Tk,), jnp.int32).at[order].set(rank_sorted)
    keep = rank < C
    return (np.asarray(top_i), np.asarray(keep),
            np.asarray(jnp.where(keep, rank, 0)))


def _close(got, want, ctx, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, ctx


# -- tests/test_components.py's MoE cases, on the port

def test_moe_matches_per_token_reference():
    T, D, E, Fh, k = 48, 8, 4, 16, 2
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (T, D)).astype(np.float32))
    params = _t(_params(rng, D, E, Fh))
    y, probs = tmoe.moe_ffn(x, params, top_k=k, capacity_factor=100.0)
    p = torch.softmax(x @ params["router"], -1)
    tv, ti = torch.topk(p, k)
    tv = tv / tv.sum(-1, keepdim=True)
    want = torch.zeros((T, D))
    for t in range(T):
        for j in range(k):
            e = int(ti[t, j])
            h = F.silu(x[t] @ params["w1"][e]) * (x[t] @ params["w3"][e])
            want[t] += float(tv[t, j]) * (h @ params["w2"][e])
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=2e-5)
    np.testing.assert_allclose(probs.numpy(), p.numpy(), atol=1e-6)


def test_moe_capacity_drops_tokens():
    T, D, E = 64, 8, 4
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (T, D))).astype(
        np.float32) + 0.1)
    router = torch.zeros((D, E))
    router[:, 0] = 10.0                 # x > 0: expert 0 wins every token
    params = {"router": router, "w1": torch.ones((E, D, 8)) * 0.1,
              "w3": torch.ones((E, D, 8)) * 0.1,
              "w2": torch.ones((E, 8, D)) * 0.1}
    y, _ = tmoe.moe_ffn(x, params, top_k=1, capacity_factor=0.25)
    # capacity = max(8, T·1·0.25/4 = 4) = 8 slots on expert 0
    zero_rows = int((y.abs().sum(dim=1) == 0).sum())
    assert zero_rows >= T - 8


def test_load_balance_loss_uniform_is_one():
    probs = torch.full((128, 8), 1.0 / 8)
    assert float(tmoe.load_balance_loss(probs)) == pytest.approx(1.0)
    assert tmoe.moe_capacity(1024, 8, 2, 1.0) == 256
    # the counted form (top-k ids) against the reference's
    rng = np.random.default_rng(2)
    p = rng.dirichlet(np.ones(8), 64).astype(np.float32)
    ids = rng.integers(0, 8, (64, 2)).astype(np.int32)
    got = tmoe.load_balance_loss(torch.from_numpy(p),
                                 torch.from_numpy(ids).long())
    want = jmoe.load_balance_loss(jnp.asarray(p), jnp.asarray(ids))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("n_tokens,n_experts,k,factor",
                         [(48, 4, 2, 1.0), (1000, 8, 2, 1.25),
                          (7, 128, 8, 1.0), (4096, 32, 8, 0.5)])
def test_moe_capacity_matches_reference(n_tokens, n_experts, k, factor):
    assert tmoe.moe_capacity(n_tokens, n_experts, k, factor) == \
        jmoe.moe_capacity(n_tokens, n_experts, k, factor)


# -- moe_ffn against the reference

@pytest.mark.parametrize("activation", ["swiglu", "squared_relu"])
def test_moe_ffn_drops_as_reference(activation):
    """Capacity 8 against 40 chosen slots an expert on average: many
    (token, choice) pairs drop. Experts, keep mask and slots equal the
    reference's exactly; outputs and probs within 1e-5."""
    T, D, E, Fh, k = 160, 16, 8, 32, 2
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    params = _params(rng, D, E, Fh)
    if activation != "swiglu":
        del params["w3"]
    cf = 0.2
    C = tmoe.moe_capacity(T, E, k, cf)
    assert C == 8
    top_i, keep, slot = _ref_route(jnp.asarray(x),
                                   jnp.asarray(params["router"]), k, C)
    assert 0 < keep.sum() < keep.size          # some drop, some stay
    _, _, t_i, flat_e, t_slot, t_keep = tmoe.route(
        torch.from_numpy(x), torch.from_numpy(params["router"]), k=k,
        capacity=C)
    np.testing.assert_array_equal(t_i.numpy(), top_i)
    np.testing.assert_array_equal(flat_e.numpy(), top_i.reshape(-1))
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    y_t, p_t = tmoe.moe_ffn(torch.from_numpy(x), _t(params), top_k=k,
                            capacity_factor=cf, activation=activation)
    y_j, p_j = jmoe.moe_ffn(jnp.asarray(x), _j(params), top_k=k,
                            capacity_factor=cf, activation=activation)
    _close(y_t.numpy(), y_j, f"{activation} y")
    _close(p_t.numpy(), p_j, f"{activation} probs")
    # a dropped pair adds nothing: rows whose every choice dropped are 0
    dropped = ~keep.reshape(T, k).any(axis=1)
    assert dropped.any()
    assert not y_t.numpy()[dropped].any()


def test_moe_ffn_router_tie_picks_reference_experts():
    """Two router columns equal, so experts 1 and 2 tie on every token:
    the lower index comes first, as ``jax.lax.top_k`` orders it."""
    T, D, E, Fh, k = 32, 8, 4, 16, 1
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    params = _params(rng, D, E, Fh)
    r = params["router"]
    r[:, 2] = r[:, 1]
    r[:, 0] = r[:, 1] - 5.0               # experts 0 and 3 lose
    r[:, 3] = r[:, 1] - 5.0
    x = np.abs(x)                          # x·(r1 − 5) < x·r1
    C = tmoe.moe_capacity(T, E, k, 4.0)
    top_i, keep, slot = _ref_route(jnp.asarray(x), jnp.asarray(r), k, C)
    assert (top_i == 1).all()
    _, _, t_i, _, t_slot, t_keep = tmoe.route(
        torch.from_numpy(x), torch.from_numpy(r), k=k, capacity=C)
    np.testing.assert_array_equal(t_i.numpy(), top_i)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    # top-2: both tied experts, lower index first
    _, t2 = tmoe.topk_stable(torch.tensor([[0.1, 0.4, 0.4, 0.1]]), 2)
    assert t2.tolist() == [[1, 2]]
    y_t, _ = tmoe.moe_ffn(torch.from_numpy(x), _t(params), top_k=k,
                          capacity_factor=4.0)
    y_j, _ = jmoe.moe_ffn(jnp.asarray(x), _j(params), top_k=k,
                          capacity_factor=4.0)
    _close(y_t.numpy(), y_j, "tie y")


def test_moe_ffn_rejects_a_mesh():
    # a mesh must be a DeviceMesh: any other object is refused
    with pytest.raises(TypeError, match="needs a DeviceMesh"):
        tmoe.moe_ffn(torch.zeros((8, 4)), {"router": torch.zeros((4, 2))},
                     top_k=1, capacity_factor=1.0, mesh=object())

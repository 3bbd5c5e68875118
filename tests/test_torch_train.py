"""The port's QAT trainer (``quant_gemm_tpu_torch.models.train``) against
the JAX package's, on the CPU at a tiny size: the fake quantization, the
loss and its gradients, each optimizer's step at optax's defaults, and the
JAX trainer's own tests mirrored; train states and ``formats/checkpoint``
files carried across both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quant_gemm_tpu.formats import checkpoint as jckpt
from quant_gemm_tpu.formats import numpy_ref as jnr
from quant_gemm_tpu.models import llama as jllama
from quant_gemm_tpu.models import train as jtrain
from quant_gemm_tpu_torch.formats import checkpoint, quant
from quant_gemm_tpu_torch.models import llama, train

CFG = llama.LlamaConfig(vocab=64, dim=64, n_layers=2, n_heads=2,
                        n_kv_heads=2, d_ff=128, max_seq=32)
JCFG = jllama.LlamaConfig(**CFG._asdict())
QTYPES = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q8_1")


def _tokens(batch=4, t=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG.vocab, (batch, t)).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    return llama.init_params(CFG, seed=0)


def _torch(params):
    return train.unflatten(params, [torch.tensor(np.asarray(p, np.float32))
                                    for p in train.leaves(params)])


def _jax_vg(params, cfg, toks, qtype="q4_0", remat=False):
    fn = jax.jit(jax.value_and_grad(jtrain.loss_fn),
                 static_argnums=(1, 3, 4))
    p = jax.tree.map(jnp.asarray, params)
    return fn(p, jllama.LlamaConfig(**cfg._asdict()), jnp.asarray(toks),
              qtype, remat)


@pytest.mark.parametrize("qtype", QTYPES)
def test_fake_quant_ste_bit_equal_with_identity_gradient(qtype):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((48, 128)) * 0.3).astype(np.float32)
    w[3, :32] = 0.0  # a zero block
    want = np.asarray(jtrain.fake_quant_ste(jnp.asarray(w), qtype))
    tw = torch.tensor(w, requires_grad=True)
    got = train.fake_quant_ste(tw, qtype)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    c = torch.tensor(rng.standard_normal(w.shape).astype(np.float32))
    (got * c).sum().backward()
    assert torch.equal(tw.grad, c)


@pytest.mark.parametrize("remat,t", [(False, 16), (True, 16), (False, 72)])
def test_loss_and_grads_match_jax(params, remat, t):
    cfg = CFG._replace(max_seq=128) if t > 32 else CFG
    toks = _tokens(batch=2 if t > 32 else 4, t=t, seed=3)
    jl, jg = _jax_vg(params, cfg, toks, "q4_0", remat)
    loss, grads = train.value_and_grad(_torch(params), cfg,
                                       torch.tensor(toks), "q4_0", remat)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    got, want = train.leaves(grads), jax.tree.leaves(jg)
    assert len(got) == len(want) == 2 + 9 * CFG.n_layers + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "lion"])
def test_optimizer_steps_match_optax(params, name):
    """Two steps on the same gradients at each optimizer's defaults."""
    rng = np.random.default_rng(4)
    grads = [[(rng.standard_normal(np.shape(p)) * 1e-2).astype(np.float32)
              for p in train.leaves(params)] for _ in range(2)]
    tx = jtrain.make_optimizer(name, 1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = _torch(params)
    for p in train.leaves(tp):
        p.requires_grad_()
    opt = train.make_optimizer(name, 1e-3).init(tp)
    for g in grads:
        jgr = jax.tree.unflatten(jax.tree.structure(jp),
                                 [jnp.asarray(x) for x in g])
        upd, state = tx.update(jgr, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(train.leaves(tp), g):
            p.grad = torch.tensor(x)
        opt.step()
    for a, b in zip(train.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


def test_optimizer_defaults_are_optax():
    tp = _torch(llama.init_params(CFG, seed=0))
    adamw = train.make_optimizer("adamw").init(tp)
    assert adamw.defaults["weight_decay"] == 1e-4
    assert train.make_optimizer("sgd").init(tp).defaults["momentum"] == 0.0
    lion = train.make_optimizer("lion").init(tp).defaults
    assert lion["betas"] == (0.9, 0.99) and lion["weight_decay"] == 1e-3
    with pytest.raises(TypeError):
        train.make_optimizer("adamw", 1e-3, betas=(0.9, 0.9))


def test_sgd_loss_decreases(params):
    toks = torch.tensor(_tokens())
    p = _torch(params)
    losses = []
    for _ in range(5):
        p, loss = train.train_step(p, CFG, toks, lr=1e-2)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_state_step_adamw_loss_decreases(params):
    toks = _tokens()
    p, opt, step = train.make_state_step(params, CFG, optimizer="adamw",
                                         lr=1e-3, device="cpu")
    losses = []
    for _ in range(5):
        p, opt, loss = step(p, opt, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_remat_matches_no_remat(params):
    toks = torch.tensor(_tokens(seed=3))
    l0, g0 = train.value_and_grad(_torch(params), CFG, toks, "q4_0", False)
    l1, g1 = train.value_and_grad(_torch(params), CFG, toks, "q4_0", True)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(train.leaves(g0), train.leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_grad_accumulation_matches_full_batch(params):
    toks = _tokens(batch=4, seed=5)
    out = []
    for accum in (1, 2):
        p, o, step = train.make_state_step(params, CFG, optimizer="sgd",
                                           lr=1e-2, accum_steps=accum,
                                           device="cpu")
        out.append(step(p, o, toks))
    (p1, _, l1), (p2, _, l2) = out
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(train.leaves(p1), train.leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)


def test_state_step_copies_params(params):
    tp = _torch(params)
    p, _, _ = train.make_state_step(tp, CFG, device="cpu")
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(train.leaves(p), train.leaves(tp)))


@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_checkpoint_roundtrip(tmp_path, params, name):
    toks = _tokens(seed=7)
    p, opt, step = train.make_state_step(params, CFG, optimizer=name,
                                         lr=1e-3, device="cpu")
    p, opt, _ = step(p, opt, toks)
    path = tmp_path / "state.npz"
    train.save_train_state(path, p, opt, step=17)
    tmpl_p = _torch(llama.init_params(CFG, seed=0))
    tmpl_o = train.make_optimizer(name, 1e-3).init(tmpl_p)
    p2, opt2, step_no = train.load_train_state(path, tmpl_p, tmpl_o)
    assert step_no == 17
    for a, b in zip(train.leaves(p), train.leaves(p2)):
        assert torch.equal(a, b)
    _, v1 = train._opt_leaves(opt, p)
    _, v2 = train._opt_leaves(opt2, p2)
    assert len(v1) == len(v2) > 0
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))
    # the resumed state continues training identically
    p_a, _, l_a = step(p, opt, toks)
    p_b, _, l_b = step(p2, opt2, toks)
    assert float(l_a) == float(l_b)
    for a, b in zip(train.leaves(p_a), train.leaves(p_b)):
        assert torch.equal(a, b)


def test_jax_written_train_state_loads(tmp_path, params):
    """A JAX ``save_train_state`` file: its params load, its adamw state
    too, and the next step agrees with JAX's."""
    toks = _tokens(seed=8)
    jp, jo, jstep = jtrain.make_state_step(
        jax.tree.map(jnp.asarray, params), JCFG, optimizer="adamw", lr=1e-3)
    jp, jo, _ = jstep(jp, jo, jnp.asarray(toks))
    path = tmp_path / "jax_state.npz"
    jtrain.save_train_state(path, jp, jo, step=3)
    want = [np.asarray(x) for x in jax.tree.leaves(jp)]
    tmpl_p = _torch(llama.init_params(CFG, seed=0))
    tmpl_o = train.make_optimizer("adamw", 1e-3).init(tmpl_p)
    p, opt, step_no = train.load_train_state(path, tmpl_p, tmpl_o)
    assert step_no == 3
    for a, b in zip(train.leaves(p), want):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    jp, jo, jl = jstep(jp, jo, jnp.asarray(toks))
    _, _, step = train.make_state_step(params, CFG, optimizer="adamw",
                                       lr=1e-3, device="cpu")
    p, opt, loss = step(p, opt, toks)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for a, b in zip(train.leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5)


def test_checkpoint_npz_across_packages(tmp_path):
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((16, 64)) * 0.5).astype(np.float32)
    tree = {"layers": [{"wq": quant.QUANTIZE[q](torch.tensor(w)),
                        "norm": torch.tensor(w[0])}
                       for q in ("q4_0", "q5_1", "q8_0")],
            "embed": torch.tensor(w)}
    port_file = tmp_path / "port.npz"
    checkpoint.save_npz(port_file, tree)
    from_jax = jckpt.load_npz(port_file)
    back = checkpoint.load_npz(port_file, device="cpu")
    assert sorted(from_jax) == sorted(back)
    for key, val in back.items():
        other = from_jax[key]
        if hasattr(val, "_fields"):
            assert type(val).__name__ == type(other).__name__
            for a, b in zip(val, other):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_array_equal(val.numpy(), other)
    jax_file = tmp_path / "jax.npz"
    jtree = {"w": jnr.quantize_q5_0(w), "b": w[1], "l": [jnr.quantize_q4_1(w)]}
    jckpt.save_npz(jax_file, jtree)
    got = checkpoint.load_npz(jax_file, device="cpu")
    assert sorted(got) == ["b", "l/0", "w"]
    np.testing.assert_array_equal(got["b"].numpy(), w[1])
    for key, src in (("w", jtree["w"]), ("l/0", jtree["l"][0])):
        assert got[key].spec.name == src.spec.name
        for a, b in zip(got[key], src):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(quant.dequantize(got[key]).numpy(),
                                      jnr.dequantize(src))

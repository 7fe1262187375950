"""CPU emulation of the tensor-core kernels' arithmetic, without a card.

The probe's conv2 and fc1 run on the tensor cores as 3xTF32
(``csrc/probe_phases.cuh``): each operand split into TF32 parts, x = hi +
lo with hi = tf32(x) and lo = tf32(x - hi) (round to nearest even on the
13 low mantissa bits, ``csrc/hopper_mma.cuh::tf32_bits``), and hi hi + hi
lo + lo hi summed in fp32.  flash_attention's bf16 path rounds p to bf16
before p v (``csrc/flash_attention.cu``).  The helpers here form those
products with PyTorch on the CPU, so the tolerances the card checks use
(probe losses within 1e-5 of scale, evals within 1e-3 with equal masks,
attention within 2^-7 of the largest |out|) are shown to hold for the
arithmetic itself, against the fp32 plain versions and the JAX reference.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.rules import build_rule_table as ref_rules
from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.convert import params_to_numpy
from repro_torch.core.rules import build_rule_table
from repro_torch.data.synthetic import class_prototypes
from repro_torch.fl import pipeline
from repro_torch.fl.partition import (PartitionConfig, group_capacity,
                                      partition)
from repro_torch.fl.rounds import FLSimulation
from repro_torch.fl.runconfig import RunConfig
from repro_torch.kernels import ref
from repro_torch.launch.fl_sim import fast_config
from repro_torch.models.cnn import sample_nll
from torch_threads import torch_intra_op_threads  # noqa: F401

# --- the split products --------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), round to nearest even, as fp32."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_product(a, b, op, passes: int):
    """op(a, b) with both operands in TF32: one pass (hi hi) or three
    (hi lo + lo hi + hi hi, the small products first, as the kernels)."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return op(ah, bh)
    return op(ah, bl) + op(al, bh) + op(ah, bh)


def probe_sample_losses(params, images, labels, passes: int):
    """The probe's per-sample NLL with conv2 and fc1 as TF32 products;
    conv1 and fc2 in fp32, as the kernel runs them on CUDA cores."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, params["conv1.w"], params["conv1.b"],
                                     padding=2)), 2)
    y = split_product(x, params["conv2.w"],
                      lambda a, w: F.conv2d(a, w, padding=2), passes)
    x = F.relu(F.max_pool2d(y, 2) + params["conv2.b"][:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # NHWC flatten
    x = F.relu(split_product(x, params["fc1.w"], lambda a, w: a @ w.T,
                             passes) + params["fc1.b"])
    return sample_nll(F.linear(x, params["fc2.w"], params["fc2.b"]), labels)


def probe_loss_split(params, images, labels, seg, counts, n, passes=3,
                     chunk=1024):
    """Eq. 7 means as ``fl/client.py::dataset_loss_packed`` takes them
    (one-hot sums per chunk), from the split-product forward."""
    lanes = torch.arange(n + 1)
    tot = torch.zeros(n + 1)
    for s in range(0, images.shape[0], chunk):
        losses = probe_sample_losses(params, images[s:s + chunk],
                                     labels[s:s + chunk], passes)
        tot = tot + losses @ (seg[s:s + chunk, None] == lanes).float()
    return tot[:n] / torch.clamp(counts.float(), min=1.0)


def scaled_err(got, want) -> float:
    """Max abs error over the largest |want|; tensors or arrays."""
    got, want = (t.float() if torch.is_tensor(t)
                 else torch.tensor(np.asarray(t, np.float32))
                 for t in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def test_tf32_rounds_to_nearest_even_and_the_split_reconstructs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(10000, generator=g) * torch.exp(
        torch.randn(10000, generator=g) * 8)
    hi, lo = split(x)
    bits = lambda t: t.view(torch.int32)
    assert bool(((bits(hi) & 0x1FFF) == 0).all())            # 10 bits kept
    assert bool(((bits(lo) & 0x1FFF) == 0).all())
    assert bool(((x - hi).abs() <= x.abs() * 2 ** -11).all())  # half an ulp
    assert bool(((x - hi - lo).abs() <= x.abs() * 2 ** -21).all())
    # ties: 1 + 2^-11 sits halfway between 1 and 1 + 2^-10, so it rounds
    # to the even 1; 1 + 3 * 2^-11 rounds up to the even 1 + 2^-9
    t = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11)])
    assert tf32(t).tolist() == [1.0, 1 + 2 ** -9, -1.0]


# --- the probe packs --------------------------------------------------------

LARGE_FLEET = 4096


def large_fleet_config():
    """The large-fleet path's data (``chip_smoke.py``): the fast profile's
    client shapes for 4096 clients, 23000 samples per class."""
    cfg = fast_config("dcs", n_rounds=2, samples_per_class=23000)
    cfg.partition = PartitionConfig(
        **{**cfg.partition.__dict__, "n_clients": LARGE_FLEET})
    return cfg


def _draws(rng, protos, n_per_class, keep):
    """``data/synthetic.py::make_dataset``'s draws, sample by sample, in
    its order; the images of the generated indices in ``keep`` as float32
    (the rest are drawn and dropped).  Returns (kept images, rng)."""
    out = {}
    for c in range(10):
        base = protos[c]
        for i in range(n_per_class):
            dy, dx = rng.integers(-2, 3, size=2)
            u = rng.uniform(0.7, 1.3)
            noise = rng.normal(scale=0.35, size=base.shape)
            j = c * n_per_class + i
            if j in keep:
                img = np.roll(np.roll(base, dy, axis=0), dx, axis=1)
                out[j] = (img * u + noise)[..., None].astype(np.float32)
    return out, rng


def probe_rows(cfg, rows: int):
    """The first whole clients' rows of ``cfg``'s probe pack, at least
    ``rows`` of them, without making the whole dataset: the partition
    needs the labels alone, and the generator's stream is replayed twice
    (once to reach its permutation, once to keep the chosen images).
    Returns (images, labels, seg, counts, n) for those clients."""
    n_pc, seed = cfg.samples_per_class, cfg.seed
    protos = class_prototypes(seed)
    _, rng = _draws(np.random.default_rng(seed + 1), protos, n_pc, set())
    n_all = 10 * n_pc
    perm = rng.permutation(n_all)
    labels = np.repeat(np.arange(10, dtype=np.int32), n_pc)[perm]
    tr = np.random.default_rng(seed + 2).permutation(n_all)[
        int(n_all * 0.15):]
    parts = partition(np.arange(len(tr)), labels[tr], cfg.partition)
    cap = max(group_capacity(len(p[1]), cfg.batch_size) for p in parts)
    take = min(cfg.probe_samples, cap)
    idx, seg, n = [], [], 0
    while len(idx) < rows:
        t = min(len(parts[n][0]), take)
        idx += list(parts[n][0][:t])
        seg += [n] * t
        n += 1
    gen = perm[tr[np.asarray(idx)]]
    kept, _ = _draws(np.random.default_rng(seed + 1), protos, n_pc,
                     set(gen.tolist()))
    images = torch.tensor(np.stack([kept[j] for j in gen]))
    seg = torch.tensor(seg, dtype=torch.int32)
    return (images, torch.tensor(labels[tr[np.asarray(idx)]]), seg,
            torch.bincount(seg, minlength=n).int(), n)


@pytest.fixture(scope="module")
def fast_round0():
    """The fast profile's round-0 prefix on the CPU: its probe pack (S =
    3882, N = 30), raw aux features, positions and draws."""
    sim = FLSimulation(fast_config("dcs", n_rounds=1), run=RunConfig(),
                       device="cpu")
    st, cfg, fields = sim.statics, sim.stage_cfg, sim.round_fields(0)
    pos = pipeline.positions(st, cfg, torch.zeros(()))
    return dict(sim=sim, params=sim.params, pos=pos, fields=fields,
                pack=(st.probe_images, st.probe_labels, st.probe_seg,
                      st.probe_counts),
                aux=pipeline.aux_features(st, cfg, pos, fields), n=sim.n)


def test_probe_rows_replay_the_simulation_pack(fast_round0):
    """The lean pack (labels-only partition, replayed generator) gives
    the simulation's own probe rows bit for bit."""
    images, labels, seg, counts, n = probe_rows(
        fast_config("dcs", n_rounds=1), 400)
    ims, lbs, sg, cnt = fast_round0["pack"]
    s = images.shape[0]
    assert torch.equal(images, ims[:s]) and torch.equal(labels, lbs[:s])
    assert torch.equal(seg, sg[:s]) and torch.equal(counts, cnt[:n])


def _mamdani(sim):
    st = sim.statics
    return st.means, st.sigmas, st.level_centers


def _ref_probe(params, pack, aux, n, mam):
    """The JAX reference's probe losses and evals, as
    ``tests/test_torch_kernels.py`` runs them (the oracle)."""
    table, levels = ref_rules()
    j = lambda t: jnp.asarray(t.numpy())
    feats, evals = ref_ops.probe_fuzzy(
        params_to_numpy(params), *(j(t) for t in pack), j(aux),
        *(j(t) for t in mam[:2]), table, levels, j(mam[2]), n_clients=n,
        batch=32, impl="oracle")
    return np.asarray(feats), np.asarray(evals)


def _evals(lf, aux, mam):
    table, levels = build_rule_table()
    feats = torch.cat([aux.float(), lf[:, None]], dim=1)
    return ref.fuzzy_eval_ref(feats, mam[0], mam[1], torch.tensor(table),
                              torch.tensor(levels), mam[2], normalize=True)


@pytest.mark.parametrize("pack_name", ["fast round 0", "large fleet rows"])
def test_probe_3xtf32_keeps_fp32_results(fast_round0, pack_name):
    """3xTF32 conv2 and fc1 keep the probe's losses within 1e-5 of scale
    of the fp32 plain version and of the JAX reference, the evals within
    1e-3 of the reference's, and round 0's election masks equal; one
    TF32 pass does not keep the losses to 1e-5."""
    sim, params = fast_round0["sim"], fast_round0["params"]
    mam = _mamdani(sim)
    if pack_name == "fast round 0":
        pack, aux, n = fast_round0["pack"], fast_round0["aux"], fast_round0["n"]
    else:
        *pack, n = probe_rows(large_fleet_config(), 300)
        g = torch.Generator().manual_seed(3)
        aux = torch.rand(n, 3, generator=g) * torch.tensor([300., 3e6, 1.])
    lf3 = probe_loss_split(params, *pack, n, passes=3)
    lf1 = probe_loss_split(params, *pack, n, passes=1)
    plain = ref.probe_loss_ref(params, *pack, n)
    feats_ref, evals_ref = _ref_probe(params, pack, aux, n, mam)
    assert scaled_err(lf3, plain) <= 1e-5
    assert scaled_err(lf3, feats_ref[:, 3]) <= 1e-5
    assert scaled_err(lf1, plain) > 1e-5
    evals3 = _evals(lf3, aux, mam)
    assert float((evals3 - torch.tensor(evals_ref)).abs().max()) <= 1e-3
    if pack_name == "fast round 0":
        cfg, pos, fields = sim.stage_cfg, fast_round0["pos"], fast_round0[
            "fields"]
        mask3 = pipeline.select(cfg, pos, evals3, fields)
        mask_ref = pipeline.select(cfg, pos, torch.tensor(evals_ref), fields)
        assert torch.equal(mask3, mask_ref) and int(mask3.sum()) > 0


# --- flash attention's bf16 p --------------------------------------------


def flash_bf16_p(q, k, v, *, causal=True, window=0, prefix_len=0, bk=64):
    """The bf16 kernel's arithmetic: scores in fp32 from bf16 q and k, an
    online softmax over kv tiles of ``bk`` in the log2 domain, p rounded
    to bf16 for p v (its sum l stays fp32), acc / max(l, 1e-30) rounded
    once to q's type."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh)
    kf, vf = k.float(), v.float()
    c = (1.0 / math.sqrt(dh)) * 1.4426950408889634
    qp = torch.arange(sq)[:, None]
    m = torch.full((b, hkv, g, sq, 1), ref.NEG_INF)
    l = torch.zeros(b, hkv, g, sq, 1)
    acc = torch.zeros(b, hkv, g, sq, dh)
    for k0 in range(0, skv, bk):
        kp = torch.arange(k0, min(k0 + bk, skv))[None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k0 + bk]) * c
        if causal:
            ok = kp <= qp
            if window:
                ok &= (qp - kp) < window
            if prefix_len:
                ok |= kp < prefix_len
            s = s.masked_fill(~ok, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", bf16(p),
                                         vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


# the card cases of tests/test_torch_gpu.py with S <= 300
FLASH_CASES = [
    (4, 64, 64, 8, 1, 256, True, 0, 0),          # gemma-2b serving prefill
    (2, 300, 300, 8, 1, 256, True, 0, 64),       # prefix-LM
    (2, 96, 160, 8, 1, 256, False, 0, 0),        # Sq != Skv, not causal
    (2, 200, 200, 4, 4, 64, True, 0, 0),         # Dh 64, groups of 1
    (2, 200, 200, 8, 2, 64, True, 0, 0),         # Dh 64, groups of 4
    (2, 200, 200, 4, 4, 128, True, 0, 0),        # Dh 128, groups of 1
    (2, 200, 200, 8, 2, 128, True, 0, 0),        # Dh 128, groups of 4
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window,prefix",
                         FLASH_CASES)
def test_flash_bf16_p_within_2_7_of_fp32_and_pallas(b, sq, skv, hq, hkv,
                                                    dh, causal, window,
                                                    prefix):
    """p rounded to bf16 (the reference's jnp attention does the same)
    keeps the output within 2^-7 of the largest |out| of the fp32 plain
    version and of ``flash_attention_pallas`` in interpret mode."""
    rng = np.random.default_rng(sq + skv + dh + hq)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, h, dh))
                            .astype(np.float32)).to(torch.bfloat16)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = flash_bf16_p(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, **kw)
    pallas = flash_attention_pallas(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        interpret=True, **kw)
    assert scaled_err(got, want) <= 2 ** -7
    assert scaled_err(got, np.asarray(pallas, np.float32)) <= 2 ** -7

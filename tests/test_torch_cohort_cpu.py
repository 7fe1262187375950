"""The cohort's local SGD on the CPU does not depend on the cohort's size
or on torch's intra-op thread count (ROADMAP C14).

Every product of a local-SGD step goes through ``kernels/ops.py::
cohort_gemm``, whose plain version makes one library call per cohort
member on fresh copies of its operands: a client's step is the same bits
alone (the loop engine's cohort of one) and in a cohort of four (the
batched engine's), at 1, 2 and 4 threads.  One grouped convolution, or
one batched GEMM over the cohort, picked its algorithm by the group or
batch count, and at one thread the engines broke the reference's
contract (``test_loop_engine_matches_batched[ccs-fuzzy]``: accuracy
0.1487 / 0.1410).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_paper as paper
from repro_torch.configs.mnist_cnn import CONFIG
from repro_torch.kernels import ops
from repro_torch.models.cnn import (_stacked_conv_gemm, _stacked_linear,
                                    init_cnn, sample_nll)
from torch_threads import intra_op_threads
from torch_threads import torch_intra_op_threads  # noqa: F401

COHORT, BATCH = 4, 20


def _step_inputs(seed=0):
    """A cohort's step at the fast profile's widths: the CNN's He init
    with small biases, 20 random images and labels a client."""
    rng = np.random.default_rng(seed)
    params = init_cnn(torch.Generator().manual_seed(seed), CONFIG)
    params = {k: v + torch.tensor(0.01 * rng.standard_normal(v.shape),
                                  dtype=torch.float32)
              for k, v in params.items()}
    images = torch.tensor(rng.standard_normal(
        (COHORT, BATCH, 28, 28, 1)).astype(np.float32))
    labels = torch.tensor(rng.integers(0, 10, (COHORT, BATCH)))
    return params, images, labels


def _step(params, images, labels):
    """One local-SGD step of a cohort, op by op (as
    ``cnn_forward_stacked`` and ``fl/client.py::local_train_batch``):
    the first client's activations, logits, loss and gradients."""
    c, b = images.shape[:2]
    p = {k: v[None].expand(c, *v.shape).clone().requires_grad_(True)
         for k, v in params.items()}
    out = {}
    x = images.permute(1, 0, 4, 2, 3).reshape(b, -1, 28, 28)
    for name in ("conv1", "conv2"):
        x = _stacked_conv_gemm(x, p[name + ".w"], p[name + ".b"])
        out[name] = x.reshape(b, c, -1, *x.shape[-2:]).transpose(0, 1)
        x = F.max_pool2d(F.relu(x), 2)
    x = x.reshape(b, c, -1, 7, 7).permute(1, 0, 3, 4, 2).reshape(c, b, -1)
    x = F.relu(_stacked_linear(x, p["fc1.w"], p["fc1.b"]))
    out["logits"] = _stacked_linear(x, p["fc2.w"], p["fc2.b"])
    out["loss"] = sample_nll(out["logits"], labels).mean(-1)
    grads = torch.autograd.grad(out["loss"].sum(), list(p.values()))
    out.update({"grad " + k: v for k, v in zip(p, grads)})
    return {k: v.detach()[0] for k, v in out.items()}


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_sgd_step_alone_and_in_a_cohort_agree_op_by_op(threads):
    """One local-SGD step of a client alone and in a cohort of four, op
    by op: the stacked convolutions, the logits, the loss and every
    gradient bit for bit, at ``threads`` intra-op threads."""
    params, images, labels = _step_inputs()
    with intra_op_threads(threads):
        alone = _step(params, images[:1], labels[:1])
        in_cohort = _step(params, images, labels)
    assert set(alone) == set(in_cohort) and len(alone) == 12
    for k, want in in_cohort.items():
        assert torch.equal(alone[k], want), (threads, k)


def _products(params, images, labels):
    """Every ``cohort_gemm`` call of one step of the cohort, as
    ``models/cnn.py`` makes it: [(a, b, bias, rowsum)]."""
    calls = []
    kernel = ops.cohort_gemm

    def record(a, b, bias=None, rowsum=False):
        calls.append((a, b, bias, rowsum))
        return kernel(a, b, bias, rowsum)
    ops.cohort_gemm = record
    try:
        _step(params, images, labels)
    finally:
        ops.cohort_gemm = kernel
    return calls


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_plain_cohort_gemm_member_is_its_own(threads):
    """The plain ``cohort_gemm`` at each of a step's 11 calls (4
    forward, 7 backward: the four weight gradients carry their bias
    gradients as row sums): the last cohort member's outputs equal a call
    of that member alone, bit for bit, and the row sums equal a's sums
    over (r, k) within fp32 rounding."""
    from repro_torch.kernels.ref import cohort_gemm_ref
    params, images, labels = _step_inputs(1)
    with intra_op_threads(threads):
        calls = _products(params, images, labels)
        assert len(calls) == 11
        assert sum(rs for *_, rs in calls) == 4
        for a, b, bias, rowsum in calls:
            got = cohort_gemm_ref(a, b, bias, rowsum)
            one = cohort_gemm_ref(a[:, -1:], b[:, -1:],
                                  None if bias is None else bias[:, -1:],
                                  rowsum)
            if rowsum:
                (got, rs), (one, one_rs) = got, one
                assert torch.equal(one_rs[:, 0], rs[:, -1])
                want = a.sum(dim=(2, 4))
                assert float((rs - want).abs().max()) <= 1e-5 * float(
                    want.abs().max())
            assert torch.equal(one[:, 0], got[:, -1]), tuple(a.shape)


@pytest.mark.parametrize("scheme", ["ccs-fuzzy", "dcs"])
def test_loop_engine_matches_batched_at_one_thread(scheme):
    """``test_loop_engine_matches_batched`` (three rounds in both
    engines: masks and integer columns equal, accuracy within 1e-5,
    params within 1e-6) at one intra-op thread, where C14 broke its
    ``ccs-fuzzy`` case."""
    with intra_op_threads(1):
        paper.test_loop_engine_matches_batched(scheme)


def test_launch_record_matches_the_kernels_struct():
    """The wrapper's packed launch record (``kernels/cohort_gemm.py::
    _RECORD``) has the fields of ``CohortGemm`` in ``csrc/cohort_gemm.cu``
    in the order the wrapper packs them: six pointers, the ints, then 18
    strides, 248 bytes with no padding."""
    import re
    from pathlib import Path
    from repro_torch.kernels import cohort_gemm as cg
    src = (Path(cg.__file__).parent.parent / "csrc"
           / "cohort_gemm.cu").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(
        r"struct CohortGemm \{(.*?)\};", src, re.S).group(1))
    ptrs = re.findall(r"void\* (\w+);", body)
    ints = [n.strip() for d in re.findall(r"\bint ([^;]*);", body)
            for n in d.split(",")]
    longs = re.findall(r"long long (\w+)\[(\d+)\];", body)
    assert ptrs == ["a", "b", "bias", "c", "rowsum", "work"]
    assert ints == ["m", "n", "k", "z1", "z2", "r", "splits", "f64", "bm",
                    "bn", "stages", "bk", "vec", "fold"]
    assert longs == [("as", "5"), ("bs", "5"), ("cs", "4"), ("biass", "4")]
    assert cg._RECORD.size == 8 * 6 + 4 * 14 + 8 * 18 == 248

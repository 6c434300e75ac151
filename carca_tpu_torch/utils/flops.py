"""Analytic matmul FLOPs and modelled HBM bytes of a train step, and the
card's peaks, for the MFU and bandwidth roofline of ``bench.py``
(counterpart of ``carca_tpu/utils/flops.py``, the same arithmetic on the
port's ``ModelConfig``).

Only matmul FLOPs are counted (the MFU convention): the embedding-fusion
linears, the attention projections, the score and value products, the FFN
and the decoder. Table gathers, masking, softmax, dropout, the negative
sampler and the optimizer are left out: at CARCA's widths (d = 64–128)
those are the memory-bound parts MFU exposes as the gap to 100%.

The MFU denominator is the dense bf16 tensor-core peak for every compute
dtype, the JAX package's convention. The port's float32 path runs IEEE
fp32 GEMMs (``allow_tf32`` off) and its attention kernels as 3xTF32, both
slower per FLOP than bf16, so an f32 step's MFU is a lower bound on its
share of what its own arithmetic could reach.

The FLOPs are the model's, as the JAX package counts them, with or without
``ModelConfig.remat``: the encoder blocks' second forward in a remat step's
backward is not counted, and the modelled HBM bytes keep their no-remat
activations. A remat step's ``mfu`` therefore reads lower than the same
step without remat by its recompute time alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from carca_tpu_torch.config import ModelConfig

# dense (no sparsity) bf16 tensor-core FLOP/s and HBM bytes/s per card, keyed
# on torch.cuda.get_device_name()
PEAK_FLOPS = {
    # NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s bf16 dense, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": 989.4e12,
    # NVIDIA H100 PCIe data sheet: 1,513 TFLOP/s bf16 with sparsity (756.5 dense),
    # 2.0 TB/s HBM2e
    "NVIDIA H100 PCIe": 756.5e12,
}
PEAK_HBM_BPS = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def _device_name(device) -> Optional[str]:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def device_peak_flops(device) -> Optional[float]:
    """Dense bf16 peak FLOP/s of ``device``; None on the CPU and on a card
    the table does not know."""
    return PEAK_FLOPS.get(_device_name(device))


def device_peak_hbm_bps(device) -> Optional[float]:
    """HBM peak bytes/s of ``device``; None on the CPU and on an unknown card."""
    return PEAK_HBM_BPS.get(_device_name(device))


def _embed_flops_per_token(mc: ModelConfig) -> float:
    """Matmul FLOPs to fuse one (id, attrs, ctx) token to d dims
    (``models/embeddings.py``; ``src/carca.py:66-198``)."""
    a, c, g, d = mc.n_attrs, mc.n_ctx, mc.g, mc.d
    if mc.embedding == "all":
        return 2.0 * (a + c) * g + 2.0 * (g + d) * d
    if mc.embedding == "attrctx":
        return 2.0 * (a + c) * g + 2.0 * g * d
    if mc.embedding == "attr":
        return 2.0 * a * g + 2.0 * g * d
    if mc.embedding == "mlpid":
        return 2.0 * g * d
    return 0.0  # "id": a table gather


def forward_flops_per_example(mc: ModelConfig, n_targets: int) -> float:
    """Matmul FLOPs of one forward for one example with ``n_targets``
    candidates (train: 2L, eval: target_len + 1): L profile and
    ``n_targets`` target tokens embedded, ``n_blocks`` encoder blocks over
    the profile, the decoder over the candidates."""
    L, d, T = mc.seq_len, mc.d, n_targets
    f = (L + T) * _embed_flops_per_token(mc)
    # encoder block: Q/K/V projections, L x L scores, weighted values, two
    # d -> d FFN layers (src/carca.py:297-318)
    per_block = 3 * 2.0 * L * d * d + 2 * 2.0 * L * L * d + 2 * 2.0 * L * d * d
    f += mc.n_blocks * per_block
    if mc.decoder == "ca":
        # cross-attention: Wq over T targets, Wk/Wv over L profile, T x L
        # scores and values, the final d -> 1 linear (src/carca.py:338-349)
        f += 2.0 * T * d * d + 2 * 2.0 * L * d * d
        f += 2 * 2.0 * T * L * d + 2.0 * T * d
    elif mc.decoder == "wdot":
        # the decayed profile mix: [L, L] @ [L, d] per example
        f += 2.0 * L * L * d + 2.0 * T * d
    else:  # dot: the elementwise p·o reduction
        f += 2.0 * T * d
    return f


def train_step_flops(mc: ModelConfig, batch_size: int) -> float:
    """Matmul FLOPs of one optimizer step (forward and backward) over a
    batch: the backward of a matmul costs twice its forward."""
    return 3.0 * batch_size * forward_flops_per_example(mc, 2 * mc.seq_len)


def train_step_hbm_bytes(mc: ModelConfig, batch_size: int, sparse_items: bool = False) -> float:
    """Modelled HBM bytes of one optimizer step, the companion of
    ``train_step_flops`` for the bandwidth roofline: the optimizer and
    gradient streams over the parameters, the table gathers and the
    backward's scatter-adds, the batch tensors, and the forward's
    intermediates written and read again by the backward. Elementwise
    chains are counted as fused (no extra round trips), so this is a best
    case and ``hbm_gbps`` from it a lower bound on the bytes the card
    moves. With ``sparse_items`` the item table's optimizer stream covers
    the touched rows alone (the row-sparse Adam), bounded by the step's
    token count."""
    B, L, d, g = batch_size, mc.seq_len, mc.d, mc.g
    T = 2 * L  # train candidates: L positives + L negatives
    a, c = mc.n_attrs, mc.n_ctx
    s = 4  # parameters, tables and activations in float32
    tokens = B * (L + T)

    p_table = mc.n_items * d * s
    p_fuse = ((a + c) * g + g + (g + d) * d + d) * s
    p_enc = mc.n_blocks * (3 * d * d + 2 * d * d + 4 * d) * s
    p_dec = (3 * d * d + d) * s if mc.decoder == "ca" else 0
    p_rest = p_fuse + p_enc + p_dec

    # the backward writes the gradient (1 pass), Adam reads g, p, m, v (4)
    # and writes p, m, v (3): 8 passes over every parameter byte
    touched = min(tokens, mc.n_items) * d * s
    opt = 8.0 * ((touched if sparse_items else p_table) + p_rest)

    gather = tokens * (d + a) * s  # item and attrs rows per token
    scatter = 2.0 * tokens * d * s  # the backward's scatter-add, read + write
    batch_io = tokens * (4 + 4 + c * s)  # ids, labels, per-event ctx

    acts = tokens * (g + d)
    acts += mc.n_blocks * (3 * B * L * d + 2 * B * L * L + 2 * B * L * d + 2 * B * L * d)
    if mc.decoder == "ca":
        acts += B * T * d + 2 * B * L * d + 2 * B * T * L + B * T * d
    else:
        acts += B * T * d
    acts_bytes = 2.0 * acts * s
    return opt + gather + scatter + batch_io + acts_bytes


def utilisation(mc: ModelConfig, batch_size: int, examples_per_sec: float,
                sparse_items: bool, device) -> dict:
    """``bench.py``'s utilisation keys at a measured rate: ``mfu`` (matmul
    FLOPs per second over the bf16 peak) and ``hbm_bw_util`` (modelled
    bytes per second over the HBM peak), absent on a card without peaks;
    ``hbm_gbps`` always."""
    steps_per_sec = examples_per_sec / batch_size
    out = {}
    peak = device_peak_flops(device)
    if peak:
        out["mfu"] = train_step_flops(mc, batch_size) * steps_per_sec / peak
    gbps = train_step_hbm_bytes(mc, batch_size, sparse_items=sparse_items) * steps_per_sec / 1e9
    out["hbm_gbps"] = gbps
    hbm = device_peak_hbm_bps(device)
    if hbm:
        out["hbm_bw_util"] = gbps * 1e9 / hbm
    return out

"""Model-axis tensor parallelism (counterpart of ``jointpose/parallel/mrf_tp.py``).

The MRF message pass is a sum over source joints of per-source
log-messages,

    out[..., a] = Σ_v log( k_{a|v} ⊛ p_v + b_{v,a} )

so its tensor axis is the SOURCE-JOINT axis v: each 'model' rank runs
the pass on its v-slice (the real kernel on the card: the epilogue or
the fused Fourier tail at Kv_local = Kp / n source channels) and one
all-reduce over 'model' sums the rank results.  K = 9 divides no even
axis, so v is padded to the next multiple with NEUTRAL slots: zero
kernels and unit bias make a padded source add log(0 + 1) = 0 exactly.

The two autograd functions around a tensor-parallel region are the pair
Megatron-LM calls f and g:

- ``enter_model_region`` (f): identity forward, all-reduce backward.  A
  replicated input (the unaries before they are sliced, the trunk
  features before the sliced head conv) collects each rank's partial
  gradient.
- ``leave_model_region`` (g): all-reduce forward, identity backward.
  Every model rank then holds the whole output and the whole loss, so
  the backward must NOT sum again (``torch.distributed.nn``'s
  ``all_reduce`` does, and would scale the gradients by the model size).

Both sum in fp32.  Parameters that a rank uses only in slices (the MRF's
pairwise kernels and biases, the head's split convs) get gradients that
are zero outside the slice: the trainer sums them over 'model' before the
update (``train.make_train_step``).

The tensors a rank passes in are its own: its rows of the batch have
already been taken at the batch's source (``mesh.shard_batch``), where
the reference's ``shard_map`` splits a global batch over 'data' here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jointpose_torch.parallel.mesh import MODEL_AXIS, Mesh


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous()
        ctx.mesh.all_reduce(total, MODEL_AXIS)
        return total.to(g.dtype), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        total = x.float().contiguous().clone()
        return mesh.all_reduce(total, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_model_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """f: ``x`` unchanged; its gradient summed over 'model'."""
    return _Enter.apply(x, mesh) if mesh.shape[MODEL_AXIS] > 1 else x


def leave_model_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """g: the fp32 sum of ``x`` over 'model'; its gradient passed through."""
    return _Leave.apply(x, mesh) if mesh.shape[MODEL_AXIS] > 1 else x


def model_slice(n_items: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of ``n_items`` over 'model'."""
    n = mesh.shape[MODEL_AXIS]
    if n_items % n:
        raise ValueError(f"{n_items} items do not divide over the model axis ({n})")
    share = n_items // n
    m = mesh.coords[MODEL_AXIS]
    return slice(m * share, (m + 1) * share)


def pad_source_axis(p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor,
                    n_shards: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad the source-joint axis to a multiple of ``n_shards``, neutrally:
    zero unaries and kernels, unit biases."""
    k = p.shape[-1]
    pad = -(-k // n_shards) * n_shards - k
    if pad:
        p = F.pad(p, (0, pad))
        kernels = F.pad(kernels, (0, 0, 0, pad))
        # The padded source's response is 0 + 1 everywhere: log(1) = 0.
        biases = F.pad(biases, (0, 0, 0, pad), value=1.0)
    return p, kernels, biases


def mrf_message_pass_tp(
    p: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    eps: float = 1e-6,
    precision: str | None = None,
    *,
    mesh: Mesh,
    base_pass,
) -> torch.Tensor:
    """``base_pass`` (any unsharded pass: direct, epilogue, Fourier, fused)
    over this rank's slice of the source joints, summed over 'model'.

    Same (p, kernels, biases, eps, precision) contract and (B, H, W, K)
    fp32 result as the unsharded passes, on every model rank."""
    n = mesh.shape[MODEL_AXIS]
    if n == 1:
        return base_pass(p, kernels, biases, eps=eps, precision=precision)
    p = enter_model_region(p, mesh)
    p, kernels, biases = pad_source_axis(p, kernels, biases, n)
    sl = model_slice(p.shape[-1], mesh)
    out = base_pass(p[..., sl].contiguous(), kernels[:, :, sl].contiguous(),
                    biases[sl].contiguous(), eps=eps, precision=precision)
    return leave_model_region(out, mesh)

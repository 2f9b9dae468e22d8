"""The port's kernels as ``torch.library`` custom ops.

Six ops in the ``repro_torch`` namespace:

  repro_torch::flash_attention      the flash-attention forward (K1)
  repro_torch::flash_attention_bwd  its backward (no TPU counterpart)
  repro_torch::ssd                  the Mamba-2 SSD chunked scan (K2)
  repro_torch::ssd_bwd              its backward (no TPU counterpart)
  repro_torch::rglru                the RG-LRU scan (K3)
  repro_torch::rglru_bwd            its backward (no TPU counterpart)

Each op has a CUDA implementation, the kernel's ctypes launch
(``kernel.py``), and a CPU implementation, the kernel's plain version
(``ref.py``); a tensor on any other device finds no implementation and
the call raises.  Each has a fake implementation that gives its outputs'
shapes and dtypes, so ``torch.compile`` traces a step through a call
without running it: Dynamo and Inductor keep each call as one opaque op,
and a compiled step launches the same hand-written kernels as the eager
one.

Each implementation runs whole inside ``accounting.kernel_scope``, which
is therefore never traced: the analysis and coverage passes and the CPU
profiler count one call of the kernel's ``cost()`` (a backward's
``cost_bwd()``) work, on either device and whether or not the step was
compiled.  The passes' modes see the op itself too, and leave its
namespace (``accounting.OP_NAMESPACE``) to the scope.

Gradients.  Each forward op has a registered autograd formula whose
backward is its backward op: the backward kernel on the card, and on the
CPU the plain version differentiated by autograd (the op's implementation
runs below autograd, which ``_autograd_on`` turns on again for it), the
values autograd through ``attention_ref``, ``ssd_ref`` and
``rglru_blocked`` gives.  No gradient on the card goes through a plain
version.

The per-row offsets of flash attention (``q_offset``, ``kv_len``: an int
or a per-row (B,) tensor, ``ref.IntOrRows``) fit no one schema type, so
each is two arguments: an int and an optional tensor, the tensor taking
precedence (``split_rows`` / ``_rows_arg``).  ``kv_len`` None means all
keys, ``softmax_scale`` None means ``D ** -0.5``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from repro_torch.kernels.accounting import OP_NAMESPACE, kernel_scope
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import IntOrRows, attention_ref
from repro_torch.kernels.rglru import kernel as rk
from repro_torch.kernels.rglru.ref import rglru_blocked
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd.ref import ssd_ref

def check_device(name: str, t: Tensor) -> None:
    """Raise for a tensor on a device with no implementation of the op
    (the meta device among them, where the fake would answer)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no path for device {t.device}")


def split_rows(x: Optional[IntOrRows]) -> Tuple[Optional[int], Optional[Tensor]]:
    """An int-or-rows argument as the ops' (int, optional tensor) pair."""
    if isinstance(x, Tensor):
        return 0, x
    return x, None


def _rows_arg(n: Optional[int], rows: Optional[Tensor]) -> Optional[IntOrRows]:
    return n if rows is None else rows


def _dense(t: Tensor) -> Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels take it (a view
    when it is)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _autograd_on():
    """Autograd inside an op's implementation: the op's autograd layer
    runs it with the autograd dispatch keys excluded, and this includes
    them again (with grad mode on), so the plain backward can record and
    differentiate ``attention_ref``."""
    exclude = torch._C._dispatch_tls_local_exclude_set()
    for key in ("AutogradFunctionality", "AutogradOther", "AutogradNestedTensor",
                "ADInplaceOrView"):
        exclude = exclude.remove(getattr(torch._C.DispatchKey, key))
    return torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                           exclude)


def _plain_grads(fn, inputs, grads, needs) -> Tuple[Optional[Tensor], ...]:
    """The gradients of ``fn`` at ``inputs`` for the output gradients
    ``grads`` (None: zeros), by autograd: one per input, None where
    ``needs`` wants none or the input is None."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = [torch.zeros_like(o) if g is None else g for g, o in zip(grads, outs)]
        present = [i for i, t in enumerate(leaves) if t is not None]
        got = torch.autograd.grad(outs, [leaves[i] for i in present], grads,
                                  allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(present, got):
        if needs[i]:
            out[i] = g
    return tuple(out)


def _shape(q: Tensor, k: Tensor):
    """(B, Sq, Sk, H, K, D) of an attention call."""
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D


def _attention_kw(mask_type, window, prefix_len, q_offset, q_offset_rows, kv_len,
                  kv_len_rows, softmax_scale, softcap) -> Dict[str, Any]:
    """``attention_ref``'s keyword arguments from an op's."""
    return dict(mask_type=mask_type, window=window, prefix_len=prefix_len,
                q_offset=_rows_arg(q_offset, q_offset_rows),
                kv_len=_rows_arg(kv_len, kv_len_rows),
                softmax_scale=softmax_scale, softcap=softcap)


def _cuda_kw(q: Tensor, k: Tensor, kw: Dict[str, Any]) -> Dict[str, Any]:
    """The kernels' keyword arguments from ``attention_ref``'s."""
    scale = kw["softmax_scale"]
    return dict(q_offset=kw["q_offset"],
                kv_len=k.shape[1] if kw["kv_len"] is None else kw["kv_len"],
                mask_type=kw["mask_type"], window=kw["window"],
                prefix_len=kw["prefix_len"],
                scale=scale if scale is not None else q.shape[-1] ** -0.5,
                softcap=kw["softcap"])


def _mask_kw(kw: Dict[str, Any]) -> Dict[str, Any]:
    return {n: kw[n] for n in ("mask_type", "window", "prefix_len", "q_offset", "kv_len")}


# ---- flash attention, forward ---------------------------------------------------

@custom_op(f"{OP_NAMESPACE}::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention(q: Tensor, k: Tensor, v: Tensor, mask_type: str, window: int,
                    prefix_len: int, q_offset: int, q_offset_rows: Optional[Tensor],
                    kv_len: Optional[int], kv_len_rows: Optional[Tensor],
                    softmax_scale: Optional[float], softcap: float) -> Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, K, D) -> (B, Sq, H, D); the CPU
    implementation, ``attention_ref``."""
    kw = _attention_kw(mask_type, window, prefix_len, q_offset, q_offset_rows, kv_len,
                       kv_len_rows, softmax_scale, softcap)
    work = lambda: fa.cost(*_shape(q, k), q.dtype, **_mask_kw(kw))   # noqa: E731
    with kernel_scope("flash_attention", work, q.device):
        return attention_ref(q, k, v, **kw).contiguous()


@flash_attention.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, mask_type, window, prefix_len, q_offset, q_offset_rows,
                          kv_len, kv_len_rows, softmax_scale, softcap):
    kw = _attention_kw(mask_type, window, prefix_len, q_offset, q_offset_rows, kv_len,
                       kv_len_rows, softmax_scale, softcap)
    work = lambda: fa.cost(*_shape(q, k), q.dtype, **_mask_kw(kw))   # noqa: E731
    with kernel_scope("flash_attention", work, q.device):
        return fa.flash_attention_cuda(_dense(q), _dense(k), _dense(v),
                                       **_cuda_kw(q, k, kw))


@flash_attention.register_fake
def _flash_attention_fake(q, k, v, *args):
    return q.new_empty(q.shape)


# ---- flash attention, backward --------------------------------------------------

@custom_op(f"{OP_NAMESPACE}::flash_attention_bwd", mutates_args=(), device_types="cpu")
def flash_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
                        mask_type: str, window: int, prefix_len: int, q_offset: int,
                        q_offset_rows: Optional[Tensor], kv_len: Optional[int],
                        kv_len_rows: Optional[Tensor], softmax_scale: Optional[float],
                        softcap: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of ``flash_attention`` at its output ``o`` and output
    gradient ``do``; the CPU implementation differentiates
    ``attention_ref`` again (``o`` unused)."""
    kw = _attention_kw(mask_type, window, prefix_len, q_offset, q_offset_rows, kv_len,
                       kv_len_rows, softmax_scale, softcap)
    work = lambda: fa.cost_bwd(*_shape(q, k), q.dtype, **_mask_kw(kw))   # noqa: E731
    with kernel_scope("flash_attention_bwd", work, q.device), _autograd_on():
        grads = _plain_grads(lambda *qkv: attention_ref(*qkv, **kw), (q, k, v), (do,),
                             (True,) * 3)
        return tuple(g.contiguous() for g in grads)


@flash_attention_bwd.register_kernel("cuda")
def _flash_attention_bwd_cuda(q, k, v, o, do, mask_type, window, prefix_len, q_offset,
                              q_offset_rows, kv_len, kv_len_rows, softmax_scale, softcap):
    kw = _attention_kw(mask_type, window, prefix_len, q_offset, q_offset_rows, kv_len,
                       kv_len_rows, softmax_scale, softcap)
    work = lambda: fa.cost_bwd(*_shape(q, k), q.dtype, **_mask_kw(kw))   # noqa: E731
    with kernel_scope("flash_attention_bwd", work, q.device):
        return fa.flash_attention_bwd_cuda(_dense(q), _dense(k), _dense(v), _dense(o),
                                           _dense(do), **_cuda_kw(q, k, kw))


@flash_attention_bwd.register_fake
def _flash_attention_bwd_fake(q, k, v, *args):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, *args = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.args = args


def _flash_backward(ctx, do):
    q, k, v, o = ctx.saved_tensors
    grads = flash_attention_bwd(q, k, v, o, do, *ctx.args)
    return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
            *(None,) * len(ctx.args))


flash_attention.register_autograd(_flash_backward, setup_context=_flash_setup)


# ---- the SSD and the RG-LRU -----------------------------------------------------

def _ssd_work(x: Tensor, Bm: Tensor, init_state: Optional[Tensor]):
    B, S, H, P = x.shape
    return lambda: sk.cost(B, S, H, P, Bm.shape[-1], x.dtype, init_state is not None)


@custom_op(f"{OP_NAMESPACE}::ssd", mutates_args=(), device_types="cpu")
def ssd(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
        init_state: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, Bm/Cm (B,S,N),
    ``init_state`` (B,H,P,N) fp32 or None -> (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) fp32); the CPU implementation, ``ssd_ref``."""
    with kernel_scope("ssd", _ssd_work(x, Bm, init_state), x.device):
        y, state = ssd_ref(x, dt, A, Bm, Cm, init_state)
        return y.contiguous(), state.contiguous()


def _unit_rows(t: Tensor) -> Tensor:
    """``t`` with unit stride over its last dim (a view when it has one)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _ssd_x(x: Tensor) -> Tensor:
    """x as the SSD kernels take it: unit stride over P, stride P over H."""
    P = x.shape[-1]
    if x.stride(-1) != 1 or (x.stride(2) != P and x.shape[2] > 1):
        return x.contiguous()
    return x


def _contiguous(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t.contiguous()


@ssd.register_kernel("cuda")
def _ssd_cuda(x, dt, A, Bm, Cm, init_state):
    with kernel_scope("ssd", _ssd_work(x, Bm, init_state), x.device):
        return sk.ssd_cuda(_ssd_x(x), dt.contiguous(), A.contiguous(), _unit_rows(Bm),
                           _unit_rows(Cm), _contiguous(init_state))


@ssd.register_fake
def _ssd_fake(x, dt, A, Bm, Cm, init_state):
    B, S, H, P = x.shape
    return x.new_empty(x.shape), x.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32)


def _ssd_bwd_work(x: Tensor, Bm: Tensor, init_state: Optional[Tensor],
                  dstate: Optional[Tensor]):
    B, S, H, P = x.shape
    return lambda: sk.cost_bwd(B, S, H, P, Bm.shape[-1], x.dtype, init_state is not None,
                               dstate is not None)


@custom_op(f"{OP_NAMESPACE}::ssd_bwd", mutates_args=(), device_types="cpu")
def ssd_bwd(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
            init_state: Optional[Tensor], dy: Tensor, dstate: Optional[Tensor]
            ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dx, ddt, dA, dBm, dCm, dinit) of ``ssd`` at its output gradients
    ``dy`` and ``dstate`` (None: zeros), each shaped and typed as its
    input (dinit (B,H,P,N) fp32, zeros when ``init_state`` is None); the
    CPU implementation differentiates ``ssd_ref`` by autograd."""
    with kernel_scope("ssd_bwd", _ssd_bwd_work(x, Bm, init_state, dstate), x.device), \
            _autograd_on():
        grads = _plain_grads(ssd_ref, (x, dt, A, Bm, Cm, init_state), (dy, dstate),
                             (True,) * 6)
        B, S, H, P = x.shape
        dinit = grads[5] if init_state is not None else x.new_zeros(
            (B, H, P, Bm.shape[-1]), dtype=torch.float32)
        return (*(g.contiguous() for g in grads[:5]), dinit.contiguous())


@ssd_bwd.register_kernel("cuda")
def _ssd_bwd_cuda(x, dt, A, Bm, Cm, init_state, dy, dstate):
    with kernel_scope("ssd_bwd", _ssd_bwd_work(x, Bm, init_state, dstate), x.device):
        return sk.ssd_bwd_cuda(_ssd_x(x), dt.contiguous(), A.contiguous(), _unit_rows(Bm),
                               _unit_rows(Cm), _contiguous(init_state), dy.contiguous(),
                               _contiguous(dstate))


@ssd_bwd.register_fake
def _ssd_bwd_fake(x, dt, A, Bm, Cm, init_state, dy, dstate):
    B, S, H, P = x.shape
    return (x.new_empty(x.shape), dt.new_empty(dt.shape), A.new_empty(A.shape),
            Bm.new_empty(Bm.shape), Cm.new_empty(Cm.shape),
            x.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32))


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ssd_backward(ctx, dy, dstate):
    grads = ssd_bwd(*ctx.saved_tensors, dy, dstate)
    return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


ssd.register_autograd(_ssd_backward, setup_context=_save_inputs)


@custom_op(f"{OP_NAMESPACE}::rglru", mutates_args=(), device_types="cpu")
def rglru(x: Tensor, a: Tensor, init_state: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """x, a (B, S, D), ``init_state`` (B, D) fp32 or None -> (h (B, S, D)
    fp32, a copy of its last step (B, D)); the CPU implementation,
    ``rglru_blocked``.  (An op's outputs may not alias each other.)"""
    B, S, D = x.shape
    work = lambda: rk.cost(B, S, D, init_state is not None)   # noqa: E731
    with kernel_scope("rglru", work, x.device):
        return _with_last(rglru_blocked(x, a, init_state).contiguous())


def _with_last(h: Tensor) -> Tuple[Tensor, Tensor]:
    return h, h[:, -1].clone()


def _rglru_plain(x, a, init_state):
    return _with_last(rglru_blocked(x, a, init_state))


def _fp32_rows(t: Tensor) -> Tensor:
    """``t`` in fp32 with unit stride over its last dim (a view when it
    has one)."""
    return _unit_rows(t.float())


def _fp32(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t.float().contiguous()


@rglru.register_kernel("cuda")
def _rglru_cuda(x, a, init_state):
    B, S, D = x.shape
    work = lambda: rk.cost(B, S, D, init_state is not None)   # noqa: E731
    with kernel_scope("rglru", work, x.device):
        return _with_last(rk.rglru_cuda(_fp32_rows(x), _fp32_rows(a), _fp32(init_state)))


@rglru.register_fake
def _rglru_fake(x, a, init_state):
    B, S, D = x.shape
    return (x.new_empty(x.shape, dtype=torch.float32),
            x.new_empty((B, D), dtype=torch.float32))


def _rglru_bwd_work(x: Tensor, init_state: Optional[Tensor], dh_last: Optional[Tensor]):
    B, S, D = x.shape
    return lambda: rk.cost_bwd(B, S, D, init_state is not None, dh_last is not None)


@custom_op(f"{OP_NAMESPACE}::rglru_bwd", mutates_args=(), device_types="cpu")
def rglru_bwd(x: Tensor, a: Tensor, h: Tensor, init_state: Optional[Tensor], dh: Tensor,
              dh_last: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """(dx, da, dinit) of ``rglru`` at its output ``h`` and output
    gradients ``dh`` and ``dh_last`` (None: zeros), dx and da in x's and
    a's dtypes, dinit (B, D) fp32 (zeros when ``init_state`` is None); the
    CPU implementation differentiates ``rglru_blocked`` by autograd (``h``
    unused)."""
    with kernel_scope("rglru_bwd", _rglru_bwd_work(x, init_state, dh_last), x.device), \
            _autograd_on():
        dx, da, dinit = _plain_grads(_rglru_plain, (x, a, init_state), (dh, dh_last),
                                     (True,) * 3)
        if dinit is None:
            dinit = x.new_zeros((x.shape[0], x.shape[2]), dtype=torch.float32)
        return dx.contiguous(), da.contiguous(), dinit.contiguous()


@rglru_bwd.register_kernel("cuda")
def _rglru_bwd_cuda(x, a, h, init_state, dh, dh_last):
    with kernel_scope("rglru_bwd", _rglru_bwd_work(x, init_state, dh_last), x.device):
        dx, da, dinit = rk.rglru_bwd_cuda(_fp32_rows(x), _fp32_rows(a), h.contiguous(),
                                          _fp32(init_state), dh.float().contiguous(),
                                          _fp32(dh_last))
        return dx.to(x.dtype), da.to(a.dtype), dinit


@rglru_bwd.register_fake
def _rglru_bwd_fake(x, a, h, init_state, dh, dh_last):
    return (x.new_empty(x.shape), a.new_empty(a.shape),
            x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32))


def _rglru_setup(ctx, inputs, output):
    x, a, init_state = inputs
    ctx.save_for_backward(x, a, init_state, output[0])


def _rglru_backward(ctx, dh, dh_last):
    x, a, init_state, h = ctx.saved_tensors
    grads = rglru_bwd(x, a, h, init_state, dh, dh_last)
    return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


rglru.register_autograd(_rglru_backward, setup_context=_rglru_setup)

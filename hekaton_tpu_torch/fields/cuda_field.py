"""Field kernels: the Montgomery multiply and the Fermat inversion.

Port of hekaton_tpu/fields/pallas_field.py. Source: csrc/field.cu (kernels)
and csrc/field.cuh (the shared 8-word CIOS device functions).

- `mont_mul` replaces `mont_mul_pallas` (pallas_field.py:253, `_kernel` :40).
  Bound on an H100 by bytes: 192 B of (n, 16) int32 limb rows per product
  against ~300 integer multiply-adds. One thread per lane, no shared memory.
- `fermat_inv` replaces `fermat_inv_pallas` (pallas_field.py:238,
  `_fermat_kernel` :187). On the main path it inverts the <= 1024 roots of
  a batch_inv tree, one thread per root in one launch, so it is bound by
  the latency of ~380 dependent products per thread.

The measured times and what they leave to do are in csrc/field.cu.

Each wrapper takes a CPU tensor to its plain PyTorch version (`*_plain`,
fields/torch_field.py) and a CUDA tensor to its kernel; nothing falls back.
`launches` on each wrapper counts the kernel launches.
"""
from __future__ import annotations

import torch

from .. import cuda_lib
from . import torch_field as tf
from .torch_field import FieldSpec

mont_mul_plain = tf.mont_mul
fermat_inv_plain = tf.mont_inv


def _field_id(spec: FieldSpec) -> int:
    if spec.modulus == tf.FQ.modulus:
        return 0
    if spec.modulus == tf.FR.modulus:
        return 1
    raise ValueError(f"no CUDA kernel for the field {spec.name}")


def check_limbs(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.dim() == 0 or t.shape[-1] != 16:
        raise ValueError(f"{name}: expected (..., 16) limbs, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p on (..., 16) limbs. `b` is a's shape or a trailing
    part of it ((16,) for a constant), broadcast over a's leading dims."""
    if not a.is_cuda:
        return mont_mul_plain(spec, a, b)
    check_limbs("mont_mul a", a, a.device)
    check_limbs("mont_mul b", b, a.device)
    if tuple(a.shape[a.dim() - b.dim():]) != tuple(b.shape):
        raise ValueError(f"mont_mul: b {tuple(b.shape)} does not broadcast onto a {tuple(a.shape)}")
    out = torch.empty_like(a)
    n = a.numel() // 16
    if n:
        rc = cuda_lib.lib().hk_mont_mul(
            _field_id(spec), a.data_ptr(), b.data_ptr(), out.data_ptr(), n, b.numel() // 16,
            cuda_lib.stream_ptr(a.device),
        )
        cuda_lib.check("hk_mont_mul", rc)
        mont_mul.launches += 1
    return out


mont_mul.launches = 0


def fermat_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) on (..., 16) Montgomery limbs; inv(0) = 0."""
    if not a.is_cuda:
        return fermat_inv_plain(spec, a)
    check_limbs("fermat_inv", a, a.device)
    out = torch.empty_like(a)
    n = a.numel() // 16
    if n:
        rc = cuda_lib.lib().hk_fermat_inv(
            _field_id(spec), a.data_ptr(), out.data_ptr(), n, cuda_lib.stream_ptr(a.device)
        )
        cuda_lib.check("hk_fermat_inv", rc)
        fermat_inv.launches += 1
    return out


fermat_inv.launches = 0

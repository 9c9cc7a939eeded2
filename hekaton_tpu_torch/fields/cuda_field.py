"""Field kernels: the Montgomery multiply and the modular inversion.

Port of hekaton_tpu/fields/pallas_field.py. Source: csrc/field.cu (kernels)
and csrc/field.cuh (the shared NW-word CIOS device functions). Each kernel is
a template on the field, instantiated for BN254 Fq and Fr ((..., 16) limbs,
8 words) and BLS12-381 Fq ((..., 24) limbs, 12 words), as the Pallas
builders are generic in the limb count.

- `mont_mul` replaces `mont_mul_pallas` (pallas_field.py:253, `_kernel` :40).
  Bound on an H100 by bytes: 192 B of int32 limb rows per BN254 product
  against ~264 32-bit multiplies, 288 B against ~588 on BLS12-381. One
  thread per lane, no shared memory.
- `fermat_inv` replaces `fermat_inv_pallas` (pallas_field.py:238,
  `_fermat_kernel` :187) and keeps its name and function (a^-1 in
  Montgomery form, canonical; inv(0) = 0), but runs no Fermat chain: one
  thread a lane runs Bernstein-Yang divsteps at a fixed count (750 at 254
  bits, 1,110 at 381), ~15x fewer operations than a^(p-2)'s 362-608
  dependent products and a ~25x shorter dependent chain. On CUDA tensors
  tf.batch_inv and to_affine_device invert every lane on it.

The measured times and what they leave to do are in csrc/field.cu.

Each wrapper takes a CPU tensor to its plain PyTorch version (`*_plain`,
fields/torch_field.py) and a CUDA tensor to its kernel; nothing falls back.
`launches` on each wrapper counts its kernel launches over every field, and
`launches_by_field` per `FieldSpec.name`.
"""
from __future__ import annotations

import torch

from .. import cuda_lib
from . import torch_field as tf
from .torch_field import FieldSpec

mont_mul_plain = tf.mont_mul
fermat_inv_plain = tf.mont_inv

# (modulus, limbs) -> the field id of csrc/field.cuh (FQ, FR, FQ_BLS)
_FIELD_IDS = {
    (tf.FQ.modulus, tf.FQ.nlimbs): 0,
    (tf.FR.modulus, tf.FR.nlimbs): 1,
    (tf.FQ_BLS.modulus, tf.FQ_BLS.nlimbs): 2,
}


def _field_id(spec: FieldSpec) -> int:
    fid = _FIELD_IDS.get((spec.modulus, spec.nlimbs))
    if fid is None:
        raise ValueError(f"no CUDA kernel for the field {spec.name} at {spec.nlimbs} limbs")
    return fid


def check_limbs(name: str, t: torch.Tensor, device, nlimbs: int = 16) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.dim() == 0 or t.shape[-1] != nlimbs:
        raise ValueError(f"{name}: expected (..., {nlimbs}) limbs, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")


def _count(fn, spec: FieldSpec) -> None:
    fn.launches += 1
    fn.launches_by_field[spec.name] = fn.launches_by_field.get(spec.name, 0) + 1


def reset_counts(fn) -> None:
    """Set a field wrapper's launch counts to 0."""
    fn.launches = 0
    fn.launches_by_field = {}


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p on (..., nlimbs) limbs. `b` is a's shape or a
    trailing part of it ((nlimbs,) for a constant), broadcast over a's
    leading dims."""
    if not a.is_cuda:
        return mont_mul_plain(spec, a, b)
    fid = _field_id(spec)
    nl = spec.nlimbs
    check_limbs("mont_mul a", a, a.device, nl)
    check_limbs("mont_mul b", b, a.device, nl)
    if tuple(a.shape[a.dim() - b.dim():]) != tuple(b.shape):
        raise ValueError(f"mont_mul: b {tuple(b.shape)} does not broadcast onto a {tuple(a.shape)}")
    a, b = cuda_lib.aligned(a), cuda_lib.aligned(b)
    out = torch.empty_like(a)
    n = a.numel() // nl
    if n:
        rc = cuda_lib.lib().hk_mont_mul(
            fid, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, b.numel() // nl,
            cuda_lib.stream_ptr(a.device),
        )
        cuda_lib.check("hk_mont_mul", rc)
        _count(mont_mul, spec)
    return out


reset_counts(mont_mul)


def fermat_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^-1 on (..., nlimbs) canonical Montgomery limbs, canonical; inv(0) =
    0: the value of a^(p-2) (mont_inv, the plain version), by the divstep
    kernel on a CUDA tensor."""
    if not a.is_cuda:
        return fermat_inv_plain(spec, a)
    fid = _field_id(spec)
    check_limbs("fermat_inv", a, a.device, spec.nlimbs)
    out = torch.empty_like(a)
    n = a.numel() // spec.nlimbs
    if n:
        rc = cuda_lib.lib().hk_fermat_inv(fid, a.data_ptr(), out.data_ptr(), n, cuda_lib.stream_ptr(a.device))
        cuda_lib.check("hk_fermat_inv", rc)
        _count(fermat_inv, spec)
    return out


reset_counts(fermat_inv)

// BN254 G1 kernels: the MSM's complete batched-affine add, one round of its
// level-1 halves pairing and its window Horner fold; and the Jacobian mixed
// add of the fixed-base scalar muls.
//
// aff_add (root + fin) replaces curves/pallas_curve.py::aff_add_fused
// (_aff_root_kernel :426, _aff_fin_tree_kernel :442). halves (a root, then
// a step a round) replaces curves/pallas_curve.py::l1_aff_halves
// (_aff_halves_root_kernel :802, _aff_halves_fin_kernel :822, tr=False).
// horner replaces curves/pallas_curve.py::horner_fold (_horner_kernel :583).
// pmadd_rcb, padd_rcb and pdbl_rcb replace curves/pallas_curve.py::pmadd_rcb,
// ::padd_rcb and ::pdbl_rcb (_pmadd_rcb_kernel :1206 on _pmadd_rcb_tiles
// :264, _padd_rcb_kernel :1216 on _padd_rcb_tiles :291, _pdbl_rcb_kernel
// :1226 on _pdbl_rcb_tiles :314). l1_rcb_mega replaces
// curves/pallas_curve.py::l1_rcb_mega (_l1_mega_kernel :470). madd replaces curves/pallas_curve.py::madd (_madd_kernel :1178, formulas
// _madd_tiles :164 with the _dbl_tiles escape :146). dbl and add replace
// curves/pallas_curve.py::dbl and ::add (_dbl_kernel :1188 on _dbl_tiles
// :146, _add_kernel :1196 on _add_tiles :210). jac_ladder, jac_sum and
// jac_horner run the JAX compact msm's loops of kernels in one launch each
// (hekaton_tpu/msm/pippenger.py: _msm_ladder :209 of dbl and madd,
// _tree_reduce's chunks :159 and msm's Horner :258 of dbl and add), on the
// complete RCB formulas: the loops' points, not their limbs.
//
// Complete-add semantics are those of _aff_den_tiles / _aff_fin_tiles
// (pallas_curve.py:350-424): (0,0) is infinity, a lane with P == Q doubles,
// an inverse pair P == -Q gives infinity; degenerate denominators are 1 so
// the shared inversion stays defined.
//
// Design of the affine pairs: Montgomery's trick in two levels around
// batch_inv.
// - A chain a thread: each thread owns a run of k adds (K_ADD lanes strided
//   by the thread count for aff_add, a slab column's pairs for a halves
//   round) and multiplies their masked denominators into a prefix chain,
//   kept in a planar scratch (word w of entry j of chain t at
//   pre[(j*8 + w)*nchains + t], so a warp's loads are 32 adjacent words).
// - A fold a warp: warp_fold multiplies the warp's 32 chain ends together
//   by a butterfly of shuffles (9 products a thread) and leaves each thread
//   the product of the other 31; batch_inv (the divstep kernel) inverts one
//   root a warp instead of one a thread: 22,961 lanes instead of 734,740
//   for a round of a 2^20 MSM's level 1.
// - The finish unfolds (one product) and walks its chain back, giving every
//   add its 1/den; it computes an add's flags once, for the sum and for the
//   den the walk needs. An in-kernel inversion was the alternative: ~43K
//   cycles of one thread's divsteps that the block's other warps would wait
//   on, five times a level 1.
// A lane's limb rows, and a packed row, are four 16-byte loads each (the
// wrappers pass 16-byte aligned rows, copying a view that is not).
//
// The halves are log2(L)+1 kernels with a fold each round, not a root and
// a finish kernel each round: halves_root builds round 1's chains from the
// slab, and each halves_step finishes a round and, with its sums still in
// registers, builds the next round's chains. Round r+1 adds round r's sums
// i and i + k/2. A round's chain visits its pairs in bit-reversed order
// (chain_pair), so the walk back meets the two sums of each next-round pair
// one after the other, and the order they complete in is the next round's
// chain order: the bit reversal of k-1-p, so the rounds alternate (`flip`).
// Between rounds the sums sit in transposed (k*16, ncols) slabs whatever
// the first slab's layout, so every later load is 32 adjacent words; each
// operand is read once a round, the first slab twice (root and step).
//
// What bounds them on an H100: an add needs 5 Montgomery products and a
// square (3 products of the trick; lambda, lambda^2, lambda (x1 - x3) of the
// sum: 1,528 32-bit multiplies) against 384 bytes
// (aff_add) or ~128 (a halves add: its share of the slab and of the
// output), so both pairs are bound by integer multiply throughput; the
// folds add ~10 products a chain, a fifth of a level 1's products. Measured
// on one H100 80GB HBM3 (700 W) in turns with the previous design (a root
// and a finish kernel a round, batch_inv of every chain end, C carries;
// benches/torch_aff_ab.py): a 2^20 MSM's level 1 (734,740 columns x 32)
// 6.2 ms in either layout against 14.3 (rows) and 11.5 (transposed), bound
// 1.85 (the 89% of its 734,740 x 31 adds that have no (0,0) sentinel
// operand: an add with the sentinel needs no product); aff_add 0.12 ms at
// 2^18 lanes against 0.215, bound 0.030 (PERF.md).
// The horner fold is a chain of (W-1)(c+1) dependent point operations on
// one lane: bound by that chain's latency, not by bytes or multiplies. One
// warp walks it, a Montgomery product a lane: a point op is two levels of
// independent products (a double 4 + 4, an add 6 + 6), so its latency is
// two products' and the field additions between them, not 8 or 12
// products'. On one H100 80GB HBM3 (700 W), in turns with the one-thread
// body (benches/torch_aff_ab.py): 0.43 ms against 1.09 at W=20, c=13; a
// double 1.55 us against 3.87, an add 2.52 against 6.76, of which two
// products are ~0.56 us: the additions and mul9s between the levels,
// serial on the volatile carry chains, are most of the rest. A product
// over 16 lanes (shuffles, ballots) and additions in C were slower
// (PERF.md).
//
// madd is one thread per lane on madd-2007-bl against 512 bytes of (n, 16)
// limb rows in and out, 16 bytes a load. _madd_tiles' edge overrides are
// branches in its order, taken before the arithmetic they make moot: P at
// infinity (every lane of a fixed-base call's first window) moves bytes
// only, Q the (0,0) sentinel keeps P, and Q = P calls the doubling escape
// (dbl-2009-l, madd_dbl_lane: out of line, it reloads P), so no lane keeps
// the inputs live through the formula for a final select. The formula
// runs on the mixed add's column products and lazy sums (below): 11 wide
// products (3 squares) and 10 reductions, z3 = (z1 + h)^2 - z1z1 - hh as the
// same value 2 z1 h, y3 = r2 (v - x3) - 2 y1 j one sum of two products; 116
// registers, 4 blocks an SM. dbl (dbl-2009-l) and add (add-2007-bl) are the
// same design: one thread per lane on column products and lazy sums, 16-byte
// rows, (128, 4); dbl 7 wide products (2 squares) and 6 reductions, add 16
// (4 squares) and 15 on a lane with both operands finite, its overrides
// (_add_tiles', curves/cuda_curve.py::add_plain) branches before the
// arithmetic they make moot and its doubling escape madd's out-of-line one.
// The compact msm ran them one host launch a point op, at 1 to a few
// thousand lanes, where the launch, not the multiplies, set the time. Its
// chains now run in one launch each, bound by the chain's latency, one warp
// a lane on horner_fold's two-level RCB ops (horner_dbl, horner_add and a
// two-level mixed add, horner_madd), so an op is two levels of products, not
// one thread's product after product: jac_ladder (every lane's nbits
// doublings and mixed adds), jac_sum (a chunk's K adds a lane) and
// jac_horner (the (W-1)(c+1) ops of the Horner combine, one lane). On one
// H100 80GB HBM3 (700 W), in turns with the row-product bodies and their
// loops of launches (benches/torch_aff_ab.py): dbl 0.051 ms against 0.175 at
// 2^18 lanes (bound 0.030, bytes), add 0.102 against 0.237 (bound 0.061,
// multiplies); the 32-lane ladder 0.776 ms against one thread a lane's 2.02
// (PERF.md).
//
// The G1 RCB ops (RCB15 algorithms 8, 7 and 9, a=0, b3=9: the complete
// projective formulas of curves/proj.py, with no escapes) are the same
// design: one thread per lane on (n, 16) limb rows. An add is 12 products
// against 576 bytes in and out, a double 8 (2 of them squares) against 384,
// bound by bytes (the adds) or by integer multiply throughput once the card
// is full. pdbl_rcb runs on canonical values and full products.
//
// The mixed add (pmadd_rcb, and every add of l1_rcb_mega), the full add
// (padd_rcb) and madd run on lazy sums: their values between products may
// exceed p, as far as each product's 16-word sum stays below p 2^256, and
// each closing coordinate (x3 = t3 t1 - t4 y3, y3 = t1 z3 + y3 t0, z3 = z3
// t4 + t0 t3) is one sum of two wide products and one reduction (fe_dot):
// the mixed add 11 wide products and 8 reductions, 2,496 32-bit multiplies
// against 2,904 for 11 full products, the full add 12 and 9, and fewer
// modular additions (t4, z3 and t1 - t2 stay lazy, below 2p). Their products
// run by product scanning (col_dot): column by column into a three-register
// accumulator whose 64-bit pair stays put, where field.cuh's row chains
// (mac_row) add each 64-bit product (IMAD.WIDE) into another pair of the
// 16-word sum and ptxas re-pairs the words for it with moves: ~1,070 a
// mixed add (676 MOV, 394 IMAD.MOV), gone; 2,840 SASS instructions against
// 3,552. Their rows move 16 bytes at a time. Held to 128 registers
// (__launch_bounds__(128, 4); 116-122 used), they keep 16 warps an SM where
// the full-product mixed adds (130-150 registers) kept 12. On one H100 80GB HBM3
// (700 W), in turns with those bodies (benches/torch_aff_ab.py): pmadd_rcb
// 0.073 ms against 0.20 at 2^18 lanes, 0.16 against 0.50 at route (c)'s
// 734,740, its bound 0.11 ms (bytes: 512 a lane); the 2^20 MSM's mega
// level 1 (734,740 columns x 32) 4.3 ms against 6.9 in either layout, its
// bound 3.03 (multiplies); padd_rcb 0.077 against 0.226 at 2^18 lanes,
// 0.177 against 0.551 at 734,740 (bound 0.126, bytes); madd 0.071 against
// 0.199 at 2^18 lanes, 0.070 against 0.194 at a fixed-base call's 255,357
// (bound 0.040, multiplies). Slower: 3 blocks an SM (134 registers) or 5
// (94-96, padd_rcb spilling 48 bytes); one resident wave of blocks walking
// the lanes, with or without an L2 prefetch of each block's next lanes; a
// column-form square in madd (PERF.md). The mixed add needs
// no escape: the (0,0) sentinel operand (ay = 0 only there) keeps P, by a
// branch around the op, so that P need not stay live through it.
//
// l1_rcb_mega is MSM level 1 on the accum="proj" routes: per column of the
// (ncols, L*16) packed slab, the L packed rows added in order into the
// identity (0:1:0) by pmadd_rcb. The Pallas kernel keeps a block of 1,024
// columns' accumulators in VMEM across a fori_loop over L and reads the slab
// transposed, (L*16, ncols), so each step is a sublane band; its plan pads
// the columns to a multiple of that block (pippenger.py:1085-1087). Here
// one thread owns one column: the accumulator stays in registers for all L
// steps, the column's row is one contiguous L*64-byte run (16-byte loads),
// and a bounds check masks the ragged edge, so the port's plan keeps
// col_pad = 1 (fewer columns than the JAX plan, the same bucket sums) and
// takes the slab in its own (ncols, L*16) layout. A column of n points needs
// n - 1 mixed adds (its first point into the identity takes 2 products)
// against L x 64 bytes in and 192 out: bound by integer multiply
// throughput. The L adds of a column depend on each other; the card hides
// that chain with the ~735K independent columns of a 2^20-point MSM (a
// load of row r+1 overlapped with the add of row r did not pay).
//
// Slab layouts. The halves kernels and l1_rcb_mega take a template flag
// TR: false reads the port's (ncols, l*16) slab, where word w of element i
// of column c is at v[c*l*16 + i*16 + w] (each thread reads its own 64-byte
// runs, in 16-byte loads in the halves); true reads the transposed
// (l*16, ncols) slab of the tsort plan, word w of element i at
// v[(i*16 + w)*ncols + c], so the 32 threads of a warp read 32 adjacent
// words for every word they load. The halves with TR = true replace
// curves/pallas_curve.py::l1_aff_halves_t (:906, the same two bodies with
// tr=True) and return a (16, ncols) slab; l1_rcb_mega with TR = true is the
// JAX l1_rcb_mega's own layout.
//
// interleave_slab_t replaces curves/pallas_curve.py::interleave_slab_t
// (_interleave_slab_t_kernel :498): 16 (W, L, mcols) word planes to the
// (L*16, W*mcols) transposed slab, slab_t[r*16 + j][w*mcols + m] =
// planes[j][w][r][m]. It is pure data movement, bound by bytes (each word
// read once and written once): a block copies one plane row's run of m into
// one slab row, 16 bytes a thread where mcols % 4 == 0 and both pointers are
// 16-byte aligned (msm_gpu pads mcols to a multiple of 32), so reads and writes are both coalesced along m and
// no thread divides. The Pallas kernel's 8-row blocks exist for the TPU's
// tiling; nothing here needs L a multiple of 8.
//
// aff_root / aff_fin with PACKED = true replace
// curves/pallas_curve.py::aff_add_mixed_packed (:712; _aff_root_packed_kernel
// :650, _aff_fin_tree_packed_kernel :661): the same complete add with the
// second operand read as a packed (n, 16) slab row (8 x-words, 8 y-words),
// so the steps route adds a slab row without unpacking it in torch. Bound
// as the aff_add pair. No padding: the JAX wrapper pads n to a multiple of
// 1,024 with (0,0) lanes, whose denominators are 1; here lanes past n are
// masked to 1 as well, so every real lane gets the same sum.
//
// aff_prep and aff_finish replace curves/pallas_curve.py::aff_prep and
// ::aff_fin (:1305/:1310; _aff_prep_kernel :957 on _aff_prep_tiles :374,
// _aff_fin_kernel :963 on _aff_fin_tiles :392): the unfused halves of the
// complete add around a caller's batch inversion, one thread per lane, its
// rows by 16-byte loads and stores.
// aff_prep writes the masked denominator and the numerator (3*x1^2 on
// doubling lanes, dy elsewhere; _num_tiles' block-level lax.cond does not
// change the values); aff_finish takes the numerator it is given. aff_prep
// is subtractions (a square on doubling lanes only) against 256 bytes in and
// 128 out, aff_finish three products against 384 in and 128 out: both bound
// by bytes.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace hk;

namespace {

constexpr int THREADS = 128;
constexpr int COPY_THREADS = 256;  // the interleave copy
constexpr int RCB_MIN_BLOCKS = 4;  // pmadd_rcb and l1_rcb_mega: 128 registers a thread, 16 warps an SM

struct Aff {
  Fe x, y;
};

struct AffFlags {
  bool q_inf, p_inf, same_x, dbl;
  Fe dx, dy;
};

__device__ __forceinline__ AffFlags aff_flags(const Aff& p, const Aff& q) {
  AffFlags f;
  f.q_inf = fe_is_zero(q.y);
  f.p_inf = fe_is_zero(p.y);
  f.dx = fe_sub<FQ>(q.x, p.x);
  f.dy = fe_sub<FQ>(q.y, p.y);
  f.same_x = fe_is_zero(f.dx);
  f.dbl = f.same_x && fe_is_zero(f.dy);
  return f;
}

// masked slope denominator: dx, 2*y1 when doubling, 1 when degenerate
__device__ __forceinline__ Fe den_of(const Aff& p, const AffFlags& f) {
  Fe den = f.dbl ? fe_add<FQ>(p.y, p.y) : f.dx;
  bool degen = f.q_inf || f.p_inf || (f.same_x && !f.dbl);
  return degen ? fe_one<FQ>() : den;
}

__device__ __forceinline__ Fe aff_den(const Aff& p, const Aff& q) { return den_of(p, aff_flags(p, q)); }

// slope numerator: 3*x1^2 when doubling, dy otherwise
__device__ __forceinline__ Fe aff_num(const Aff& p, const AffFlags& f) {
  Fe num = f.dy;
  if (f.dbl) {
    Fe x1sq = fe_sqr<FQ>(p.x);
    num = fe_add<FQ>(fe_add<FQ>(x1sq, x1sq), x1sq);
  }
  return num;
}

// complete P + Q from the inverted denominator and the numerator
__device__ __forceinline__ Aff aff_sum(const Aff& p, const Aff& q, const AffFlags& f, const Fe& inv,
                                       const Fe& num) {
  Fe lam = fe_mul<FQ>(num, inv);
  Fe x2s = f.dbl ? p.x : q.x;
  Aff r;
  r.x = fe_sub<FQ>(fe_sub<FQ>(fe_sqr<FQ>(lam), p.x), x2s);
  r.y = fe_sub<FQ>(fe_mul<FQ>(lam, fe_sub<FQ>(p.x, r.x)), p.y);
  bool inverse = f.same_x && !f.dbl && !(f.p_inf || f.q_inf);
  if (inverse) r.x = r.y = fe_zero();
  if (f.q_inf) r = p;
  if (f.p_inf) r = q;
  return r;
}

// packed slab element whose 16 words lie `stride` apart: 8 x-words then 8
// y-words
__device__ __forceinline__ Aff load_packed(const int32_t* e, long long stride) {
  Aff a;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    a.x.w[i] = (uint32_t)e[i * stride];
    a.y.w[i] = (uint32_t)e[(8 + i) * stride];
  }
  return a;
}

__device__ __forceinline__ void store_packed(int32_t* e, long long stride, const Aff& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    e[i * stride] = (int32_t)a.x.w[i];
    e[(8 + i) * stride] = (int32_t)a.y.w[i];
  }
}

// -- 16-byte loads and stores of a packed row (the row 16-byte aligned) --

// packed (16,) row (8 x-words, 8 y-words) -> a point, and back
__device__ __forceinline__ Aff load_packed4(const int32_t* e) {
  const uint4* s4 = reinterpret_cast<const uint4*>(e);
  Aff a;
#pragma unroll
  for (int q = 0; q < 2; q++) {
    uint4 x = s4[q], y = s4[2 + q];
    a.x.w[4 * q] = x.x, a.x.w[4 * q + 1] = x.y, a.x.w[4 * q + 2] = x.z, a.x.w[4 * q + 3] = x.w;
    a.y.w[4 * q] = y.x, a.y.w[4 * q + 1] = y.y, a.y.w[4 * q + 2] = y.z, a.y.w[4 * q + 3] = y.w;
  }
  return a;
}

__device__ __forceinline__ void store_packed4(int32_t* e, const Aff& a) {
  uint4* d4 = reinterpret_cast<uint4*>(e);
#pragma unroll
  for (int q = 0; q < 2; q++) {
    d4[q] = make_uint4(a.x.w[4 * q], a.x.w[4 * q + 1], a.x.w[4 * q + 2], a.x.w[4 * q + 3]);
    d4[2 + q] = make_uint4(a.y.w[4 * q], a.y.w[4 * q + 1], a.y.w[4 * q + 2], a.y.w[4 * q + 3]);
  }
}

// element i of column c of a slab of l elements a column: its first word
// (the TR flag of the slab layouts above; the transposed layout's words lie
// ncols apart)
template <bool TR>
__device__ __forceinline__ long long slab_at(long long c, int i, int l, long long ncols) {
  return TR ? (long long)i * 16 * ncols + c : c * (16LL * l) + i * 16;
}

// a slab element: in the transposed layout a warp's 16 loads are each 32
// adjacent words; in the rows layout each thread's 64-byte run is four
// 16-byte loads
template <bool TR>
__device__ __forceinline__ Aff load_elem(const int32_t* v, long long c, int i, int l, long long ncols) {
  if constexpr (TR) {
    return load_packed(v + slab_at<true>(c, i, l, ncols), ncols);
  } else {
    return load_packed4(v + slab_at<false>(c, i, l, ncols));
  }
}

template <bool TR>
__device__ __forceinline__ void store_elem(int32_t* v, long long c, int i, int l, long long ncols, const Aff& a) {
  if constexpr (TR) {
    store_packed(v + slab_at<true>(c, i, l, ncols), ncols, a);
  } else {
    store_packed4(v + slab_at<false>(c, i, l, ncols), a);
  }
}

// entry j of chain t in a planar scratch of `nchains` chains: word w at
// buf[(j*8 + w)*nchains + t], so a warp's loads are 32 adjacent words
__device__ __forceinline__ Fe load_planar(const int32_t* buf, long long nchains, int j, long long t) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.w[w] = (uint32_t)buf[((long long)j * 8 + w) * nchains + t];
  return r;
}

__device__ __forceinline__ void store_planar(int32_t* buf, long long nchains, int j, long long t, const Fe& a) {
#pragma unroll
  for (int w = 0; w < 8; w++) buf[((long long)j * 8 + w) * nchains + t] = (int32_t)a.w[w];
}

// -- the fold: Montgomery's trick across the chains of a warp --

// `total` gets the product of the 32 lanes' r (the same canonical value in
// every lane, since the product commutes), `others` the product of the
// other 31 lanes' r, so that 1/r = others / total. A butterfly: at step d
// a lane multiplies in lane^d's partial product, the product of the group
// of d lanes that its own group pairs with; those partners, multiplied
// together, hold every other lane's r once. 9 products, 40 shuffles.
__device__ __forceinline__ void warp_fold(const Fe& r, Fe& total, Fe& others) {
  Fe g = r;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Fe q;
#pragma unroll
    for (int i = 0; i < 8; i++) q.w[i] = __shfl_xor_sync(0xffffffffu, g.w[i], d);
    others = d == 1 ? q : fe_mul<FQ>(others, q);
    g = fe_mul<FQ>(g, q);
  }
  total = g;
}

// fold the warp's chain ends `acc`: each chain's `others` to ex (planar),
// the warp's product to roots (limb rows, one a warp), for batch_inv
__device__ __forceinline__ void fold_out(const Fe& acc, int32_t* ex, int32_t* roots, long long nchains,
                                         long long t) {
  Fe total, others;
  warp_fold(acc, total, others);
  if (t < nchains) store_planar(ex, nchains, 0, t, others);
  if ((t & 31) == 0) store_limbs(roots + (t >> 5) * 16, total);
}

// 1 / (chain t's product) from its warp's inverted root and its `others`
__device__ __forceinline__ Fe unfold(const int32_t* ex, const int32_t* rinv, long long nchains, long long t) {
  return fe_mul<FQ>(load_limbs(rinv + (t >> 5) * 16), load_planar(ex, nchains, 0, t));
}

// the pair at position p of a halves round's chain of k pairs (k a power of
// two): p bit-reversed, or k-1-p bit-reversed when `flip` (see the note)
__device__ __forceinline__ int chain_pair(int p, int k, bool flip) {
  const unsigned q = flip ? k - 1 - p : p;
  return k == 1 ? 0 : (int)(__brev(q) >> (33 - __ffs(k)));
}

// -- complete batched-affine add over n lanes --

// the second operand of lane i: (n, 16) limb rows px, py, or (PACKED) the
// packed (n, 16) slab row px[i]
template <bool PACKED>
__device__ __forceinline__ Aff load_q(const int32_t* px, const int32_t* py, long long i) {
  return PACKED ? load_packed4(px + i * 16) : Aff{load_limbs16(px + i * 16), load_limbs16(py + i * 16)};
}

__device__ __forceinline__ Aff load_p(const int32_t* x1, const int32_t* y1, long long i) {
  return Aff{load_limbs16(x1 + i * 16), load_limbs16(y1 + i * 16)};
}

// chain t: lanes j*nthreads + t (j < k, lane < n); pre[j] = den_0 ... den_j
// (j < k-1), then the warp's fold
template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
    aff_root_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                    const int32_t* __restrict__ px, const int32_t* __restrict__ py, int32_t* __restrict__ pre,
                    int32_t* __restrict__ ex, int32_t* __restrict__ roots, long long n, long long nthreads,
                    int k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t & ~31LL) >= nthreads) return;  // a warp with no chain
  Fe acc = fe_one<FQ>();
  if (t < nthreads) {
    for (int j = 0; j < k; j++) {
      const long long lane = (long long)j * nthreads + t;
      if (lane >= n) break;  // lanes grow with j
      Fe den = aff_den(load_p(x1, y1, lane), load_q<PACKED>(px, py, lane));
      acc = j == 0 ? den : fe_mul<FQ>(acc, den);
      if (j < k - 1) store_planar(pre, nthreads, j, t, acc);
    }
  }
  fold_out(acc, ex, roots, nthreads, t);
}

// chain t walked back from its inverse: each lane's 1/den and its sum
template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
    aff_fin_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                   const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pre, const int32_t* __restrict__ ex,
                   const int32_t* __restrict__ rinv, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                   long long n, long long nthreads, int k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nthreads) return;
  Fe inv_run = unfold(ex, rinv, nthreads, t);  // 1 / (den_0 ... den_j) for the last lane j below n
  for (int j = k - 1; j >= 0; j--) {
    const long long lane = (long long)j * nthreads + t;
    if (lane >= n) continue;
    const Aff p = load_p(x1, y1, lane);
    const Aff q = load_q<PACKED>(px, py, lane);
    const AffFlags f = aff_flags(p, q);
    const Fe inv = j > 0 ? fe_mul<FQ>(inv_run, load_planar(pre, nthreads, j - 1, t)) : inv_run;
    const Aff r = aff_sum(p, q, f, inv, aff_num(p, f));
    store_limbs16(ox + lane * 16, r.x);
    store_limbs16(oy + lane * 16, r.y);
    if (j > 0) inv_run = fe_mul<FQ>(inv_run, den_of(p, f));
  }
}

// -- MSM level 1 by halves: element i + element k+i of every column ------

// round 1's chain: column c's k pairs in chain order, pre[p] = den_0 ...
// den_p (p < k-1), then the warp's fold
template <bool TR>
__global__ void __launch_bounds__(THREADS)
    halves_root_kernel(const int32_t* __restrict__ v, int32_t* __restrict__ pre, int32_t* __restrict__ ex,
                       int32_t* __restrict__ roots, long long ncols, int k) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((c & ~31LL) >= ncols) return;  // a warp with no column
  Fe acc = fe_one<FQ>();
  if (c < ncols) {
    for (int p = 0; p < k; p++) {
      const int i = chain_pair(p, k, false);
      Fe den = aff_den(load_elem<TR>(v, c, i, 2 * k, ncols), load_elem<TR>(v, c, k + i, 2 * k, ncols));
      acc = p == 0 ? den : fe_mul<FQ>(acc, den);
      if (p < k - 1) store_planar(pre, ncols, p, c, acc);
    }
  }
  fold_out(acc, ex, roots, ncols, c);
}

// the finish of a round of k pairs a column (its chain order `flip`): the
// chain walked back gives every pair its sum, written at the pair's index;
// with k > 1 the sums go to the transposed (k*16, ncols) slab of the next
// round, whose pairs (i, i + k/2) complete two steps at a time, and whose
// chain (pre2, then the warp's fold) is built as they do; with k = 1 the
// sum is the column's, in the layout TR_OUT
template <bool TR_IN, bool TR_OUT>
__global__ void __launch_bounds__(THREADS)
    halves_step_kernel(const int32_t* __restrict__ in, const int32_t* __restrict__ pre,
                       const int32_t* __restrict__ ex, const int32_t* __restrict__ rinv,
                       int32_t* __restrict__ out, int32_t* __restrict__ pre2, int32_t* __restrict__ ex2,
                       int32_t* __restrict__ roots2, long long ncols, int k, bool flip) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((c & ~31LL) >= ncols) return;
  Fe acc2 = fe_one<FQ>();
  if (c < ncols) {
    Fe inv_run = unfold(ex, rinv, ncols, c);
    Aff held;  // the sum of chain position p+1 (odd)
    for (int p = k - 1; p >= 0; p--) {
      const int i = chain_pair(p, k, flip);
      const Aff a = load_elem<TR_IN>(in, c, i, 2 * k, ncols);
      const Aff b = load_elem<TR_IN>(in, c, k + i, 2 * k, ncols);
      const AffFlags f = aff_flags(a, b);
      const Fe inv = p > 0 ? fe_mul<FQ>(inv_run, load_planar(pre, ncols, p - 1, c)) : inv_run;
      const Aff s = aff_sum(a, b, f, inv, aff_num(a, f));
      if (p > 0) inv_run = fe_mul<FQ>(inv_run, den_of(a, f));
      if (k == 1) {
        store_elem<TR_OUT>(out, c, 0, 1, ncols, s);
      } else if (p & 1) {
        store_elem<true>(out, c, i, k, ncols, s);
        held = s;
      } else {
        store_elem<true>(out, c, i, k, ncols, s);
        // pairs i and chain_pair(p+1) differ by k/2; i is the lower unless flip
        const Fe den = flip ? aff_den(held, s) : aff_den(s, held);
        const int g = (k - 2 - p) / 2;
        acc2 = g == 0 ? den : fe_mul<FQ>(acc2, den);
        if (g < k / 2 - 1) store_planar(pre2, ncols, g, c, acc2);
      }
    }
  }
  if (k > 1) fold_out(acc2, ex2, roots2, ncols, c);
}

// -- the tsort plan's word planes -> the transposed slab ---------------------

// grid (column blocks, W, L*16): block (x, w, row) copies row `row` of
// window w's mcols words, V words a thread (V = 4: 16-byte loads and stores,
// for mcols % 4 == 0)
template <int V>
__global__ void __launch_bounds__(COPY_THREADS)
    interleave_slab_t_kernel(const int32_t* __restrict__ planes, int32_t* __restrict__ out, int W, int L,
                             int mcols) {
  int m = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (m >= mcols) return;
  int w = blockIdx.y;
  int row = blockIdx.z;  // r*16 + j
  const int32_t* src = planes + (((long long)(row & 15) * W + w) * L + (row >> 4)) * mcols + m;
  int32_t* dst = out + ((long long)row * W + w) * mcols + m;
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  } else {
    *dst = *src;
  }
}

// -- the unfused affine add: (den, num), then the sum from 1/den -------------

__global__ void __launch_bounds__(THREADS)
    aff_prep_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                    int32_t* __restrict__ den, int32_t* __restrict__ num, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Aff p = load_p(x1, y1, i);
  const Aff q = load_p(px, py, i);
  const AffFlags f = aff_flags(p, q);
  store_limbs16(den + i * 16, den_of(p, f));
  store_limbs16(num + i * 16, aff_num(p, f));
}

__global__ void __launch_bounds__(THREADS)
    aff_finish_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                      const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                      const int32_t* __restrict__ inv, const int32_t* __restrict__ num,
                      int32_t* __restrict__ ox, int32_t* __restrict__ oy, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Aff p = load_p(x1, y1, i);
  const Aff q = load_p(px, py, i);
  const Aff r = aff_sum(p, q, aff_flags(p, q), load_limbs16(inv + i * 16), load_limbs16(num + i * 16));
  store_limbs16(ox + i * 16, r.x);
  store_limbs16(oy + i * 16, r.y);
}

// -- window Horner fold on complete RCB15 projective formulas (a=0, b3=9) ---

__device__ __forceinline__ Fe mul9(const Fe& a) {
  Fe a3 = fe_add<FQ>(fe_add<FQ>(a, a), a);
  return fe_add<FQ>(fe_add<FQ>(a3, a3), a3);
}

struct Proj {
  Fe x, y, z;
};

// RCB15 Algorithm 9 (pallas_curve.py::_pdbl_rcb_tiles)
__device__ Proj pdbl_rcb(const Proj& p) {
  Fe t0 = fe_sqr<FQ>(p.y);
  Fe z3 = fe_add<FQ>(t0, t0);
  z3 = fe_add<FQ>(z3, z3);
  z3 = fe_add<FQ>(z3, z3);
  Fe t1 = fe_mul<FQ>(p.y, p.z);
  Fe t2 = mul9(fe_sqr<FQ>(p.z));
  Fe x3 = fe_mul<FQ>(t2, z3);
  Fe y3 = fe_add<FQ>(t0, t2);
  z3 = fe_mul<FQ>(t1, z3);
  t1 = fe_add<FQ>(t2, t2);
  t2 = fe_add<FQ>(t1, t2);
  t0 = fe_sub<FQ>(t0, t2);
  y3 = fe_mul<FQ>(t0, y3);
  y3 = fe_add<FQ>(x3, y3);
  t1 = fe_mul<FQ>(p.x, p.y);
  x3 = fe_mul<FQ>(t0, t1);
  x3 = fe_add<FQ>(x3, x3);
  return Proj{x3, y3, z3};
}

// -- the G1 mixed add on lazy sums (pmadd_rcb, l1_rcb_mega) ------------------
//
// Its values are 8 words that need not be canonical: a lazy sum of two
// values below p is below 2p < 2^256 (p < 2^256 / 5.29), and an operand
// pair of a product may reach any bounds whose product keeps the 16-word
// sum below p 2^256, where one reduction (col_dot) returns a value below 2p
// and its conditional subtraction the canonical one. The bounds are written
// beside each value, in units of p.

// a + b, no reduction: the caller keeps it below 2^256
__device__ __forceinline__ Fe lazy_add(const Fe& a, const Fe& b) {
  Fe r;
  r.w[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 7; i++) r.w[i] = ptx::addc_cc(a.w[i], b.w[i]);
  r.w[7] = ptx::addc(a.w[7], b.w[7]);
  return r;
}

// a + p - b for b <= a + p < 2^256: the subtraction's borrow and the
// addition's carry cancel, words mod 2^256
__device__ __forceinline__ Fe lazy_sub(const Fe& a, const Fe& b) {
  Fe r;
  r.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 7; i++) r.w[i] = ptx::subc_cc(a.w[i], b.w[i]);
  r.w[7] = ptx::subc(a.w[7], b.w[7]);
  r.w[0] = ptx::add_cc(r.w[0], Field<FQ>::p(0));
#pragma unroll
  for (int i = 1; i < 7; i++) r.w[i] = ptx::addc_cc(r.w[i], Field<FQ>::p(i));
  r.w[7] = ptx::addc(r.w[7], Field<FQ>::p(7));
  return r;
}

// p - b for canonical b: in (0, p]
__device__ __forceinline__ Fe lazy_neg(const Fe& b) {
  Fe r;
  r.w[0] = ptx::sub_cc(Field<FQ>::p(0), b.w[0]);
#pragma unroll
  for (int i = 1; i < 7; i++) r.w[i] = ptx::subc_cc(Field<FQ>::p(i), b.w[i]);
  r.w[7] = ptx::subc(Field<FQ>::p(7), b.w[7]);
  return r;
}

// a column's sum in three words: lo, hi and the carries above them
struct Col {
  uint32_t lo, hi, c2;
};

// s += a b: one 64-bit product into the aligned pair (lo, hi), its carry
// into c2
__device__ __forceinline__ void col_mad(Col& s, uint32_t a, uint32_t b) {
  s.lo = ptx::mad_lo_cc(a, b, s.lo);
  s.hi = ptx::madc_hi_cc(a, b, s.hi);
  s.c2 = ptx::addc(s.c2, 0u);
}

// (sum of a_t b_t over N pairs) R^-1 mod p, canonical, for a sum below p
// 2^256, by product scanning: column k of the 16-word sum gathers its word
// products and those of m_i p, and the low columns set m_k = (column k)
// (-p^-1) mod 2^32 and add m_k p_0, which clears them (Montgomery's
// reduction in its column form: the same m_k as redc_wide, so the same
// value). The accumulator is three registers, not 16 words.
template <int N>
__device__ __forceinline__ Fe col_dot(const Fe (&a)[N], const Fe (&b)[N]) {
  uint32_t m[8];
  Fe r;
  Col s{0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 15; k++) {
#pragma unroll
    for (int t = 0; t < N; t++) {
#pragma unroll
      for (int i = (k > 7 ? k - 7 : 0); i <= (k < 7 ? k : 7); i++) col_mad(s, a[t].w[i], b[t].w[k - i]);
    }
#pragma unroll
    for (int i = (k > 7 ? k - 7 : 0); i < (k < 8 ? k : 8); i++) col_mad(s, m[i], Field<FQ>::p(k - i));
    if (k < 8) {
      m[k] = s.lo * Field<FQ>::ninv();
      col_mad(s, m[k], Field<FQ>::p(0));
    } else {
      r.w[k - 8] = s.lo;
    }
    s = Col{s.hi, s.c2, 0u};
  }
  r.w[7] = s.lo;
  return reduce_once<FQ>(r.w, s.hi);
}

__device__ __forceinline__ Fe col_mul(const Fe& a, const Fe& b) {
  const Fe x[1] = {a}, y[1] = {b};
  return col_dot<1>(x, y);
}

// (a b + c d) R^-1 mod p, canonical, for a b + c d < p 2^256: one sum of
// the two products and one reduction
__device__ __forceinline__ Fe fe_dot(const Fe& a, const Fe& b, const Fe& c, const Fe& d) {
  const Fe x[2] = {a, c}, y[2] = {b, d};
  return col_dot<2>(x, y);
}

// RCB15 Algorithm 8 (a=0, Z2=1, b3=9; pallas_curve.py::_pmadd_rcb_tiles)
// for an operand other than the (0,0) sentinel (the callers keep P there):
// 11 wide products, 8 reductions. Source order is the schedule (the carry
// chains are volatile), chosen so that an input dies at its last product
// (on field.cuh's row products, t0 and t1 first made the transposed mega
// kernel spill 24 bytes under the 128-register cap).
__device__ __forceinline__ Proj pmadd_rcb(const Proj& p, const Fe& ax, const Fe& ay) {
  const Fe s = col_mul(lazy_add(ax, ay), lazy_add(p.x, p.y));                 // operands < 2: 4 p^2
  const Fe t0 = col_mul(p.x, ax);                                             // < 1
  Fe t1 = col_mul(p.y, ay);                                                   // < 1
  const Fe t3 = fe_sub<FQ>(s, fe_add<FQ>(t0, t1));                            // < 1
  const Fe y3 = mul9(fe_add<FQ>(col_mul(ax, p.z), p.x));                      // < 1
  const Fe t4 = lazy_add(col_mul(ay, p.z), p.y);                              // < 2
  const Fe t2 = mul9(p.z);                                                    // < 1
  const Fe z3 = lazy_add(t1, t2);                                             // < 2
  t1 = lazy_sub(t1, t2);                                                      // (0, 2)
  const Fe t0x3 = fe_add<FQ>(fe_add<FQ>(t0, t0), t0);                         // < 1
  // the closing sums, each below 5 p^2 < p 2^256
  Proj r;
  r.x = fe_dot(t3, t1, t4, lazy_neg(y3));  // t3 t1 - t4 y3 + p t4: 1*2 + 2*1 = 4 p^2
  r.y = fe_dot(t1, z3, y3, t0x3);          // 2*2 + 1*1 = 5 p^2
  r.z = fe_dot(z3, t4, t0x3, t3);          // 2*2 + 1*1 = 5 p^2
  return r;
}

// RCB15 Algorithm 7 (a=0, b3=9; pallas_curve.py::_padd_rcb_tiles) on the
// mixed add's terms: 12 wide products, 9 reductions. Each input pair dies
// at its last product (x after w, y after u, z after t2), so at most two
// coordinates of each point and four products are live at once.
__device__ __forceinline__ Proj padd_rcb(const Proj& p, const Proj& q) {
  const Fe s = col_mul(lazy_add(p.x, p.y), lazy_add(q.x, q.y));  // operands < 2: 4 p^2
  Fe t0 = col_mul(p.x, q.x);                                     // < 1
  const Fe w = col_mul(lazy_add(p.x, p.z), lazy_add(q.x, q.z));  // operands < 2: 4 p^2
  Fe t1 = col_mul(p.y, q.y);                                     // < 1
  const Fe t3 = fe_sub<FQ>(s, fe_add<FQ>(t0, t1));               // < 1
  const Fe u = col_mul(lazy_add(p.y, p.z), lazy_add(q.y, q.z));  // operands < 2: 4 p^2
  const Fe t2 = col_mul(p.z, q.z);                               // < 1
  const Fe t4 = lazy_sub(u, fe_add<FQ>(t1, t2));                 // (0, 2)
  const Fe y3 = mul9(fe_sub<FQ>(w, fe_add<FQ>(t0, t2)));         // < 1
  const Fe t2x9 = mul9(t2);                                      // < 1
  const Fe z3 = lazy_add(t1, t2x9);                              // < 2
  t1 = lazy_sub(t1, t2x9);                                       // (0, 2)
  t0 = fe_add<FQ>(fe_add<FQ>(t0, t0), t0);                       // < 1
  // the closing sums, each below 5 p^2 < p 2^256
  Proj r;
  r.x = fe_dot(t3, t1, t4, lazy_neg(y3));  // t3 t1 - t4 y3 + p t4: 1*2 + 2*1 = 4 p^2
  r.y = fe_dot(t1, z3, y3, t0);            // 2*2 + 1*1 = 5 p^2
  r.z = fe_dot(z3, t4, t0, t3);            // 2*2 + 1*1 = 5 p^2
  return r;
}

// madd-2007-bl (pallas_curve.py::_madd_tiles) for P and Q finite and Q !=
// P, on h = u2 - x1 and rr = s2 - y1 (madd_diffs; canonical: the caller
// tests them for zero): with madd_diffs 11 wide products (3 squares) and 10
// reductions, z3 = (z1 + h)^2 - z1z1 - hh as the same value 2 z1 h, and y3 =
// r2 (v - x3) - 2 y1 j as one sum of two products. An inverse pair's x3 and
// y3 are these too. add-2007-bl ends the same way on u1, s1 and z1 z2
// (add_diffs).
__device__ __forceinline__ void madd_finish(const Fe& x1, const Fe& y1, const Fe& z1, const Fe& h, const Fe& rr,
                                            Fe& x3, Fe& y3, Fe& z3) {
  z3 = col_mul(lazy_add(z1, z1), h);                                       // < 1
  const Fe hh = col_mul(h, h);                                             // < 1
  const Fe hh2 = lazy_add(hh, hh);                                         // < 2
  const Fe i4 = lazy_add(hh2, hh2);                                        // < 4
  const Fe j = col_mul(h, i4);                                             // < 1
  const Fe v = col_mul(x1, i4);                                            // < 1
  const Fe r2 = lazy_add(rr, rr);                                          // < 2
  x3 = fe_sub<FQ>(fe_sub<FQ>(col_mul(r2, r2), j), fe_add<FQ>(v, v));       // < 1
  y3 = fe_dot(r2, fe_sub<FQ>(v, x3), lazy_add(y1, y1), lazy_neg(j));  // 2*1 + 2*1 = 4 p^2
}

__device__ __forceinline__ Proj load_proj(const int32_t* x, const int32_t* y, const int32_t* z,
                                          long long i) {
  return Proj{load_limbs(x + i * 16), load_limbs(y + i * 16), load_limbs(z + i * 16)};
}

__device__ __forceinline__ void store_proj(int32_t* x, int32_t* y, int32_t* z, long long i,
                                           const Proj& p) {
  store_limbs(x + i * 16, p.x);
  store_limbs(y + i * 16, p.y);
  store_limbs(z + i * 16, p.z);
}

// -- the window Horner fold: one warp, a Montgomery product a lane ----------
//
// One warp walks the chain of (W-1)(c+1) point ops. Every lane holds the
// accumulator (the same values in all 32: the code is uniform, so no lane
// takes another branch), and the W window sums sit in shared memory,
// loaded once. A point op is its two levels of independent products (a
// double: Y^2, YZ, Z^2, XY, then t2 z3, t1 z3, t0 y3, t0 XY; an add: six,
// then the six closing ones): lane h makes product h of a level (lanes past
// the level's width repeat one of them) and writes it to shared memory;
// after a __syncwarp every lane reads the level back and computes the sums
// and mul9s that the next level's operands need. Two buffers, one a level:
// a lane writes a level's buffer again only after the __syncwarp of the
// level between, which every lane reaches after it has read the buffer.
constexpr int HORNER_THREADS = 32;
using HornerLevels = uint32_t[2][8][8];  // the two levels' products (static shared memory)
// the W * 96 bytes of window sums (dynamic) and the levels in the 48 KB a
// block may have without cudaFuncSetAttribute
constexpr int HORNER_MAX_W = (48 * 1024 - sizeof(HornerLevels)) / (24 * sizeof(uint32_t));
static_assert(HORNER_MAX_W == 506, "the window sums and the levels in 48 KB");

__device__ __forceinline__ void put_fe(uint32_t* s, const Fe& v) {
  uint4* d = reinterpret_cast<uint4*>(s);
  d[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  d[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

__device__ __forceinline__ Fe get_fe(const uint32_t* s) {
  const uint4* q = reinterpret_cast<const uint4*>(s);
  const uint4 a = q[0], b = q[1];
  Fe r;
  r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
  r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
  return r;
}

// the h-th of the values (selects: the same instructions in every lane)
__device__ __forceinline__ Fe pick(int, const Fe& v) { return v; }

template <typename... Rest>
__device__ __forceinline__ Fe pick(int h, const Fe& v, const Rest&... rest) {
  return fe_select(h == 0, v, pick(h - 1, rest...));
}

// one level of n products: lane h < n writes a b to slot h of `out`
__device__ __forceinline__ void level(uint32_t (*out)[8], int n, const Fe& a, const Fe& b) {
  const Fe r = fe_mul<FQ>(a, b);
  if ((int)threadIdx.x < n) put_fe(out[threadIdx.x], r);
  __syncwarp();
}

using Levels = uint32_t (*)[8][8];

// RCB15 Algorithm 9 (a=0, b3=9), pdbl_rcb's values in two levels
__device__ Proj horner_dbl(const Proj& p, Levels lv) {
  const int h = threadIdx.x & 3;
  level(lv[0], 4, pick(h, p.y, p.y, p.z, p.x), pick(h, p.y, p.z, p.z, p.y));  // Y^2, YZ, Z^2, XY
  const Fe yy = get_fe(lv[0][0]), yz = get_fe(lv[0][1]), xy = get_fe(lv[0][3]);
  const Fe t2 = mul9(get_fe(lv[0][2]));
  Fe z3 = fe_add<FQ>(yy, yy);
  z3 = fe_add<FQ>(z3, z3);
  z3 = fe_add<FQ>(z3, z3);
  const Fe y3 = fe_add<FQ>(yy, t2);
  const Fe t0 = fe_sub<FQ>(yy, fe_add<FQ>(fe_add<FQ>(t2, t2), t2));
  level(lv[1], 4, pick(h, t2, yz, t0, t0), pick(h, z3, z3, y3, xy));
  const Fe x3 = get_fe(lv[1][3]);
  return Proj{fe_add<FQ>(x3, x3), fe_add<FQ>(get_fe(lv[1][0]), get_fe(lv[1][2])), get_fe(lv[1][1])};
}

// RCB15 Algorithm 7 (a=0, b3=9), padd_rcb's values in two levels
__device__ Proj horner_add(const Proj& p, const Proj& q, Levels lv) {
  const int h = threadIdx.x % 6;
  const Fe zero = fe_zero();
  // X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
  level(lv[0], 6, fe_add<FQ>(pick(h, p.x, p.y, p.z, p.x, p.y, p.x), pick(h, zero, zero, zero, p.y, p.z, p.z)),
        fe_add<FQ>(pick(h, q.x, q.y, q.z, q.x, q.y, q.x), pick(h, zero, zero, zero, q.y, q.z, q.z)));
  Fe t0 = get_fe(lv[0][0]), t1 = get_fe(lv[0][1]), t2 = get_fe(lv[0][2]);
  const Fe t3 = fe_sub<FQ>(get_fe(lv[0][3]), fe_add<FQ>(t0, t1));
  const Fe t4 = fe_sub<FQ>(get_fe(lv[0][4]), fe_add<FQ>(t1, t2));
  Fe y3 = fe_sub<FQ>(get_fe(lv[0][5]), fe_add<FQ>(t0, t2));
  t0 = fe_add<FQ>(fe_add<FQ>(t0, t0), t0);
  t2 = mul9(t2);
  const Fe z3 = fe_add<FQ>(t1, t2);
  t1 = fe_sub<FQ>(t1, t2);
  y3 = mul9(y3);
  level(lv[1], 6, pick(h, t3, t4, t1, y3, z3, t0), pick(h, t1, y3, z3, t0, t4, t3));
  return Proj{fe_sub<FQ>(get_fe(lv[1][0]), get_fe(lv[1][1])), fe_add<FQ>(get_fe(lv[1][2]), get_fe(lv[1][3])),
              fe_add<FQ>(get_fe(lv[1][4]), get_fe(lv[1][5]))};
}

// RCB15 Algorithm 8 (a=0, Z2=1, b3=9), pmadd_rcb's values in two levels, for
// a finite Q = (qx, qy) (qxy = qx + qy): X1 X2, Y1 Y2, (X1+Y1)(X2+Y2), Y2 Z1,
// X2 Z1, then the six closing products
__device__ Proj horner_madd(const Proj& p, const Fe& qx, const Fe& qy, const Fe& qxy, Levels lv) {
  const int h = threadIdx.x % 6;
  const Fe pxy = fe_add<FQ>(p.x, p.y);
  level(lv[0], 5, pick(h, p.x, p.y, pxy, p.z, p.z), pick(h, qx, qy, qxy, qy, qx));
  const Fe t0 = get_fe(lv[0][0]), t1 = get_fe(lv[0][1]);
  const Fe t3 = fe_sub<FQ>(get_fe(lv[0][2]), fe_add<FQ>(t0, t1));
  const Fe t4 = fe_add<FQ>(get_fe(lv[0][3]), p.y);
  const Fe y3 = mul9(fe_add<FQ>(get_fe(lv[0][4]), p.x));
  const Fe t03 = fe_add<FQ>(fe_add<FQ>(t0, t0), t0);
  const Fe t2 = mul9(p.z);
  const Fe z3 = fe_add<FQ>(t1, t2);
  const Fe t1m = fe_sub<FQ>(t1, t2);
  level(lv[1], 6, pick(h, t3, t4, t1m, y3, z3, t03), pick(h, t1m, y3, z3, t03, t4, t3));
  return Proj{fe_sub<FQ>(get_fe(lv[1][0]), get_fe(lv[1][1])), fe_add<FQ>(get_fe(lv[1][2]), get_fe(lv[1][3])),
              fe_add<FQ>(get_fe(lv[1][4]), get_fe(lv[1][5]))};
}

__device__ __forceinline__ Proj window_sum(const uint32_t* win, int w) {
  return Proj{get_fe(win + 24 * w), get_fe(win + 24 * w + 8), get_fe(win + 24 * w + 16)};
}

__device__ __forceinline__ void put_proj(uint32_t* s, const Proj& p) {
  put_fe(s, p.x);
  put_fe(s + 8, p.y);
  put_fe(s + 16, p.z);
}

// the walk of horner_kernel and jac_horner_kernel over the W window sums in
// `win` (window_sum's layout): from window W-1 down, c doublings and the add
// of the next window sum a window
__device__ __forceinline__ Proj horner_walk(const uint32_t* win, int W, int c, Levels lv) {
  Proj acc = window_sum(win, W - 1);
  for (int w = W - 2; w >= 0; w--) {
    for (int d = 0; d < c; d++) acc = horner_dbl(acc, lv);
    acc = horner_add(acc, window_sum(win, w), lv);
  }
  return acc;
}

__global__ void __launch_bounds__(HORNER_THREADS)
    horner_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                  int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int W, int c) {
  extern __shared__ __align__(16) uint32_t win[];  // word j of coordinate k of window w at win[24 w + 8 k + j]
  __shared__ __align__(16) HornerLevels lv;
  for (int i = threadIdx.x; i < 24 * W; i += HORNER_THREADS) {
    const int w = i / 24, k = i / 8 % 3, j = i % 8;
    const int32_t* src = (k == 0 ? x : k == 1 ? y : z) + 16 * w + 2 * j;
    win[i] = (uint32_t)src[0] | ((uint32_t)src[1] << 16);
  }
  __syncwarp();
  const Proj acc = horner_walk(win, W, c, lv);
  if (threadIdx.x == 0) {
    store_limbs(ox, acc.x);
    store_limbs(oy, acc.y);
    store_limbs(oz, acc.z);
  }
}

// -- the G1 RCB ops, one lane per thread -------------------------------------

// 16-byte rows (the wrapper aligns them); the sentinel lanes store P
__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)
    pmadd_rcb_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                     const int32_t* __restrict__ z, const int32_t* __restrict__ ax,
                     const int32_t* __restrict__ ay, int32_t* __restrict__ ox,
                     int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj p{load_limbs16(x + i * 16), load_limbs16(y + i * 16), load_limbs16(z + i * 16)};
  const Fe qy = load_limbs16(ay + i * 16);
  if (!fe_is_zero(qy)) p = pmadd_rcb(p, load_limbs16(ax + i * 16), qy);
  store_limbs16(ox + i * 16, p.x);
  store_limbs16(oy + i * 16, p.y);
  store_limbs16(oz + i * 16, p.z);
}

// 16-byte rows (the wrapper aligns them)
__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)
    padd_rcb_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                    const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                    const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Proj p{load_limbs16(x1 + i * 16), load_limbs16(y1 + i * 16), load_limbs16(z1 + i * 16)};
  const Proj q{load_limbs16(x2 + i * 16), load_limbs16(y2 + i * 16), load_limbs16(z2 + i * 16)};
  const Proj r = padd_rcb(p, q);
  store_limbs16(ox + i * 16, r.x);
  store_limbs16(oy + i * 16, r.y);
  store_limbs16(oz + i * 16, r.z);
}

__global__ void __launch_bounds__(THREADS)
    pdbl_rcb_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                    const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                    int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_proj(ox, oy, oz, i, pdbl_rcb(load_proj(x, y, z, i)));
}

// -- MSM level 1 on projective accumulators: one thread per slab column ------

// A column's rows in order into the identity (0:1:0), a sentinel row
// keeping the sum: the first loop finds the first point Q, whose sum with
// the identity is (ax ay : ay^2 : ay) (what RCB15 gives there) in 2
// products; the second adds every later one by pmadd_rcb's 11. Two loops,
// not one with a flag: with the flag's select ptxas spilled 32-40 bytes
// under the 128-register cap (sm_90a, nvcc 12.9, row products)
template <bool TR>
__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)
    l1_rcb_mega_kernel(const int32_t* __restrict__ v, int32_t* __restrict__ ox,
                       int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long ncols, int L) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;
  Proj acc{fe_zero(), fe_one<FQ>(), fe_zero()};
  int r = 0;
  for (; r < L; r++) {
    const Aff q = load_elem<TR>(v, c, r, L, ncols);
    if (fe_is_zero(q.y)) continue;
    acc = Proj{fe_mul<FQ>(q.x, q.y), fe_sqr<FQ>(q.y), q.y};
    break;
  }
#pragma unroll 1
  for (r++; r < L; r++) {
    const Aff q = load_elem<TR>(v, c, r, L, ncols);
    if (!fe_is_zero(q.y)) acc = pmadd_rcb(acc, q.x, q.y);
  }
  store_limbs16(ox + c * 16, acc.x);
  store_limbs16(oy + c * 16, acc.y);
  store_limbs16(oz + c * 16, acc.z);
}

// -- the Jacobian ops with escapes (pallas_curve.py::_dbl_tiles, _madd_tiles, _add_tiles) --

// 4 a, no reduction: the caller keeps it below 2^256
__device__ __forceinline__ Fe lazy_x4(const Fe& a) {
  const Fe a2 = lazy_add(a, a);
  return lazy_add(a2, a2);
}

// dbl-2009-l (a=0), pallas_curve.py::_dbl_tiles, on the lazy sums and column
// products of the mixed add: d = 2((x + b)^2 - a - c) as the same value 4 x
// b, e = 3 x^2 as x (3 x) (a and c are not formed), and y3 = e (d - x3) - 8 c
// as one sum of two products, -8 c = (2 b) 4 (p - b): 7 wide products (2
// squares) and 6 reductions, where _dbl_tiles takes 7 products (5 squares)
// and 7 reductions. Every output is canonical, so each limb is _dbl_tiles'.
// The outputs may alias the inputs of the same coordinate.
__device__ __forceinline__ void jac_dbl(const Fe& x, const Fe& y, const Fe& z, Fe& x3, Fe& y3, Fe& z3) {
  const Fe b = col_mul(y, y);                                                    // < 1
  const Fe e = col_mul(x, lazy_add(lazy_add(x, x), x));                          // < 1
  const Fe d = col_mul(lazy_x4(x), b);                                           // < 1
  z3 = col_mul(lazy_add(y, y), z);                                               // < 1
  x3 = fe_sub<FQ>(col_mul(e, e), fe_add<FQ>(d, d));                              // < 1
  y3 = fe_dot(e, fe_sub<FQ>(d, x3), fe_add<FQ>(b, b), lazy_x4(lazy_neg(b)));  // 1*1 + 1*4 = 5 p^2
}

// madd-2007-bl's u2 - x1 and s2 - y1, canonical: 4 wide products (1 square),
// 4 reductions
__device__ __forceinline__ void madd_diffs(const Fe& x1, const Fe& y1, const Fe& z1, const Fe& qx, const Fe& qy,
                                           Fe& h, Fe& rr) {
  const Fe z1z1 = col_mul(z1, z1);        // < 1
  const Fe s = col_mul(qy, z1);           // < 1
  h = fe_sub<FQ>(col_mul(qx, z1z1), x1);  // < 1
  rr = fe_sub<FQ>(col_mul(s, z1z1), y1);  // < 1
}

// the doubling escape (Q = P): dbl-2009-l on P, reloaded from its rows, and
// its store. Out of line, so that the common lane's register budget holds
// none of it; a lane takes it only where Q = P (madd_kernel, add_kernel).
__device__ __noinline__ void madd_dbl_lane(const int32_t* x, const int32_t* y, const int32_t* z, int32_t* ox,
                                           int32_t* oy, int32_t* oz, long long i) {
  Fe x3, y3, z3;
  jac_dbl(load_limbs16(x + i * 16), load_limbs16(y + i * 16), load_limbs16(z + i * 16), x3, y3, z3);
  store_limbs16(ox + i * 16, x3);
  store_limbs16(oy + i * 16, y3);
  store_limbs16(oz + i * 16, z3);
}

// _madd_tiles' overrides, in its order, as branches: P = inf gives (ax,
// ay, 1), or (0, 0, 0) for the (0,0) sentinel Q, before any product (every
// lane of a fixed-base call's first window); Q = inf with P finite gives P;
// Q = P the doubling escape; an inverse pair the generic x3, y3 and z3 = 0.
// 16-byte rows (the wrapper aligns them).
__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)
    madd_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                const int32_t* __restrict__ ax, const int32_t* __restrict__ ay, int32_t* __restrict__ ox,
                int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe z1 = load_limbs16(z + i * 16);
  const Fe qx = load_limbs16(ax + i * 16), qy = load_limbs16(ay + i * 16);
  const bool q_inf = fe_is_zero(qx) && fe_is_zero(qy);
  if (fe_is_zero(z1)) {
    store_limbs16(ox + i * 16, qx);
    store_limbs16(oy + i * 16, qy);
    store_limbs16(oz + i * 16, q_inf ? fe_zero() : fe_one<FQ>());
    return;
  }
  const Fe x1 = load_limbs16(x + i * 16), y1 = load_limbs16(y + i * 16);
  Fe x3 = x1, y3 = y1, z3 = z1;
  if (!q_inf) {
    Fe h, rr;
    madd_diffs(x1, y1, z1, qx, qy, h, rr);
    const bool same_x = fe_is_zero(h);
    if (same_x && fe_is_zero(rr)) {
      madd_dbl_lane(x, y, z, ox, oy, oz, i);
      return;
    }
    madd_finish(x1, y1, z1, h, rr, x3, y3, z3);
    if (same_x) z3 = fe_zero();
  }
  store_limbs16(ox + i * 16, x3);
  store_limbs16(oy + i * 16, y3);
  store_limbs16(oz + i * 16, z3);
}

// 16-byte rows (the wrapper aligns them)
__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)
    dbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x3, y3, z3;
  jac_dbl(load_limbs16(x + i * 16), load_limbs16(y + i * 16), load_limbs16(z + i * 16), x3, y3, z3);
  store_limbs16(ox + i * 16, x3);
  store_limbs16(oy + i * 16, y3);
  store_limbs16(oz + i * 16, z3);
}

// add-2007-bl's u1 = x1 z2^2, s1 = y1 z2^3, h = u2 - u1, rr = s2 - s1 and
// z1 z2, canonical (the caller tests h and rr for zero): 9 wide products (2
// squares), 9 reductions. madd_finish then runs add-2007-bl's rest as
// madd-2007-bl's on u1, s1 and z1 z2 in place of x1, y1 and z1 (x3 = r2^2 - j
// - 2 v with v = u1 i4, y3 = r2 (v - x3) - 2 s1 j, z3 = ((z1 + z2)^2 - z1z1 -
// z2z2) h as the same value 2 z1 z2 h): 16 wide products (4 squares) and 15
// reductions in all, where _add_tiles takes 16 (5 squares) and 16.
__device__ __forceinline__ void add_diffs(const Fe& x1, const Fe& y1, const Fe& z1, const Fe& x2, const Fe& y2,
                                          const Fe& z2, Fe& u1, Fe& s1, Fe& z1z2, Fe& h, Fe& rr) {
  const Fe z2z2 = col_mul(z2, z2);                       // < 1
  u1 = col_mul(x1, z2z2);                                // < 1
  s1 = col_mul(col_mul(y1, z2), z2z2);                   // < 1
  const Fe z1z1 = col_mul(z1, z1);                       // < 1
  h = fe_sub<FQ>(col_mul(x2, z1z1), u1);                 // < 1
  rr = fe_sub<FQ>(col_mul(col_mul(y2, z1), z1z1), s1);   // < 1
  z1z2 = col_mul(z1, z2);                                // < 1
}

// _add_tiles' overrides, in its order, as branches taken before the
// arithmetic they make moot: P = inf gives Q's limbs (two infinities too),
// Q = inf gives P, Q = P the doubling escape (out of line, reloading P), an
// inverse pair the generic x3, y3 and z3 = 0. 16-byte rows (the wrapper
// aligns them).
__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)
    add_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
               const int32_t* __restrict__ x2, const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe z1 = load_limbs16(z + i * 16), qz = load_limbs16(z2 + i * 16);
  const bool p_inf = fe_is_zero(z1);
  if (p_inf || fe_is_zero(qz)) {  // one operand at infinity: the other one's limbs
    const int32_t* sx = p_inf ? x2 : x;
    const int32_t* sy = p_inf ? y2 : y;
    store_limbs16(ox + i * 16, load_limbs16(sx + i * 16));
    store_limbs16(oy + i * 16, load_limbs16(sy + i * 16));
    store_limbs16(oz + i * 16, p_inf ? qz : z1);
    return;
  }
  Fe u1, s1, z1z2, h, rr;
  add_diffs(load_limbs16(x + i * 16), load_limbs16(y + i * 16), z1, load_limbs16(x2 + i * 16),
            load_limbs16(y2 + i * 16), qz, u1, s1, z1z2, h, rr);
  const bool same_x = fe_is_zero(h);
  if (same_x && fe_is_zero(rr)) {
    madd_dbl_lane(x, y, z, ox, oy, oz, i);
    return;
  }
  Fe x3, y3, z3;
  madd_finish(u1, s1, z1z2, h, rr, x3, y3, z3);
  if (same_x) z3 = fe_zero();
  store_limbs16(ox + i * 16, x3);
  store_limbs16(oy + i * 16, y3);
  store_limbs16(oz + i * 16, z3);
}

// -- the compact msm's chains, one launch each --------------------------------
//
// jac_ladder, jac_sum and jac_horner run on horner_fold's one-warp RCB ops
// (horner_dbl, horner_add, and the mixed add horner_madd), a warp a lane: a
// point op is two levels of products, not one thread's product after
// product. The RCB formulas are complete, so a chain has no escape branch.
// The chains take and give the port's Jacobian rows: jac_sum and jac_horner
// load each operand as a projective point (load_jac_proj), and all three
// store the projective result in the Jacobian form (store_proj_jac). Their
// points are those of the JAX compact msm's loops of dbl, madd and add; their
// limbs are not.

// Jacobian row i, (X, Y, Z) -> the projective (X Z : Y : Z^3), a thread's own
// three products (no level); Z = 0 gives the identity (0:1:0) explicitly:
// add's inverse pairs leave Z = 0 under any X and Y, and a Y of 0 would give
// (0:0:0), which the complete formulas keep at zero
__device__ __forceinline__ Proj load_jac_proj(const int32_t* x, const int32_t* y, const int32_t* z, long long i) {
  const Fe zz = load_limbs16(z + i * 16);
  if (fe_is_zero(zz)) return Proj{fe_zero(), fe_one<FQ>(), fe_zero()};
  return Proj{fe_mul<FQ>(load_limbs16(x + i * 16), zz), load_limbs16(y + i * 16), fe_mul<FQ>(fe_sqr<FQ>(zz), zz)};
}

// the warp's projective acc -> Jacobian row i, (X Z, Y Z^2, Z) or (1, 1, 0)
// where Z = 0, in two levels (X Z and Z^2, then Y Z^2); lane 0 stores it
__device__ __forceinline__ void store_proj_jac(int32_t* ox, int32_t* oy, int32_t* oz, long long i, const Proj& acc,
                                               Levels lv) {
  const int h = threadIdx.x & 1;
  level(lv[0], 2, pick(h, acc.x, acc.z), acc.z);  // X Z, Z^2
  const Fe xz = get_fe(lv[0][0]);
  level(lv[1], 1, acc.y, get_fe(lv[0][1]));  // Y Z^2
  if (threadIdx.x == 0) {
    const bool inf = fe_is_zero(acc.z);
    store_limbs16(ox + i * 16, inf ? fe_one<FQ>() : xz);
    store_limbs16(oy + i * 16, inf ? fe_one<FQ>() : get_fe(lv[1][0]));
    store_limbs16(oz + i * 16, acc.z);
  }
}

// _msm_ladder's lanes (hekaton_tpu/msm/pippenger.py:209-229) on the RCB
// formulas, one warp a lane (a block of one warp each: the block scheduler
// spreads the <= 32 warps of a compact msm over as many SMs, each alone on
// its SM's issue slots): from the identity (0:1:0), bit j = nbits-1 down to
// 0 of the lane's (16,) plain 16-bit scalar limbs, horner_dbl, then where
// the bit is set horner_madd of (ax, ay). The scalar is the warp's own, so
// every branch is uniform. Doublings of the identity leave it as it is, so
// the walk starts at the top set bit; a (0,0) base or a zero scalar stores
// the identity.
__global__ void __launch_bounds__(HORNER_THREADS)
    jac_ladder_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ scalars, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, int nbits) {
  __shared__ __align__(16) HornerLevels lv;
  const long long i = blockIdx.x;
  const Fe qx = load_limbs16(ax + i * 16), qy = load_limbs16(ay + i * 16);
  int top = -1;  // the top set bit below nbits
  if (!(fe_is_zero(qx) && fe_is_zero(qy))) {
    for (int l = (nbits - 1) / 16; l >= 0 && top < 0; l--) {
      uint32_t v = (uint32_t)scalars[i * 16 + l];
      if (16 * l + 16 > nbits) v &= (1u << (nbits - 16 * l)) - 1u;
      if (v) top = 16 * l + 31 - __clz(v);
    }
  }
  Proj acc{fe_zero(), fe_one<FQ>(), fe_zero()};
  if (top >= 0) {
    const Fe qxy = fe_add<FQ>(qx, qy);
    uint32_t limb = (uint32_t)scalars[i * 16 + top / 16];
#pragma unroll 1
    for (int j = top; j >= 0; j--) {
      if (j % 16 == 15) limb = (uint32_t)scalars[i * 16 + j / 16];
      acc = horner_dbl(acc, lv);
      if ((limb >> (j % 16)) & 1) acc = horner_madd(acc, qx, qy, qxy, lv);
    }
  }
  store_proj_jac(ox, oy, oz, i, acc, lv);
}

// _tree_reduce's chunk sum (hekaton_tpu/msm/pippenger.py:159-185), a block
// of one warp a lane as jac_ladder: lane i of the (K, n, 16) stack from the
// identity (0:1:0), horner_add of operand j = 0 .. K-1 in that order. The
// operands come in chunks of 32 (3 KB of shared memory, whatever K): thread
// t loads operand 32k + t as a projective point, then the warp adds the
// chunk's points one after another. A thread writes the chunk again only
// after the two levels of its last add, which every thread reaches after it
// has read that add's operand.
__global__ void __launch_bounds__(HORNER_THREADS)
    jac_sum_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                   int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
                   int K) {
  __shared__ __align__(16) uint32_t chunk[HORNER_THREADS * 24];  // window_sum's layout
  __shared__ __align__(16) HornerLevels lv;
  const long long i = blockIdx.x;
  Proj acc{fe_zero(), fe_one<FQ>(), fe_zero()};
#pragma unroll 1
  for (int k = 0; k < K; k += HORNER_THREADS) {
    const int m = min(K - k, HORNER_THREADS);
    if ((int)threadIdx.x < m) put_proj(chunk + 24 * threadIdx.x, load_jac_proj(x, y, z, (k + threadIdx.x) * n + i));
    __syncwarp();
#pragma unroll 1
    for (int j = 0; j < m; j++) acc = horner_add(acc, window_sum(chunk, j), lv);
  }
  store_proj_jac(ox, oy, oz, i, acc, lv);
}

// the compact msm's Horner combine (hekaton_tpu/msm/pippenger.py:258-268) on
// horner_fold's warp: thread t loads window sums t, t + 32, ... of the (W, 16)
// Jacobian rows into shared memory as projective points, the warp walks them
// as horner_kernel does, and the result goes back to the Jacobian form
__global__ void __launch_bounds__(HORNER_THREADS)
    jac_horner_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                      int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int W, int c) {
  extern __shared__ __align__(16) uint32_t win[];  // window_sum's layout
  __shared__ __align__(16) HornerLevels lv;
  for (int w = threadIdx.x; w < W; w += HORNER_THREADS) put_proj(win + 24 * w, load_jac_proj(x, y, z, w));
  __syncwarp();
  store_proj_jac(ox, oy, oz, 0, horner_walk(win, W, c, lv), lv);
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// every kernel at its launch's block size (horner_kernel with W = 20 window
// sums), for the occupancy query
const KernelSlot KERNELS[] = {
    {"aff_root_kernel<0>", (const void*)aff_root_kernel<false>, THREADS, 0},
    {"aff_root_kernel<1>", (const void*)aff_root_kernel<true>, THREADS, 0},
    {"aff_fin_kernel<0>", (const void*)aff_fin_kernel<false>, THREADS, 0},
    {"aff_fin_kernel<1>", (const void*)aff_fin_kernel<true>, THREADS, 0},
    {"halves_root_kernel<0>", (const void*)halves_root_kernel<false>, THREADS, 0},
    {"halves_root_kernel<1>", (const void*)halves_root_kernel<true>, THREADS, 0},
    {"halves_step_kernel<0,0>", (const void*)halves_step_kernel<false, false>, THREADS, 0},
    {"halves_step_kernel<0,1>", (const void*)halves_step_kernel<false, true>, THREADS, 0},
    {"halves_step_kernel<1,0>", (const void*)halves_step_kernel<true, false>, THREADS, 0},
    {"halves_step_kernel<1,1>", (const void*)halves_step_kernel<true, true>, THREADS, 0},
    {"interleave_slab_t_kernel<1>", (const void*)interleave_slab_t_kernel<1>, COPY_THREADS, 0},
    {"interleave_slab_t_kernel<4>", (const void*)interleave_slab_t_kernel<4>, COPY_THREADS, 0},
    {"aff_prep_kernel", (const void*)aff_prep_kernel, THREADS, 0},
    {"aff_finish_kernel", (const void*)aff_finish_kernel, THREADS, 0},
    {"horner_kernel", (const void*)horner_kernel, HORNER_THREADS, 24 * 20 * sizeof(uint32_t)},
    {"pmadd_rcb_kernel", (const void*)pmadd_rcb_kernel, THREADS, 0},
    {"padd_rcb_kernel", (const void*)padd_rcb_kernel, THREADS, 0},
    {"pdbl_rcb_kernel", (const void*)pdbl_rcb_kernel, THREADS, 0},
    {"l1_rcb_mega_kernel<0>", (const void*)l1_rcb_mega_kernel<false>, THREADS, 0},
    {"l1_rcb_mega_kernel<1>", (const void*)l1_rcb_mega_kernel<true>, THREADS, 0},
    {"madd_kernel", (const void*)madd_kernel, THREADS, 0},
    {"dbl_kernel", (const void*)dbl_kernel, THREADS, 0},
    {"add_kernel", (const void*)add_kernel, THREADS, 0},
    {"jac_ladder_kernel", (const void*)jac_ladder_kernel, HORNER_THREADS, 0},
    {"jac_sum_kernel", (const void*)jac_sum_kernel, HORNER_THREADS, 0},
    {"jac_horner_kernel", (const void*)jac_horner_kernel, HORNER_THREADS, 24 * 20 * sizeof(uint32_t)},
};

}  // namespace

// kernel i's name and resident blocks an SM (field.cuh::occupancy_of)
extern "C" int hk_curve_occupancy(int i, const char** name, int* blocks) {
  return occupancy_of(KERNELS, i, name, blocks);
}

// the pairs' 16-byte loads and stores need 16-byte aligned rows
extern "C" int hk_aff_root(const void* x1, const void* y1, const void* px, const void* py, void* pre,
                           void* ex, void* roots, long long n, long long nthreads, int k, void* stream) {
  aff_root_kernel<false><<<blocks_for(nthreads), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)px, (const int32_t*)py, (int32_t*)pre,
      (int32_t*)ex, (int32_t*)roots, n, nthreads, k);
  return (int)cudaGetLastError();
}

extern "C" int hk_aff_fin(const void* x1, const void* y1, const void* px, const void* py, const void* pre,
                          const void* ex, const void* rinv, void* ox, void* oy, long long n, long long nthreads,
                          int k, void* stream) {
  aff_fin_kernel<false><<<blocks_for(nthreads), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)px, (const int32_t*)py, (const int32_t*)pre,
      (const int32_t*)ex, (const int32_t*)rinv, (int32_t*)ox, (int32_t*)oy, n, nthreads, k);
  return (int)cudaGetLastError();
}

// the complete add with a packed (n, 16) slab row as second operand
extern "C" int hk_aff_root_packed(const void* x1, const void* y1, const void* rows, void* pre, void* ex,
                                  void* roots, long long n, long long nthreads, int k, void* stream) {
  aff_root_kernel<true><<<blocks_for(nthreads), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)rows, nullptr, (int32_t*)pre, (int32_t*)ex,
      (int32_t*)roots, n, nthreads, k);
  return (int)cudaGetLastError();
}

extern "C" int hk_aff_fin_packed(const void* x1, const void* y1, const void* rows, const void* pre,
                                 const void* ex, const void* rinv, void* ox, void* oy, long long n,
                                 long long nthreads, int k, void* stream) {
  aff_fin_kernel<true><<<blocks_for(nthreads), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)rows, nullptr, (const int32_t*)pre,
      (const int32_t*)ex, (const int32_t*)rinv, (int32_t*)ox, (int32_t*)oy, n, nthreads, k);
  return (int)cudaGetLastError();
}

// round 1's chains on a (ncols, 2k*16) slab, or (transposed) a (2k*16, ncols)
// one, 16-byte aligned
extern "C" int hk_halves_root(const void* v, void* pre, void* ex, void* roots, long long ncols, int k,
                              int transposed, void* stream) {
  auto kern = transposed ? halves_root_kernel<true> : halves_root_kernel<false>;
  kern<<<blocks_for(ncols), THREADS, 0, (cudaStream_t)stream>>>((const int32_t*)v, (int32_t*)pre, (int32_t*)ex,
                                                                (int32_t*)roots, ncols, k);
  return (int)cudaGetLastError();
}

// the finish of a round of k pairs a column (and with k > 1 the next
// round's chains): `in` in either layout, `out` the transposed (k*16, ncols)
// slab, or with k = 1 the (ncols, 16) or (16, ncols) sums
extern "C" int hk_halves_step(const void* in, const void* pre, const void* ex, const void* rinv, void* out,
                              void* pre2, void* ex2, void* roots2, long long ncols, int k, int in_transposed,
                              int out_transposed, int flip, void* stream) {
  auto kern = in_transposed ? (out_transposed ? halves_step_kernel<true, true> : halves_step_kernel<true, false>)
                            : (out_transposed ? halves_step_kernel<false, true> : halves_step_kernel<false, false>);
  kern<<<blocks_for(ncols), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (const int32_t*)pre, (const int32_t*)ex, (const int32_t*)rinv, (int32_t*)out,
      (int32_t*)pre2, (int32_t*)ex2, (int32_t*)roots2, ncols, k, flip != 0);
  return (int)cudaGetLastError();
}

// (16, W, L, mcols) word planes -> the (L*16, W*mcols) transposed slab
extern "C" int hk_interleave_slab_t(const void* planes, void* out, int W, int L, int mcols,
                                    void* stream) {
  // int4 loads and stores need every row start 16-byte aligned: mcols % 4
  // == 0 and both base pointers aligned (a view may start at any word)
  bool aligned = ((reinterpret_cast<uintptr_t>(planes) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int v = mcols % 4 == 0 && aligned ? 4 : 1;
  dim3 grid((mcols / v + COPY_THREADS - 1) / COPY_THREADS, W, 16 * L);
  auto kern = v == 4 ? interleave_slab_t_kernel<4> : interleave_slab_t_kernel<1>;
  kern<<<grid, COPY_THREADS, 0, (cudaStream_t)stream>>>((const int32_t*)planes, (int32_t*)out, W, L,
                                                          mcols);
  return (int)cudaGetLastError();
}

// n lanes of (16,) limb rows per coordinate, 16-byte aligned; outputs must
// not alias inputs
extern "C" int hk_aff_prep(const void* x1, const void* y1, const void* px, const void* py,
                           void* den, void* num, long long n, void* stream) {
  aff_prep_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)px, (const int32_t*)py,
      (int32_t*)den, (int32_t*)num, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_aff_finish(const void* x1, const void* y1, const void* px, const void* py,
                             const void* inv, const void* num, void* ox, void* oy, long long n,
                             void* stream) {
  aff_finish_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)px, (const int32_t*)py,
      (const int32_t*)inv, (const int32_t*)num, (int32_t*)ox, (int32_t*)oy, n);
  return (int)cudaGetLastError();
}

// the most window sums hk_horner takes
extern "C" int hk_horner_max_w() { return HORNER_MAX_W; }

// (W, 16) limb rows per coordinate, 1 <= W <= HORNER_MAX_W, c >= 0
extern "C" int hk_horner(const void* x, const void* y, const void* z, void* ox, void* oy,
                         void* oz, int W, int c, void* stream) {
  if (W < 1 || W > HORNER_MAX_W || c < 0) return (int)cudaErrorInvalidValue;
  horner_kernel<<<1, HORNER_THREADS, 24 * W * sizeof(uint32_t), (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, W, c);
  return (int)cudaGetLastError();
}

// n lanes of (16,) limb rows per coordinate; outputs must not alias inputs
extern "C" int hk_madd(const void* x, const void* y, const void* z, const void* ax, const void* ay,
                       void* ox, void* oy, void* oz, long long n, void* stream) {
  madd_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)ax,
      (const int32_t*)ay, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_dbl(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                      long long n, void* stream) {
  dbl_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_add(const void* x1, const void* y1, const void* z1, const void* x2,
                      const void* y2, const void* z2, void* ox, void* oy, void* oz, long long n,
                      void* stream) {
  add_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

// n >= 1 lanes of affine (16,) limb rows and (16,) plain 16-bit scalar limbs,
// 16-byte aligned, 1 <= nbits <= 256 -> n Jacobian rows
extern "C" int hk_jac_ladder(const void* ax, const void* ay, const void* scalars, void* ox, void* oy, void* oz,
                             long long n, int nbits, void* stream) {
  if (nbits < 1 || nbits > 256 || n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  jac_ladder_kernel<<<(unsigned)n, HORNER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ax, (const int32_t*)ay, (const int32_t*)scalars, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
      nbits);
  return (int)cudaGetLastError();
}

// a (K, n, 16) stack of Jacobian limb rows per coordinate, 16-byte aligned,
// K >= 0, n >= 1 -> the n lanes' in-order sums
extern "C" int hk_jac_sum(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz, long long n,
                          int K, void* stream) {
  if (K < 0 || n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  jac_sum_kernel<<<(unsigned)n, HORNER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, K);
  return (int)cudaGetLastError();
}

// (W, 16) Jacobian window sums per coordinate, 16-byte aligned, 1 <= W <=
// HORNER_MAX_W, c >= 0 -> one Jacobian row
extern "C" int hk_jac_horner(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz, int W,
                             int c, void* stream) {
  if (W < 1 || W > HORNER_MAX_W || c < 0) return (int)cudaErrorInvalidValue;
  jac_horner_kernel<<<1, HORNER_THREADS, 24 * W * sizeof(uint32_t), (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, W, c);
  return (int)cudaGetLastError();
}

// n lanes of (16,) limb rows per coordinate; outputs must not alias inputs
extern "C" int hk_pmadd_rcb(const void* x, const void* y, const void* z, const void* ax,
                            const void* ay, void* ox, void* oy, void* oz, long long n,
                            void* stream) {
  pmadd_rcb_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)ax,
      (const int32_t*)ay, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_padd_rcb(const void* x1, const void* y1, const void* z1, const void* x2,
                           const void* y2, const void* z2, void* ox, void* oy, void* oz,
                           long long n, void* stream) {
  padd_rcb_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1, (const int32_t*)x2,
      (const int32_t*)y2, (const int32_t*)z2, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" int hk_pdbl_rcb(const void* x, const void* y, const void* z, void* ox, void* oy,
                           void* oz, long long n, void* stream) {
  pdbl_rcb_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, n);
  return (int)cudaGetLastError();
}

// (ncols, L*16) packed slab, or (transposed) an (L*16, ncols) one -> the
// three (ncols, 16) limb rows of each column's projective sum
extern "C" int hk_l1_rcb_mega(const void* v, void* ox, void* oy, void* oz, long long ncols, int L,
                              int transposed, void* stream) {
  auto kern = transposed ? l1_rcb_mega_kernel<true> : l1_rcb_mega_kernel<false>;
  kern<<<blocks_for(ncols), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)v, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, ncols, L);
  return (int)cudaGetLastError();
}

// The sharded K2's pack tail (csrc/blocked.cu colk_costs_fused<true, true>)
// against the two forms it was chosen over, as one C entry point for
// tools/k2_pack_probe.py, which builds this file into a shared library,
// holds every form's outputs to the two-node chain they replace, and times
// them:
//
//   mode 0  K2 with the step after K2 as its tail, no pack
//           (colk_costs_fused<true>: the chain's first node; the
//           boundary's sharded_pack kernel follows it);
//   mode 1  carried: colk_pack_variant<true> below, K2 with the tail and
//           the pack, the weights at the candidates carried through the
//           block argmaxes, the partials (8 more bytes a block) and the
//           last block's fold, block 0 leaving w[0]'s new value for the
//           case with no candidate (h_d 0), so that no weight is loaded
//           after the fold;
//   mode 2  early: colk_pack_variant<false>, the two weights loaded once
//           the fold is done and before the last block's stores, w[h]'s
//           new value taken from the workspace;
//   mode 3  shipped: colk_costs_fused<true, true>, the two weights loaded
//           in the pack, after the last block's store of w[h] (what the
//           port launches).
//
// colk_pack_variant is csrc/blocked.cu's colk_costs_fused with the tail
// and the pack always on, and the carried and early forms in place of the
// shipped loads.
//
// Build (tools/k2_pack_probe.py does it):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -Xcompiler -fPIC -shared -o k2pv.so tools/k2_pack_variants.cu

#include "../simplex_tpu_torch/kernels/csrc/blocked.cu"

template <bool CARRY>
__device__ void block_argmax_carry(double &key, int &idx, double &val,
                                   float &wgt) {
    __shared__ double sk[THREADS / 32];
    __shared__ int si[THREADS / 32];
    __shared__ double sv[THREADS / 32];
    __shared__ float sw[CARRY ? THREADS / 32 : 1];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    auto fold = [&]() {
        for (int off = 16; off > 0; off >>= 1) {
            const double k2 = __shfl_down_sync(0xffffffffu, key, off);
            const int i2 = __shfl_down_sync(0xffffffffu, idx, off);
            const double v2 = __shfl_down_sync(0xffffffffu, val, off);
            const float w2 =
                CARRY ? __shfl_down_sync(0xffffffffu, wgt, off) : 0.0f;
            if (better(k2, i2, key, idx)) {
                key = k2;
                idx = i2;
                val = v2;
                if (CARRY) wgt = w2;
            }
        }
    };
    fold();
    if (lane == 0) {
        sk[warp] = key;
        si[warp] = idx;
        sv[warp] = val;
        if (CARRY) sw[warp] = wgt;
    }
    __syncthreads();
    if (warp == 0) {
        const bool has = lane < THREADS / 32;
        key = has ? sk[lane] : -CUDART_INF;
        idx = has ? si[lane] : BIG_INDEX;
        val = has ? sv[lane] : 0.0;
        if (CARRY) wgt = has ? sw[lane] : 0.0f;
        fold();
    }
    __syncthreads();
}

// The carried form's workspace: colk_ws_bytes's, with w[0]'s new value at
// [8, 12) and f32 wd, wb[nb] (the weights at each block's candidates) after
// the partials: 16 + 40 bytes a block.
constexpr size_t carry_ws_bytes(int nb) {
    return 16 + (size_t)nb * (3 * sizeof(double) + 2 * sizeof(int) +
                              2 * sizeof(float));
}

struct CarryWs {
    unsigned *counter;
    float *w_h, *w0;
    double *key, *val, *bval;
    int *idx, *bidx;
    float *wd, *wb;
    __device__ CarryWs(unsigned char *ws, int nb)
        : counter(reinterpret_cast<unsigned *>(ws)),
          w_h(reinterpret_cast<float *>(ws + 4)),
          w0(reinterpret_cast<float *>(ws + 8)),
          key(reinterpret_cast<double *>(ws + 16)), val(key + nb),
          bval(val + nb), idx(reinterpret_cast<int *>(bval + nb)),
          bidx(idx + nb), wd(reinterpret_cast<float *>(bidx + nb)),
          wb(wd + nb) {}
};


template <bool CARRY>
__global__ void __launch_bounds__(THREADS) colk_pack_variant(
        const float *__restrict__ Tt, float *__restrict__ C,
        float *__restrict__ F, double *__restrict__ costs,
        const int *__restrict__ k_ptr, int t,
        const double *__restrict__ u_ptr,
        const unsigned char *__restrict__ do_ptr, int r, double eps, int M,
        int R, int n_rblocks, const float *__restrict__ ah,
        double *__restrict__ b, int *__restrict__ base,
        const int *h_ptr, const float *__restrict__ p_ptr,
        const double *__restrict__ bk_ptr, float *__restrict__ w,
        int offset, const float *__restrict__ wh_ptr,
        unsigned char *__restrict__ ws_bytes, int *__restrict__ hd_out,
        double *__restrict__ vd_out, int *__restrict__ hb_out,
        double *__restrict__ vb_out, double *__restrict__ send_v,
        int *__restrict__ send_i, Step s, step::Policy pol) {
    const int k = min(*k_ptr, M - 1);            // k = BIG when unbounded
    const bool apply = *do_ptr != 0;
    const int tid = threadIdx.x;
    if ((int)blockIdx.x >= n_rblocks) {
        // M axis: b and the eta row (whole blocks return together); base[k]
        // is the last block's, since the R blocks read it.
        const int j = (blockIdx.x - n_rblocks) * THREADS + tid;
        if (j >= M) return;
        float *v = F + (size_t)t * M;
        if (!apply) {
            v[j] = 0.0f;
            return;
        }
        const float p = *p_ptr;
        const double bk = *bk_ptr;
        if (j == k) {
            b[j] = __ddiv_rn(bk, (double)p);
            v[j] = __fsub_rn(1.0f, __fdiv_rn(1.0f, p));
        } else {
            const float a = ah[j];
            b[j] = __dsub_rn(b[j],
                             __dmul_rn(bk, __ddiv_rn((double)a, (double)p)));
            v[j] = __fdiv_rn(a, p);
        }
        return;
    }

    __shared__ __align__(16) float cs[COLK_ROWS][COLK_COLS];
    __shared__ __align__(16) float trow[COLK_COLS];
    __shared__ float fk[COLK_ROWS];
    __shared__ bool last;
    const CarryWs ws(ws_bytes, n_rblocks);
    const int j0 = blockIdx.x * COLK_COLS;
    const int j = j0 + tid;                      // this thread's column
    const bool owner = tid < COLK_COLS;          // R is a multiple of 128
    const int hc = min(*h_ptr, R - 1);
    const int hl = *h_ptr - offset;              // h's local column
    const bool own_h = hl >= 0 && hl < R;

    // The first pass's loads, all issued before any is waited for.
    colk_stage(C, F, 0, t, k, M, R, j0, cs, fk);
    if (tid < COLK_COLS / 4)
        cp_async16(&trow[tid * 4], Tt + (size_t)k * R + j0 + tid * 4);
    cp_async_commit();
    double c = 0.0;
    float wj = 0.0f;
    if (owner) {
        c = costs[j];
        if (w != nullptr) wj = w[j];
    }
    const int lvar = base[k] - offset;           // read before any write
    const float wh = w == nullptr ? 0.0f
                     : wh_ptr != nullptr ? *wh_ptr : w[hc];

    // colk[j] = Tt[k, j] - sum_{s<t} F[s, k] C[s, j], the FFMA chain in s
    // order across the passes.
    float acc = 0.0f;
    for (int s0 = 0;;) {
        cp_async_wait<0>();
        __syncthreads();
        const int rows = min(COLK_ROWS, t - s0);
        if (owner) {
#pragma unroll 8
            for (int s = 0; s < rows; ++s)
                acc = fmaf(fk[s], cs[s][tid], acc);
        }
        s0 += COLK_ROWS;
        if (s0 >= t) break;
        __syncthreads();                         // the pass is read
        colk_stage(C, F, s0, t, k, M, R, j0, cs, fk);
        cp_async_commit();
    }

    double key = -CUDART_INF, val = CUDART_INF, bval = CUDART_INF;
    int idx = BIG_INDEX, bidx = BIG_INDEX;
    if (owner) {
        const float colk = __fsub_rn(trow[tid], acc);
        C[(size_t)t * R + j] = apply ? colk : 0.0f;
        if (apply) {
            c = __dsub_rn(c, __dmul_rn(*u_ptr, (double)colk));
            costs[j] = c;
        }
        const bool live = j < r;
        const bool elig = live && c <= -eps;
        if (w != nullptr) {
            if (apply) {
                const float p = *p_ptr;
                const float alpha = __fdiv_rn(colk, p);
                float w2 = max_nan(wj, __fmul_rn(__fmul_rn(alpha, alpha), wh));
                if (j == lvar)
                    w2 = max_nan(__fdiv_rn(wh, __fmul_rn(p, p)), 1.0f);
                w2 = min_nan(w2, 1e12f);
                if (w2 != w2) w2 = 1.0f;
                if (j == hl) {
                    *ws.w_h = w2;            // the last block stores it
                    __threadfence();
                } else {
                    w[j] = w2;
                }
                wj = w2;
            }
            if (elig) {
                key = __ddiv_rn(__dmul_rn(c, c), (double)wj);
                idx = j;
                val = c;
            }
        } else if (live) {
            key = -c;                            // argmin of c == argmax -c
            idx = j;
            val = c;
        }
        if (elig) {
            bidx = j;
            bval = c;
        }
    }
    // The weights at the candidates ride with them (CARRY): the column's
    // own, wherever the column is this thread's candidate.
    float wd = wj, wb = wj;
    block_argmax_carry<CARRY>(key, idx, val, wd);
    double bkey = bidx == BIG_INDEX ? -CUDART_INF : 0.0;
    block_argmax_carry<CARRY>(bkey, bidx, bval, wb);  // lowest eligible
    // Publish the partial (thread 0) and w[h]'s new value (its owner, who
    // fenced before the fold's barriers), then arrive.
    if (tid == 0) {
        ws.key[blockIdx.x] = key;
        ws.idx[blockIdx.x] = idx;
        ws.val[blockIdx.x] = val;
        ws.bidx[blockIdx.x] = bidx;
        ws.bval[blockIdx.x] = bval;
        if (CARRY) {
            ws.wd[blockIdx.x] = wd;
            ws.wb[blockIdx.x] = wb;
            if (blockIdx.x == 0) *ws.w0 = wj;    // thread 0's column is 0
        }
        __threadfence();
        last = atomicAdd(ws.counter, 1u) == (unsigned)n_rblocks - 1;
    }
    __syncthreads();
    if (!last) return;

    // The last block: every R block has read h, base[k] and w[h] and
    // written its partial. Fold the partials (read past L1) in the same
    // order.
    __threadfence();
    // The tail's other operands, loaded while the partials fold: no block
    // of K2 writes them.
    step::PostIn post{};
    if (tid == 0) post = step::post_load(s);
    const float w0 = CARRY && tid == 0 ? __ldcg(ws.w0) : 0.0f;
    key = -CUDART_INF;
    val = bval = CUDART_INF;
    idx = bidx = BIG_INDEX;
    wd = wb = 0.0f;
    for (int i = tid; i < n_rblocks; i += THREADS) {
        const double ki = __ldcg(ws.key + i), vi = __ldcg(ws.val + i);
        const double bvi = __ldcg(ws.bval + i);
        const int ii = __ldcg(ws.idx + i), bi = __ldcg(ws.bidx + i);
        const float wdi = CARRY ? __ldcg(ws.wd + i) : 0.0f;
        const float wbi = CARRY ? __ldcg(ws.wb + i) : 0.0f;
        if (better(ki, ii, key, idx)) {
            key = ki;
            idx = ii;
            val = vi;
            wd = wdi;
        }
        if (bi < bidx) {
            bidx = bi;
            bval = bvi;
            wb = wbi;
        }
    }
    block_argmax_carry<CARRY>(key, idx, val, wd);
    bkey = bidx == BIG_INDEX ? -CUDART_INF : 0.0;
    block_argmax_carry<CARRY>(bkey, bidx, bval, wb);
    if (tid == 0) {
        const bool none = key == -CUDART_INF;    // no candidate at all
        const step::Candidates c{none ? 0 : idx, none ? CUDART_INF : val,
                                 bidx,
                                 bidx == BIG_INDEX ? CUDART_INF : bval};
        if (!CARRY && w != nullptr) {
            // The weights at the candidates, both loads out before this
            // thread's stores: w[h]'s new value is still the workspace's.
            const float w_new = __ldcg(ws.w_h);
            const int jd = min(c.h_d, R - 1), jb = min(c.h_b, R - 1);
            const bool at_h = apply && own_h;
            wd = at_h && jd == hl ? w_new : __ldcg(w + jd);
            wb = at_h && jb == hl ? w_new : __ldcg(w + jb);
        }
        *hd_out = c.h_d;
        *vd_out = c.v_d;
        *hb_out = c.h_b;
        *vb_out = c.v_b;
        if (apply) {
            base[k] = *h_ptr;
            if (w != nullptr && own_h) w[hl] = __ldcg(ws.w_h);
        }
        *ws.counter = 0;                         // ready for the next call
        // The step after K2 on the do flag and the candidates in registers;
        // its step before K1 rewrites h, read above for the last time.
        step::post(s, post, apply, c, pol);
        {
            // The slice's candidates into the send buffers, from registers.
            send_v[0] = c.v_d;
            send_v[1] = c.v_b;
            if (w != nullptr) {
                const bool has = c.h_b < BIG_INDEX;
                if (CARRY && none) wd = w0;      // h_d is 0
                const double wdd = (double)wd;
                send_v[2] = wdd;
                send_v[3] = has ? (double)wb : 1.0;
                send_v[4] = has ? __ddiv_rn(__dmul_rn(c.v_d, c.v_d), wdd)
                                : -CUDART_INF;
            }
            send_i[0] = c.h_d >= BIG_INDEX ? BIG_INDEX : offset + c.h_d;
            send_i[1] = c.h_b >= BIG_INDEX ? BIG_INDEX : offset + c.h_b;
        }
    }
}

extern "C" int k2_pack_variant_launch(
        const float *Tt, float *C, float *F, double *costs, const int *k,
        int t, const double *u, const unsigned char *do_flag, int r,
        double eps, int M, int R, const float *ah, double *b, int *base,
        const int *h, const float *p, const double *bk, float *w, int offset,
        const float *wh, unsigned char *ws, long long ws_bytes, int *hd_out,
        double *vd_out, int *hb_out, double *vb_out, double *send_v,
        int *send_i, const Step *step, long long max_iter, int mode,
        void *stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rblocks = (R + COLK_COLS - 1) / COLK_COLS;
    if (ws_bytes < (long long)carry_ws_bytes(n_rblocks))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(n_rblocks + (M + THREADS - 1) / THREADS);
    const step::Policy pol{max_iter, eps, step::BLAND_THRESHOLD, 50, 0};
#define K2_ARGS                                                             \
    Tt, C, F, costs, k, t, u, do_flag, r, eps, M, R, n_rblocks, ah, b, base, \
        h, p, bk, w, offset, wh, ws, hd_out, vd_out, hb_out, vb_out, send_v, \
        send_i, *step, pol
    if (mode == 0)
        colk_costs_fused<true><<<grid, THREADS, 0, st>>>(K2_ARGS);
    else if (mode == 1)
        colk_pack_variant<true><<<grid, THREADS, 0, st>>>(K2_ARGS);
    else if (mode == 2)
        colk_pack_variant<false><<<grid, THREADS, 0, st>>>(K2_ARGS);
    else if (mode == 3)
        colk_costs_fused<true, true><<<grid, THREADS, 0, st>>>(K2_ARGS);
    else
        return (int)cudaErrorInvalidValue;
#undef K2_ARGS
    return (int)cudaGetLastError();
}

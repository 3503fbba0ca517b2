"""The paper's 6 task-parallel benchmarks (§V-B, Fig. 6) on the PyTorch port.

Each benchmark issues plain sequential host code through the declared
GrFunctions in ``kernels.py`` — no streams, no events, no per-call access
annotations — exactly the programming model of Fig. 4.  The runtime infers
the DAG; the per-call cost model (sim mode) rides along via
``with_options``.

Benchmarks run in two modes:
* **real** (``gpu=None``): kernels execute as torch ops on the scheduler's
  device — CUDA-stream lanes on a card, threads on the CPU; used by
  correctness tests (parallel scheduling must equal sequential semantics)
  and by the serial-vs-parallel measurement on the card;
* **simulated** (``gpu=GPUSpec``): per-kernel solo costs/occupancies from the
  analytic roofline in `costmodel.py` drive the discrete-event executor to
  produce Fig. 7/8/9/11-style numbers for the paper's three testbed GPUs.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core import GrScheduler
from ..core.frontend import GrFunction
from . import kernels as K
from .costmodel import GPUSpec, kernel_cost, occupancy


def _dev(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; the default ``"cuda"`` raises without a
    card (no fallback to the host)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_reference: device='cuda' but no CUDA device "
                           "is available; pass device='cpu'")
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class Benchmark:
    name: str = "base"
    fp64: bool = False

    # -- helpers --------------------------------------------------------
    def _launch(self, sched: GrScheduler, gf: GrFunction, arrays, name: str,
                *, flops: float, bytes_moved: float, gpu: Optional[GPUSpec],
                fp64: bool = False, parallelism: float = 1.0):
        """Call one declared GrFunction (access modes live with the
        declaration); in sim mode the analytic cost model is attached as a
        call-scoped option."""
        opts = {"scheduler": sched, "name": name}
        if gpu is not None:
            opts["cost_s"] = kernel_cost(gpu, flops, bytes_moved, fp64)
            opts["parallel_fraction"] = occupancy(gpu, flops, bytes_moved,
                                                  fp64, parallelism)
        return gf.with_options(**opts)(*arrays)

    # -- interface -------------------------------------------------------
    def sizes(self, scale: float) -> dict:
        raise NotImplementedError

    def make_data(self, scale: float, seed: int = 0) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def build(self, sched: GrScheduler, data, gpu: Optional[GPUSpec] = None,
              iters: int = 2) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def run_reference(self, data, iters: int = 2,
                      device: str = "cuda") -> Dict[str, np.ndarray]:
        """The same kernel functions called in program order on ``device``,
        without a scheduler: what ``build`` must return."""
        raise NotImplementedError

    def footprint_bytes(self, scale: float) -> int:
        data = self.make_data(scale)
        return sum(v.nbytes for v in data.values())


# ======================================================================
class VEC(Benchmark):
    """Vector Squares: sum of differences of two squared vectors; fresh
    input every iteration (streaming) — speedup comes purely from
    transfer/compute overlap (Fig. 11)."""

    name = "VEC"

    def sizes(self, scale):
        return {"n": max(64, int(25_000_000 * scale))}

    def make_data(self, scale, seed=0):
        n = self.sizes(scale)["n"]
        rng = np.random.RandomState(seed)
        return {"x1": rng.rand(n).astype(np.float32) + 0.5,
                "x2": rng.rand(n).astype(np.float32) + 0.5}

    def build(self, sched, data, gpu=None, iters=2):
        n = data["x1"].shape[0]
        zs = []
        for it in range(iters):
            x1 = sched.array(np.roll(data["x1"], it), name=f"x1_{it}")
            x2 = sched.array(np.roll(data["x2"], it), name=f"x2_{it}")
            y1 = sched.array(shape=(n,), dtype=np.float32, name=f"y1_{it}")
            y2 = sched.array(shape=(n,), dtype=np.float32, name=f"y2_{it}")
            z = sched.array(shape=(1,), dtype=np.float32, name=f"z_{it}")
            self._launch(sched, K.SQUARE, [x1, y1], "SQ1",
                         flops=n, bytes_moved=8 * n, gpu=gpu)
            self._launch(sched, K.SQUARE, [x2, y2], "SQ2",
                         flops=n, bytes_moved=8 * n, gpu=gpu)
            self._launch(sched, K.REDUCE_DIFF, [y1, y2, z], "RED",
                         flops=2 * n, bytes_moved=8 * n, gpu=gpu,
                         parallelism=0.5)
            zs.append(float(z[0]) if gpu is None else 0.0)
        sched.sync()
        return {"z": np.asarray(zs, np.float32)}

    def run_reference(self, data, iters=2, device="cuda"):
        zs = []
        for it in range(iters):
            x1 = _dev(np.roll(data["x1"], it), device)
            x2 = _dev(np.roll(data["x2"], it), device)
            z = K.k_reduce_diff(K.k_square(x1, None), K.k_square(x2, None),
                                None)
            zs.append(float(z[0]))
        return {"z": np.asarray(zs, np.float32)}

    def closed_form(self, data, iters=2) -> Dict[str, np.ndarray]:
        """The sums in float64 numpy."""
        zs = []
        for it in range(iters):
            x1, x2 = np.roll(data["x1"], it), np.roll(data["x2"], it)
            zs.append(np.sum(x1.astype(np.float64) ** 2
                             - x2.astype(np.float64) ** 2))
        return {"z": np.asarray(zs)}


# ======================================================================
class BS(Benchmark):
    """Black & Scholes on 10 independent price vectors (double precision);
    many independent kernels -> space-sharing + transfer pipelining."""

    name = "B&S"
    fp64 = True
    n_stocks = 10

    def sizes(self, scale):
        return {"n": max(64, int(2_500_000 * scale)), "stocks": self.n_stocks}

    def make_data(self, scale, seed=0):
        n = self.sizes(scale)["n"]
        rng = np.random.RandomState(seed)
        return {f"s{i}": (rng.rand(n) * 100 + 20).astype(np.float64)
                for i in range(self.n_stocks)}

    def build(self, sched, data, gpu=None, iters=2):
        outs = {}
        for it in range(iters):
            res = []
            for i in range(self.n_stocks):
                n = data[f"s{i}"].shape[0]
                s = sched.array(data[f"s{i}"] + it, name=f"s{i}_{it}")
                o = sched.array(shape=(n,), dtype=np.float64, name=f"c{i}_{it}")
                self._launch(sched, K.BLACK_SCHOLES, [s, o],
                             f"BS{i}", flops=150 * n, bytes_moved=16 * n,
                             gpu=gpu, fp64=True)
                res.append(o)
            outs = {f"c{i}": np.asarray(res[i]).copy() if gpu is None
                    else np.zeros(1) for i in range(self.n_stocks)}
        sched.sync()
        return outs

    def run_reference(self, data, iters=2, device="cuda"):
        outs = {}
        it = iters - 1
        for i in range(self.n_stocks):
            s = _dev(data[f"s{i}"] + it, device)
            outs[f"c{i}"] = K.k_black_scholes(s, None).cpu().numpy()
        return outs

    def closed_form(self, data, iters=2) -> Dict[str, np.ndarray]:
        """The call prices in float64 numpy and scipy."""
        from scipy.special import erf

        def ndtr(v):
            return 0.5 * (1.0 + erf(v / np.sqrt(2.0)))
        K_, r, sigma, T = 60.0, 0.035, 0.2, 1.0
        outs = {}
        for i in range(self.n_stocks):
            s = data[f"s{i}"].astype(np.float64) + (iters - 1)
            d1 = (np.log(s / K_) + (r + 0.5 * sigma ** 2) * T) / (
                sigma * np.sqrt(T))
            d2 = d1 - sigma * np.sqrt(T)
            outs[f"c{i}"] = s * ndtr(d1) - K_ * np.exp(-r * T) * ndtr(d2)
        return outs


# ======================================================================
class IMG(Benchmark):
    """Image pipeline: sharpened picture combined with low/medium-frequency
    blurs through an edge mask — complex DAG on 4 streams (Fig. 6)."""

    name = "IMG"

    def sizes(self, scale):
        side = max(32, int(np.sqrt(6_000_000 * scale)) * 4)
        return {"h": side, "w": side}

    def make_data(self, scale, seed=0):
        s = self.sizes(scale)
        rng = np.random.RandomState(seed)
        return {"img": rng.rand(s["h"], s["w"]).astype(np.float32)}

    def build(self, sched, data, gpu=None, iters=2):
        h, w = data["img"].shape
        hw = h * w
        result = None
        for it in range(iters):
            img = sched.array(data["img"], name=f"img_{it}")
            def mk(nm, it=it):
                return sched.array(shape=(h, w), dtype=np.float32,
                                   name=f"{nm}_{it}")
            b_s, b_m, b_l = mk("bs"), mk("bm"), mk("bl")
            sharp, edges, mask, comb, outp = (mk("sharp"), mk("edges"),
                                              mk("mask"), mk("comb"),
                                              mk("out"))
            self._launch(sched, K.BLUR_S, [img, b_s], "BLUR_S",
                         flops=2 * 9 * hw, bytes_moved=8 * hw, gpu=gpu,
                         parallelism=0.55)
            self._launch(sched, K.BLUR_M, [img, b_m], "BLUR_M",
                         flops=2 * 49 * hw, bytes_moved=8 * hw, gpu=gpu,
                         parallelism=0.55)
            self._launch(sched, K.BLUR_L, [img, b_l], "BLUR_L",
                         flops=2 * 169 * hw, bytes_moved=8 * hw, gpu=gpu,
                         parallelism=0.55)
            self._launch(sched, K.UNSHARPEN, [img, b_s, sharp], "UNSHARP",
                         flops=4 * hw, bytes_moved=12 * hw, gpu=gpu)
            self._launch(sched, K.SOBEL, [sharp, edges], "SOBEL",
                         flops=24 * hw, bytes_moved=8 * hw, gpu=gpu,
                         parallelism=0.55)
            self._launch(sched, K.EXTEND_MASK, [edges, mask],
                         "EXTEND", flops=30 * hw, bytes_moved=8 * hw, gpu=gpu,
                         parallelism=0.55)
            self._launch(sched, K.COMBINE, [sharp, b_m, mask, comb],
                         "COMBINE", flops=5 * hw, bytes_moved=16 * hw, gpu=gpu)
            self._launch(sched, K.COMBINE_LOW, [comb, b_l, mask, outp],
                         "COMBINE_LOW", flops=5 * hw, bytes_moved=16 * hw,
                         gpu=gpu)
            result = outp
        final = np.asarray(result).copy() if gpu is None else np.zeros(1)
        sched.sync()
        return {"out": final}

    def run_reference(self, data, iters=2, device="cuda"):
        img = _dev(data["img"], device)
        b_s = K.k_gaussian_blur(img, None, ksize=3, sigma=1.0)
        b_m = K.k_gaussian_blur(img, None, ksize=7, sigma=2.5)
        b_l = K.k_gaussian_blur(img, None, ksize=13, sigma=5.0)
        sharp = K.k_unsharpen(img, b_s, None)
        edges = K.k_sobel(sharp, None)
        mask = K.k_extend_mask(edges, None)
        comb = K.k_combine(sharp, b_m, mask, None)
        outp = K.k_combine_low(comb, b_l, mask, None)
        return {"out": outp.cpu().numpy()}


# ======================================================================
class ML(Benchmark):
    """NB + Ridge ensemble on a shared read-only input matrix: branch
    imbalance (NB is a slow tall-matrix kernel) + const-argument sharing."""

    name = "ML"
    n_features = 200
    n_classes = 10

    def sizes(self, scale):
        return {"rows": max(32, int(1_200_000 * scale)),
                "features": self.n_features, "classes": self.n_classes}

    def make_data(self, scale, seed=0):
        s = self.sizes(scale)
        rng = np.random.RandomState(seed)
        return {
            "x": rng.rand(s["rows"], s["features"]).astype(np.float32),
            "feat_logprob": rng.randn(s["classes"], s["features"]).astype(np.float32) * 0.1,
            "logprior": rng.randn(s["classes"]).astype(np.float32) * 0.1,
            "w": rng.randn(s["classes"], s["features"]).astype(np.float32) * 0.1,
            "b": rng.randn(s["classes"]).astype(np.float32) * 0.1,
        }

    def build(self, sched, data, gpu=None, iters=2):
        n, f = data["x"].shape
        c = data["w"].shape[0]
        res = None
        for it in range(iters):
            x = sched.array(data["x"], name=f"x_{it}")
            flp = sched.array(data["feat_logprob"], name=f"flp_{it}")
            lp = sched.array(data["logprior"], name=f"lp_{it}")
            wr = sched.array(data["w"], name=f"w_{it}")
            br = sched.array(data["b"], name=f"b_{it}")
            s1 = sched.array(shape=(n, c), dtype=np.float32, name=f"s1_{it}")
            s2 = sched.array(shape=(n, c), dtype=np.float32, name=f"s2_{it}")
            p1 = sched.array(shape=(n, c), dtype=np.float32, name=f"p1_{it}")
            p2 = sched.array(shape=(n, c), dtype=np.float32, name=f"p2_{it}")
            pred = sched.array(shape=(n,), dtype=np.int32, name=f"pred_{it}")
            mm_fl, mm_by = 2 * n * f * c, 4 * (n * f + f * c + n * c)
            # NB: tall-matrix low-occupancy kernel (low IPC, §V-F) — slower.
            self._launch(sched, K.NB_SCORES, [x, flp, lp, s1], "NB",
                         flops=4 * mm_fl, bytes_moved=2 * mm_by, gpu=gpu,
                         parallelism=0.25)
            self._launch(sched, K.RIDGE_SCORES, [x, wr, br, s2], "RIDGE",
                         flops=mm_fl, bytes_moved=mm_by, gpu=gpu,
                         parallelism=0.8)
            self._launch(sched, K.SOFTMAX_NORM, [s1, p1],
                         "SOFTMAX1", flops=5 * n * c, bytes_moved=8 * n * c,
                         gpu=gpu, parallelism=0.7)
            self._launch(sched, K.SOFTMAX_NORM, [s2, p2],
                         "SOFTMAX2", flops=5 * n * c, bytes_moved=8 * n * c,
                         gpu=gpu, parallelism=0.7)
            self._launch(sched, K.ENSEMBLE_AVG, [p1, p2, pred], "ARGMAX",
                         flops=3 * n * c, bytes_moved=4 * n * c + 4 * n,
                         gpu=gpu)
            res = pred
        final = np.asarray(res).copy() if gpu is None else np.zeros(1)
        sched.sync()
        return {"pred": final}

    def run_reference(self, data, iters=2, device="cuda"):
        def d(k):
            return _dev(data[k], device)
        x = d("x")
        s1 = K.k_nb_scores(x, d("feat_logprob"), d("logprior"), None)
        s2 = K.k_ridge_scores(x, d("w"), d("b"), None)
        p1 = K.k_softmax_norm(s1, None)
        p2 = K.k_softmax_norm(s2, None)
        return {"pred": K.k_ensemble_avg(p1, p2, None).cpu().numpy()}


# ======================================================================
class HITS(Benchmark):
    """HITS on a random graph via repeated SpMV on A and A^T, double-buffered
    — the two chains cross-synchronize every iteration (Fig. 6)."""

    name = "HITS"

    def sizes(self, scale):
        n = max(64, int(1_300_000 * scale))
        return {"n": n, "nnz": 20 * n}

    def make_data(self, scale, seed=0):
        s = self.sizes(scale)
        rng = np.random.RandomState(seed)
        n, nnz = s["n"], s["nnz"]
        rows = np.sort(rng.randint(0, n, size=nnz)).astype(np.int32)
        cols = rng.randint(0, n, size=nnz).astype(np.int32)
        vals = np.ones(nnz, np.float32)
        # transpose: swap row/col, sort by new row
        order = np.argsort(cols, kind="stable")
        return {"rows": rows, "cols": cols, "vals": vals,
                "t_rows": cols[order].copy(), "t_cols": rows[order].copy(),
                "t_vals": vals[order].copy()}

    def build(self, sched, data, gpu=None, iters=2):
        n = int(max(data["rows"].max(), data["cols"].max())) + 1
        nnz = data["vals"].shape[0]
        g = {k: sched.array(v, name=k) for k, v in data.items()}
        hub = sched.array(np.ones(n, np.float32), name="hub")
        auth = sched.array(np.ones(n, np.float32), name="auth")
        a_new = sched.array(shape=(n,), dtype=np.float32, name="a_new")
        h_new = sched.array(shape=(n,), dtype=np.float32, name="h_new")
        a_nrm = sched.array(shape=(1,), dtype=np.float32, name="a_nrm")
        h_nrm = sched.array(shape=(1,), dtype=np.float32, name="h_nrm")
        spmv_fl, spmv_by = 2 * nnz, 12 * nnz + 8 * n
        for _it in range(iters):
            # a' = A^T h ; h' = A a   (read previous iterates concurrently)
            self._launch(sched, K.SPMV,
                         [g["t_vals"], g["t_cols"], g["t_rows"], hub, a_new],
                         "SPMV_AT", flops=spmv_fl, bytes_moved=spmv_by,
                         gpu=gpu, parallelism=0.6)
            self._launch(sched, K.SPMV,
                         [g["vals"], g["cols"], g["rows"], auth, h_new],
                         "SPMV_A", flops=spmv_fl, bytes_moved=spmv_by,
                         gpu=gpu, parallelism=0.6)
            self._launch(sched, K.L2_NORM, [a_new, a_nrm],
                         "NORM_A", flops=2 * n, bytes_moved=4 * n, gpu=gpu,
                         parallelism=0.4)
            self._launch(sched, K.L2_NORM, [h_new, h_nrm],
                         "NORM_H", flops=2 * n, bytes_moved=4 * n, gpu=gpu,
                         parallelism=0.4)
            # writes back into `auth`/`hub` (declared out on DIVIDE — the
            # destination's prior value is never read): WAR with this
            # iteration's SpMVs
            self._launch(sched, K.DIVIDE, [a_new, a_nrm, auth], "DIV_A",
                         flops=n, bytes_moved=8 * n, gpu=gpu)
            self._launch(sched, K.DIVIDE, [h_new, h_nrm, hub], "DIV_H",
                         flops=n, bytes_moved=8 * n, gpu=gpu)
        outs = {"auth": np.asarray(auth).copy() if gpu is None else np.zeros(1),
                "hub": np.asarray(hub).copy() if gpu is None else np.zeros(1)}
        sched.sync()
        return outs

    def run_reference(self, data, iters=2, device="cuda"):
        n = int(max(data["rows"].max(), data["cols"].max())) + 1
        g = {k: _dev(v, device) for k, v in data.items()}
        hub = torch.ones(n, dtype=torch.float32, device=device)
        auth = torch.ones(n, dtype=torch.float32, device=device)
        y = torch.empty(n, dtype=torch.float32, device=device)  # its shape
        for _ in range(iters):
            a_new = K.k_spmv(g["t_vals"], g["t_cols"], g["t_rows"], hub, y)
            h_new = K.k_spmv(g["vals"], g["cols"], g["rows"], auth, y)
            auth = K.k_divide(a_new, K.k_l2_norm(a_new, None), None)
            hub = K.k_divide(h_new, K.k_l2_norm(h_new, None), None)
        return {"auth": auth.cpu().numpy(), "hub": hub.cpu().numpy()}


# ======================================================================
class DL(Benchmark):
    """Siamese CNN: two conv towers with shared (read-only) weights project
    two images to embeddings combined by a dense layer."""

    name = "DL"
    c1, c2, emb = 8, 16, 32

    def sizes(self, scale):
        side = max(16, int(np.sqrt(2_000_000 * scale)) * 2)
        return {"side": side, "batch": 4}

    def make_data(self, scale, seed=0):
        s = self.sizes(scale)
        rng = np.random.RandomState(seed)
        side, b = s["side"], s["batch"]
        flat = self.c2 * (side // 4) * (side // 4)
        return {
            "img1": rng.rand(b, 1, side, side).astype(np.float32),
            "img2": rng.rand(b, 1, side, side).astype(np.float32),
            "w1": (rng.randn(self.c1, 1, 3, 3) * 0.2).astype(np.float32),
            "w2": (rng.randn(self.c2, self.c1, 3, 3) * 0.1).astype(np.float32),
            "wd": (rng.randn(flat, self.emb) * 0.05).astype(np.float32),
            "wo": (rng.randn(2 * self.emb, 1) * 0.2).astype(np.float32),
        }

    def build(self, sched, data, gpu=None, iters=2):
        b, _, side, _ = data["img1"].shape
        flat = self.c2 * (side // 4) * (side // 4)
        res = None
        for it in range(iters):
            w1 = sched.array(data["w1"], name=f"w1_{it}")
            w2 = sched.array(data["w2"], name=f"w2_{it}")
            wd = sched.array(data["wd"], name=f"wd_{it}")
            wo = sched.array(data["wo"], name=f"wo_{it}")
            embs = []
            for t in (1, 2):
                x = sched.array(data[f"img{t}"], name=f"img{t}_{it}")
                h1 = sched.array(shape=(b, self.c1, side // 2, side // 2),
                                 dtype=np.float32, name=f"h1_{t}_{it}")
                h2 = sched.array(shape=(b, self.c2, side // 4, side // 4),
                                 dtype=np.float32, name=f"h2_{t}_{it}")
                e = sched.array(shape=(b, self.emb), dtype=np.float32,
                                name=f"e{t}_{it}")
                hw = side * side
                self._launch(sched, K.CONV_RELU_POOL,
                             [x, w1, h1], f"CONV1_{t}",
                             flops=2 * b * self.c1 * 9 * hw,
                             bytes_moved=4 * b * (hw + self.c1 * hw // 4),
                             gpu=gpu, parallelism=0.65)
                self._launch(sched, K.CONV_RELU_POOL,
                             [h1, w2, h2], f"CONV2_{t}",
                             flops=2 * b * self.c2 * self.c1 * 9 * hw // 4,
                             bytes_moved=4 * b * self.c1 * hw // 2, gpu=gpu,
                             parallelism=0.65)
                self._launch(sched, K.DENSE_EMBED,
                             [h2, wd, e], f"DENSE_{t}",
                             flops=2 * b * flat * self.emb,
                             bytes_moved=4 * (b * flat + flat * self.emb),
                             gpu=gpu, parallelism=0.4)
                embs.append(e)
            p = sched.array(shape=(b, 1), dtype=np.float32, name=f"p_{it}")
            self._launch(sched, K.CONCAT_DENSE,
                         [embs[0], embs[1], wo, p],
                         "HEAD", flops=2 * b * 2 * self.emb,
                         bytes_moved=4 * b * 2 * self.emb, gpu=gpu,
                         parallelism=0.2)
            res = p
        final = np.asarray(res).copy() if gpu is None else np.zeros(1)
        sched.sync()
        return {"p": final}

    def run_reference(self, data, iters=2, device="cuda"):
        def d(k):
            return _dev(data[k], device)
        embs = []
        for t in (1, 2):
            h1 = K.k_conv_relu_pool(d(f"img{t}"), d("w1"), None)
            h2 = K.k_conv_relu_pool(h1, d("w2"), None)
            embs.append(K.k_dense_embed(h2, d("wd"), None))
        p = K.k_concat_dense(embs[0], embs[1], d("wo"), None)
        return {"p": p.cpu().numpy()}


BENCHMARKS = {b.name: b for b in (VEC(), BS(), IMG(), ML(), HITS(), DL())}

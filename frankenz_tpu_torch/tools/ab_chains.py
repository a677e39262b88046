"""The two chain kernels against reference builds of them, in turns.

    python -m frankenz_tpu_torch.tools.ab_chains --ref GNG.cu POP.cu \
        [--out DIR] [--reps N]

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  `GNG.cu` and `POP.cu` are other versions of
``csrc/gng_train.cu`` and ``csrc/pop_chain.cu`` with the block route's
entry points (``fz_gng_train`` / ``fz_gng_train_smem`` and
``fz_pop_chain`` / ``fz_pop_chain_smem``, as in the package); each is
compiled alone into its own library and loaded beside the package's.

On config 3's GNG run (bench.py:164-172, :201-209: 100,000 models x 5
filters from ``default_rng(0)``, 250,000 steps up to 2,500 nodes, seed 2,
the draws `GrowingNeuralGas.train_network` makes) and config 5's chain
(bench.py:218-254: 50 bins x 20,000 objects, 40,000 Gibbs steps x 3
proposals, the table and start `population_sampler.run_mcmc` makes) with
one chain and with four, and on 132 chains x 2,000 steps, it
- times reference, package, package, reference (CUDA events, median of
  `--reps` launches each), the package on the route its wrapper picks;
- checks the package equal to the reference bit for bit on every output;
- times the package at every cluster size the card schedules (one chain
  and the GNG run), each equal to the reference bit for bit;
- prints `nvcc -Xptxas -v`'s registers, spills and stack of both builds'
  kernels, and the cluster probe (`kernels.probe`, 40,000 rounds).
It prints one JSON line and writes it to ``DIR/ab_chains.json``.

With ``--stamps`` it instead builds the package's two sources again with
``-DFZ_STAMPS`` (a debug build: CTA 0's thread 0 adds the clock64 cycles
of each part of a step to a device array) and runs the cluster route once
at config 3 and config 5 (one chain) at the wrapper's cluster size,
printing the cycles a step of each part.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

N3, NFILT, NITER_G, NBATCH_G, NMAX_G, SEED_G = 100_000, 5, 5_000, 50, 2_500, 2
NBINS5, NOBS5, T5, THIN5, MH5 = 50, 20_000, 40_000, 400, 3
NCHAINS_MANY, T_MANY = 132, 2_000


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def _ref_lib(build, src, name):
    """Compile `src` alone into build/.../libfz_ref_<name>.so and bind its
    block-route entry points."""
    out = build.library_path().parent / f"libfz_ref_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build._NVCC_FLAGS, "-I",
                    str(build._SRC_DIR), "-shared", "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "gng":
        lib.fz_gng_train_smem.argtypes = [I] * 3
        lib.fz_gng_train.argtypes = ([P] * 11 + [I] * 5 + [F] * 4 + [I] * 3
                                     + [P])
        fns = (lib.fz_gng_train_smem, lib.fz_gng_train)
    else:
        lib.fz_pop_chain_smem.argtypes = [I] * 4
        lib.fz_pop_chain.argtypes = [P] * 11 + [I] * 9 + [P]
        fns = (lib.fz_pop_chain_smem, lib.fz_pop_chain)
    for fn in fns:
        fn.restype = I
    return lib


GNG_PARTS = ("score pass", "next record stored", "exchange barrier",
             "top-2 merge", "upserts + CTA barrier", "column search",
             "batch step (prune, exchanges, insert)", "unused")
POP_PARTS = ("step head", "gradient pass", "gradient exchange", "gscale",
             "proposal passes", "proposal exchanges", "accepts",
             "thinning + draw staging")


def _stamped_lib(build, name):
    """The package's `name` source built with -DFZ_STAMPS into its own
    library, its cluster entry point and stamps reader bound."""
    src = build._SRC_DIR / ("gng_train.cu" if name == "gng" else
                            "pop_chain.cu")
    out = build.library_path().parent / f"libfz_stamps_{name}.so"
    subprocess.run([build.nvcc_path(), *build._NVCC_FLAGS, "-DFZ_STAMPS",
                    "-shared", "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "gng":
        lib.fz_gng_train_cluster.argtypes = ([P] * 11 + [I] * 5 + [F] * 4
                                             + [I] * 3 + [P])
        fns = (lib.fz_gng_train_cluster, lib.fz_gng_train_stamps)
        lib.fz_gng_train_stamps.argtypes = [P]
    else:
        lib.fz_pop_chain_cluster.argtypes = [P] * 10 + [I] * 9 + [P]
        lib.fz_pop_chain_stamps.argtypes = [P]
        fns = (lib.fz_pop_chain_cluster, lib.fz_pop_chain_stamps)
    for fn in fns:
        fn.restype = I
    return lib


def _read_stamps(fn):
    buf = (ctypes.c_ulonglong * 8)()
    rc = fn(ctypes.cast(buf, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"stamps: CUDA error {rc}")
    return list(buf)


def _ptxas(build, source):
    """{kernel: report} of the chain kernels in `source`."""
    rep = build.ptxas_report(source)
    return {name[-60:]: v for name, v in rep.items()
            if "gng_train" in name or "pop_chain" in name}


def main(argv=None):
    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import gng as GG
    from ..kernels import pop as PK
    from ..kernels import probe
    from ..kernels.fullmask import _SMEM_MAX
    from ..kernels.general import _stream
    from ..models import networks as TN
    from ..samplers import population as TP
    from ..samplers import population_sampler

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", nargs=2,
                    help="reference gng_train.cu and pop_chain.cu")
    ap.add_argument("--out", default="build/ab_chains")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stamps", action="store_true",
                    help="time the parts of a step in a -DFZ_STAMPS build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    idx = torch.cuda.current_device()
    card = _card()
    print(card, flush=True)

    if args.stamps:
        return _stamps_main(args, card)
    if not args.ref:
        raise SystemExit("--ref takes a gng_train.cu and a pop_chain.cu")
    srcs = {}
    for path in args.ref:
        text = Path(path).read_text()
        srcs["gng" if "fz_gng_train(" in text else "pop"] = Path(
            path).resolve()
    if set(srcs) != {"gng", "pop"}:
        raise SystemExit("--ref takes a gng_train.cu and a pop_chain.cu")
    build.load()
    ref = {k: _ref_lib(build, v, k) for k, v in srcs.items()}
    ptxas = {"package": {**_ptxas(build, "gng_train.cu"),
                         **_ptxas(build, "pop_chain.cu")},
             "reference": {**_ptxas(build, srcs["gng"]),
                           **_ptxas(build, srcs["pop"])}}
    print(f"ptxas -v: {json.dumps(ptxas)} | card {card}", flush=True)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def turns(old, new):
        """[old, new, new, old] medians."""
        r1, n1, n2, r2 = (median_ms(old), median_ms(new), median_ms(new),
                          median_ms(old))
        return {"ref_ms": [r1, r2], "new_ms": [n1, n2]}

    results = {"card": card, "ptxas": ptxas,
               "probe": probe.cluster_probe(dev, iters=40_000)}
    print(f"cluster probe: {json.dumps(results['probe'])} | card {card}",
          flush=True)
    ok = True

    # Config 3's GNG run, as GrowingNeuralGas.train_network makes it.
    start, (xc, iv, xr) = _config3(np, torch, dev, GG, TN)
    T = xc.shape[0]
    kw = dict(nbatch=NBATCH_G)

    def gng_new(cluster=None):
        return GG.gng_train(*start, 0, xc, iv, xr, cluster=cluster, **kw)

    def gng_ref():
        N, F = NMAX_G, NFILT
        posT = start[0].t().contiguous()
        err, alive = start[1].clone(), start[2].to(torch.int32)
        ids, sref, c = (x.clone() for x in start[3:6])
        ov = torch.zeros(1, dtype=torch.int32, device=dev)
        sched = torch.empty((T, 2), dtype=torch.float32, device=dev)
        lb, ln, dn, da = GG._constants(0.2, 0.005, 0.5, 0.005)
        lib = ref["gng"]
        resident = int(lib.fz_gng_train_smem(N, F, 1) <= _SMEM_MAX)
        rc = lib.fz_gng_train(
            posT.data_ptr(), err.data_ptr(), alive.data_ptr(),
            ids.data_ptr(), sref.data_ptr(), c.data_ptr(), ov.data_ptr(),
            xc.data_ptr(), iv.data_ptr(), xr.data_ptr(), sched.data_ptr(),
            N, F, T, NBATCH_G, 15, lb, ln, dn, da, 1,
            min(1024, max(128, -(-N // 32) * 32)), resident, _stream(dev))
        if rc:
            raise RuntimeError(f"reference gng_train: CUDA error {rc}")
        return (posT.t().contiguous(), err, alive != 0, ids, sref, c,
                int(ov.item()))

    def gng_equal(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
                and a[6] == b[6])

    want = gng_ref()
    active = {k: GG._active(idx, NMAX_G, NFILT, k) for k in GG.CLUSTER_SIZES}
    K_g = GG.choose_cluster(active)
    gng = {"cluster": K_g, "active": active, "steps": T,
           "equal": gng_equal(gng_new(), want)}
    gng.update(turns(gng_ref, gng_new))
    gng["us_per_step"] = {k: [1e3 * x / T for x in gng[k]]
                          for k in ("ref_ms", "new_ms")}
    gng["by_cluster_ms"] = {}
    for k in (1,) + GG.CLUSTER_SIZES:
        if k > 1 and active[k] < 1:
            continue
        gng["equal"] &= gng_equal(gng_new(k), want)
        gng["by_cluster_ms"][k] = median_ms(lambda k=k: gng_new(k))
    results["gng_train config 3"] = gng
    ok &= gng["equal"]
    print(f"gng_train config 3 ({T} steps): K={K_g}, ref "
          f"{gng['ref_ms']} ms, new {gng['new_ms']} ms, by K "
          f"{gng['by_cluster_ms']}, equal {gng['equal']} | card {card}",
          flush=True)
    del want, start, xc, iv, xr
    torch.cuda.empty_cache()

    # Config 5's chains, as population_sampler.run_mcmc makes them.
    pdfs, ps = _config5(np, population_sampler)
    pdfsT = ps._pdfsT()
    stack0 = pdfs.sum(axis=0) / pdfs.sum()
    W = 2 + 2 * MH5
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    pactive = {k: PK._active(idx, NOBS5, W, MH5, k)
               for k in PK.cluster_sizes(NOBS5, W)}

    def pop_ref(d, carry, thin):
        nchains, Ts, _ = d.shape
        out = [torch.empty((nchains, Ts // thin, NBINS5), device=dev),
               torch.empty((nchains, Ts // thin), device=dev)]
        out += [torch.empty_like(x) for x in carry]
        lib = ref["pop"]
        threads = PK.chain_threads(NOBS5)
        resident = int(lib.fz_pop_chain_smem(NOBS5, threads, W, 1)
                       <= _SMEM_MAX)
        rc = lib.fz_pop_chain(
            d.data_ptr(), pdfsT.data_ptr(), *(x.data_ptr() for x in carry),
            *(x.data_ptr() for x in out), None, nchains, Ts, W, NBINS5,
            NOBS5, thin, MH5, threads, resident, _stream(dev))
        if rc:
            raise RuntimeError(f"reference pop_chain: CUDA error {rc}")
        return out

    for nchains, Ts, thin in ((1, T5, THIN5), (4, T5, THIN5),
                              (NCHAINS_MANY, T_MANY, THIN5)):
        d = ps._tables(0, nchains, Ts, NBINS5, MH5).contiguous()
        carry = ps._start(np.tile(stack0, (nchains, 1)), TP._zero_prior,
                          True)

        def new(cluster=None):
            return PK.pop_chain(d, pdfsT, *carry, thin=thin, mh_steps=MH5,
                                cluster=cluster)

        def old():
            return pop_ref(d, carry, thin)

        want = old()
        K_p = PK.choose_cluster(nchains, sms, pactive)
        row = {"cluster": K_p, "steps": Ts,
               "equal": all(torch.equal(x, y) for x, y in zip(new(), want))}
        row.update(turns(old, new))
        row["us_per_step"] = {k: [1e3 * x / Ts for x in row[k]]
                              for k in ("ref_ms", "new_ms")}
        if nchains == 1:
            row["active"] = pactive
            row["by_cluster_ms"] = {}
            for k in (1,) + tuple(pactive):
                if k > 1 and pactive[k] < 1:
                    continue
                row["equal"] &= all(torch.equal(x, y)
                                    for x, y in zip(new(k), want))
                row["by_cluster_ms"][k] = median_ms(lambda k=k: new(k))
        results[f"pop_chain config 5, {nchains} chains x {Ts} steps"] = row
        ok &= row["equal"]
        print(f"pop_chain config 5, {nchains} chains x {Ts} steps: "
              f"K={K_p}, ref {row['ref_ms']} ms, new {row['new_ms']} ms"
              + (f", by K {row['by_cluster_ms']}" if nchains == 1 else "")
              + f", equal {row['equal']} | card {card}", flush=True)
        del d, carry, want
        torch.cuda.empty_cache()

    results["ok"] = bool(ok)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    line = json.dumps(results)
    (out / "ab_chains.json").write_text(line + "\n")
    print(line, flush=True)
    if not ok:
        raise SystemExit("a check failed")


def _config3(np, torch, dev, GG, TN):
    """Config 3's GNG start state and draws on `dev` (as train_network)."""
    rng3 = np.random.default_rng(0)
    m3 = rng3.uniform(1, 10, (N3, NFILT)).astype(np.float32)
    me3 = (0.05 * m3).astype(np.float32)
    T = NITER_G * NBATCH_G
    rng = np.random.default_rng(SEED_G)
    draws = rng.integers(0, N3, size=T)
    i1, i2 = rng.choice(N3, size=2, replace=False)
    pos0 = np.zeros((NMAX_G, NFILT), np.float32)
    pos0[0], pos0[1] = m3[i1], m3[i2]
    alive0 = np.zeros(NMAX_G, bool)
    alive0[:2] = True
    ids0 = np.full((NMAX_G, GG.K), -1, np.int32)
    ids0[0, 0], ids0[1, 0] = 1, 0

    def tens(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    start = [tens(a) for a in (pos0, np.zeros(NMAX_G, np.float32), alive0,
                               ids0, np.zeros((NMAX_G, GG.K), np.int32),
                               np.zeros(NMAX_G, np.int32))]
    draws = [tens(a) for a in TN.som_kernel_draws(m3, me3, np.ones_like(m3),
                                                  draws)]
    return start, draws


def _config5(np, population_sampler):
    """Config 5's PDFs and a population sampler on the card."""
    rng = np.random.default_rng(0)
    grid = np.arange(NBINS5)
    nz = np.exp(-0.5 * ((grid - 18) / 5.0) ** 2)
    nz /= nz.sum()
    zt = rng.choice(NBINS5, NOBS5, p=nz)
    cen = zt + rng.normal(0, 1.5, NOBS5)
    pdfs = np.exp(-0.5 * ((grid[None] - cen[:, None]) / 1.5) ** 2)
    pdfs /= pdfs.sum(1, keepdims=True)
    return pdfs, population_sampler(pdfs, device="cuda")


def _stamps_main(args, card):
    import numpy as np
    import torch

    from ..kernels import build
    from ..kernels import gng as GG
    from ..kernels import pop as PK
    from ..kernels.general import _stream
    from ..models import networks as TN
    from ..samplers import population as TP
    from ..samplers import population_sampler

    dev = torch.device("cuda")
    idx = torch.cuda.current_device()
    build.load()
    results = {"card": card}
    start, (xc, iv, xr) = _config3(np, torch, dev, GG, TN)
    T = xc.shape[0]
    K = GG.choose_cluster({k: GG._active(idx, NMAX_G, NFILT, k)
                           for k in GG.CLUSTER_SIZES})
    lib = _stamped_lib(build, "gng")
    _read_stamps(lib.fz_gng_train_stamps)
    posT = start[0].t().contiguous()
    err, alive = start[1].clone(), start[2].to(torch.int32)
    ids, sref, c = (x.clone() for x in start[3:6])
    ov = torch.zeros(1, dtype=torch.int32, device=dev)
    sched = torch.empty((T, 2), dtype=torch.float32, device=dev)
    lb, ln, dn, da = GG._constants(0.2, 0.005, 0.5, 0.005)
    rc = lib.fz_gng_train_cluster(
        posT.data_ptr(), err.data_ptr(), alive.data_ptr(), ids.data_ptr(),
        sref.data_ptr(), c.data_ptr(), ov.data_ptr(), xc.data_ptr(),
        iv.data_ptr(), xr.data_ptr(), sched.data_ptr(), NMAX_G, NFILT, T,
        NBATCH_G, 15, lb, ln, dn, da, 1, GG.cluster_threads(NMAX_G, K), K,
        _stream(dev))
    if rc:
        raise RuntimeError(f"stamped gng_train: CUDA error {rc}")
    torch.cuda.synchronize()
    cyc = _read_stamps(lib.fz_gng_train_stamps)
    results["gng_train"] = {"cluster": K, "steps": T, "cycles_per_step": {
        p: v / T for p, v in zip(GNG_PARTS, cyc)}}
    print(f"gng_train stamps, K={K}: {results['gng_train']} | card {card}",
          flush=True)

    pdfs, ps = _config5(np, population_sampler)
    W = 2 + 2 * MH5
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    K = PK.choose_cluster(1, sms, {k: PK._active(idx, NOBS5, W, MH5, k)
                                   for k in PK.cluster_sizes(NOBS5, W)})
    lib = _stamped_lib(build, "pop")
    _read_stamps(lib.fz_pop_chain_stamps)
    d = ps._tables(0, 1, T5, NBINS5, MH5).contiguous()
    carry = ps._start((pdfs.sum(axis=0) / pdfs.sum())[None],
                      TP._zero_prior, True)
    out = [torch.empty((1, T5 // THIN5, NBINS5), device=dev),
           torch.empty((1, T5 // THIN5), device=dev)]
    out += [torch.empty_like(x) for x in carry]
    rc = lib.fz_pop_chain_cluster(
        d.data_ptr(), ps._pdfsT().data_ptr(), *(x.data_ptr() for x in carry),
        *(x.data_ptr() for x in out), 1, T5, W, NBINS5, NOBS5, THIN5, MH5,
        PK.chain_threads(NOBS5), K, _stream(dev))
    if rc:
        raise RuntimeError(f"stamped pop_chain: CUDA error {rc}")
    torch.cuda.synchronize()
    cyc = _read_stamps(lib.fz_pop_chain_stamps)
    results["pop_chain"] = {"cluster": K, "steps": T5, "cycles_per_step": {
        p: v / T5 for p, v in zip(POP_PARTS, cyc)}}
    print(f"pop_chain stamps, K={K}: {results['pop_chain']} | card {card}",
          flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "ab_chains_stamps.json").write_text(json.dumps(results) + "\n")


if __name__ == "__main__":
    main()

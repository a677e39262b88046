"""The lnl table of the two-pass threshold route, on CPU tensors, where
every wrapper runs its plain version.

The route (`kernels.general`: `lnl_reduce`, `lnl_stack` and
`scale_sweeps` with ``table``; `ops.fused._table_route` per row chunk)
computes each pair's lnl once per call into a float32 (B,
`table_width(M)`) table.  For every two-pass instantiation (fixed or free
scale x full or masked photometry x dim prior or Normal x model errors
kept or ignored): the table equals `lnl_tile_plain` bit for bit and the
columns past M stay untouched; the route's (pdf, lmap, levid) equal the
recompute route's (the same wrappers without a table) bit for bit; the
free-scale producer's sweep table equals `scale_sweeps_plain`'s, at
max_iter 0, 1 and 100, over a ragged last group; `fused_fit_pdf` cut into
three ragged chunks (the byte cap made small) equals one chunk.  The
kernels are held to the same on the card in tests/test_torch_kernels.py
(-m gpu); `fused_fit_pdf` and `BruteForce` on this route against JAX in
tests/test_torch_general.py and tests/test_torch_freescale.py.
"""

import numpy as np
import pytest
import torch

from frankenz_tpu_torch.kernels import general as GK
from frankenz_tpu_torch.ops import fused as TF
from frankenz_tpu_torch.ops import kde as TK

TM = 64  # free-scale convergence groups: M = 203 leaves a ragged last one
LOG_THR = float(np.log(1e-3))

INSTANTIATIONS = [dict(free_scale=fs, full_mask=fm, dim_prior=dp,
                       ignore_model_err=ime)
                  for fs in (False, True) for fm in (False, True)
                  for dp in (True, False) for ime in (False, True)]
IDS = ["{}-{}-{}-{}".format("free" if i["free_scale"] else "fixed",
                            "full" if i["full_mask"] else "masked",
                            "dimprior" if i["dim_prior"] else "normal",
                            "ime" if i["ignore_model_err"] else "me")
       for i in INSTANTIATIONS]


def _problem(masked, F=5, B=23, M=203, Ngrid=41, seed=5):
    """(d, de, dm, mT, meT, mmT, G): data are noisy copies of models
    scaled by U(0.5, 2) (so the free scale iterates), 15% of data and 10%
    of model bands masked when `masked`, rows 1-3 then with 0, 1 and 2
    observed bands."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1, 10, (M, F)).astype(np.float32)
    me = (0.05 * m).astype(np.float32)
    d = (rng.uniform(0.5, 2.0, (B, 1)) * m[rng.integers(0, M, B)]
         + rng.normal(0, 0.3, (B, F))).astype(np.float32)
    de = np.full((B, F), 0.3, np.float32)
    dm = np.ones((B, F), np.float32)
    mm = np.ones((M, F), np.float32)
    if masked:
        dm = (rng.uniform(size=(B, F)) > 0.15).astype(np.float32)
        mm = (rng.uniform(size=(M, F)) > 0.1).astype(np.float32)
        dm[1:4] = 0.0
        dm[2, 0] = dm[3, :2] = 1.0
    G = TK.kernel_matrix(rng.uniform(0, 3, M), np.full(M, 0.1),
                         np.linspace(0, 3, Ngrid), device="cpu").to(
                             torch.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (d, de, dm, m.T, me.T, mm.T)] + [G.contiguous()]


def _sweeps(inst):
    return inst["free_scale"] and not inst["ignore_model_err"]


def _table(t, fill=np.nan):
    return torch.full((t[0].shape[0], GK.table_width(t[3].shape[1])), fill)


def _produce(t, inst, table, max_iter=100):
    """Fill `table` as the route's producer does; returns the kernels'
    flags (with the sweep table under free scale with model errors)."""
    flags = dict(inst, sweeps=None, tm=None)
    if _sweeps(inst):
        flags.update(tm=TM, sweeps=GK.scale_sweeps(
            *t[:6], tm=TM, full_mask=inst["full_mask"], max_iter=max_iter,
            table=table, dim_prior=inst["dim_prior"]))
    else:
        GK.lnl_reduce(*t[:6], table=table, **flags)
    return flags


@pytest.mark.parametrize("inst", INSTANTIATIONS, ids=IDS)
def test_table_equals_lnl_tile_plain(inst):
    t = _problem(masked=not inst["full_mask"])
    M = t[3].shape[1]
    table = _table(t)
    flags = _produce(t, inst, table)
    want = GK.lnl_tile_plain(*t[:6], **flags)
    assert torch.equal(table[:, :M], want)
    assert torch.isnan(table[:, M:]).all()
    if not inst["full_mask"] and inst["dim_prior"]:
        assert (want[1] == GK.NEG_INF).all()  # Ndim 0: the floor


def _band_problem(t):
    """Problem `t` with its models in band order (`band_sort`): the model
    arrays and G (its first M rows and Ngrid columns) sorted, and the
    `BandSort`."""
    bs = GK.band_sort(t[6], *t[3:6])
    M = t[3].shape[1]
    return (t[:3] + [bs.mT, bs.meT, bs.mmT]
            + [bs.G[:M, :bs.ngrid].contiguous()]), bs


@pytest.mark.parametrize("inst", INSTANTIATIONS, ids=IDS)
def test_table_route_equals_recompute_route(inst):
    """The route's order: the models in band order and `lnl_stack_band`,
    except under free scale with model errors (the caller's order and
    `lnl_stack` on the table); the recompute route gets the same models
    in the same order."""
    t = _problem(masked=not inst["full_mask"])
    bs = None
    if not _sweeps(inst):
        t, bs = _band_problem(t)
    table = _table(t)
    flags = _produce(t, inst, table)
    GK.reset_launch_counts()
    lmap, levid = GK.lnl_reduce(*t[:6], table=table, **flags)
    if bs is None:
        pdf = GK.lnl_stack(*t[:6], t[6], lmap, levid, log_thr=LOG_THR,
                           table=table, **flags)
    else:
        pdf = GK.lnl_stack_band(table, bs, lmap, levid, log_thr=LOG_THR)
    want_lmap, want_levid = GK.lnl_reduce(*t[:6], **flags)
    want_pdf = GK.lnl_stack(*t[:6], t[6], want_lmap, want_levid,
                            log_thr=LOG_THR, **flags)
    for got, want in ((lmap, want_lmap), (levid, want_levid),
                      (pdf, want_pdf)):
        assert torch.equal(got, want)
    assert (pdf > 0).any() and (pdf == 0).any()
    assert all(n == 0 for n in GK.launch_counts().values())


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("max_iter", [0, 1, 100])
def test_free_scale_producer_keeps_the_sweep_table(masked, max_iter):
    """The producer's sweep table is `scale_sweeps_plain`'s without a
    table (the sentinels of the ragged last group join its maxima and
    get no entry), and its lnl `lnl_tile_plain`'s over it: at max_iter 0
    each pair ends at (s_0, s_0), at 1 at (s_0, s_1)."""
    t = _problem(masked=masked)
    M = t[3].shape[1]
    assert M % TM
    table = _table(t)
    kw = dict(tm=TM, full_mask=not masked, max_iter=max_iter)
    got = GK.scale_sweeps_plain(*t[:6], table=table, **kw)
    want = GK.scale_sweeps_plain(*t[:6], **kw)
    assert torch.equal(got, want)
    assert int(got.max()) == max_iter if max_iter < 100 else \
        0 < int(got.max()) < 100
    lnl = GK.lnl_tile_plain(*t[:6], free_scale=True, full_mask=not masked,
                            sweeps=got, tm=TM)
    assert torch.equal(table[:, :M], lnl)
    assert torch.isnan(table[:, M:]).all()


@pytest.mark.parametrize("inst", [INSTANTIATIONS[i] for i in (0, 10, 12)],
                         ids=[IDS[i] for i in (0, 10, 12)])
def test_fused_route_in_three_ragged_chunks_equals_one(inst, monkeypatch):
    """B = 23 rows under a cap of 8 rows of table: chunks of 8, 8 and 7
    rows through one buffer, bit for bit the one-chunk call."""
    t = _problem(masked=not inst["full_mask"])
    d, de, dm, mT, meT, mmT, G = t
    kw = dict(dim_prior=inst["dim_prior"],
              ignore_model_err=inst["ignore_model_err"],
              free_scale=inst["free_scale"], full_mask=inst["full_mask"],
              tm=TM)
    args = (d, de, dm, mT.T, meT.T, mmT.T, G)
    whole = TF.fused_fit_pdf(*args, **kw)
    rows = []
    reduce = GK.lnl_reduce

    def spy(d, *a, **k):
        rows.append(d.shape[0])
        assert k["table"] is not None
        return reduce(d, *a, **k)

    monkeypatch.setattr(GK, "lnl_reduce", spy)
    monkeypatch.setattr(GK, "TABLE_BYTES_MAX",
                        8 * 4 * GK.table_width(mT.shape[1]))
    chunked = TF.fused_fit_pdf(*args, **kw)
    assert rows == [8, 8, 7]
    for got, want in zip(chunked, whole):
        assert torch.equal(got, want)


def test_table_rows_cut_under_the_cap(monkeypatch):
    """The fewest chunks under the cap, of equal size: config 8's 16,384
    rows x 100,000 models (6.55 GB) in one, a masked 65,536 batch (26.2
    GB) in two of 32,768 under 16 GiB."""
    assert GK.table_width(100_000) == 100_032
    assert GK.table_width(64) == 64 and GK.table_width(65) == 128
    assert GK.table_rows(16_384, 100_000) == 16_384
    assert GK.table_rows(65_536, 100_000) == 32_768
    assert GK.table_rows(0, 100_000) == 1
    row = 4 * GK.table_width(203)
    monkeypatch.setattr(GK, "TABLE_BYTES_MAX", 8 * row)
    assert GK.table_rows(23, 203) == 8
    assert GK.table_rows(24, 203) == 8
    assert GK.table_rows(25, 203) == 7
    monkeypatch.setattr(GK, "TABLE_BYTES_MAX", row // 2)
    assert GK.table_rows(23, 203) == 1


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "contiguity"])
def test_tables_are_checked(bad):
    t = _problem(masked=True)
    table = _table(t, 0.0)
    err = ValueError
    if bad == "dtype":
        table, err = table.double(), TypeError
    elif bad == "width":
        table = table[:, :-1].contiguous()
    elif bad == "rows":
        table = table[:-1]
    else:
        table = table.T.contiguous().T
    with pytest.raises(err):
        GK.lnl_reduce(*t[:6], table=table)
    with pytest.raises(err):
        GK.scale_sweeps(*t[:6], tm=TM, table=table)

"""Native C++ IO library vs numpy references."""

import numpy as np
import pytest

from insider_tpu.data import native


pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native toolchain unavailable")


def test_csv_parse_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((50, 12)).astype(np.float32)
    arr[3, 4] = np.nan
    p = tmp_path / "t.csv"
    with open(p, "w") as fh:
        fh.write(",".join(f"c{i}" for i in range(12)) + "\n")
        for row in arr:
            fh.write(",".join("NA" if np.isnan(v) else f"{v:.6f}"
                              for v in row) + "\n")
    got = native.load_csv(str(p), ",", skip_header=True)
    assert got.shape == (50, 12)
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(arr),
                               atol=1e-5)
    assert np.isnan(got[3, 4])


def test_tsv_parse(tmp_path):
    p = tmp_path / "t.tsv"
    with open(p, "w") as fh:
        fh.write("1.5\t2.5\t3\n4\t\t6\n")
    got = native.load_csv(str(p), "\t", skip_header=False)
    assert got.shape == (2, 3)
    assert got[0, 0] == pytest.approx(1.5)
    assert np.isnan(got[1, 1])
    assert got[1, 2] == pytest.approx(6.0)


def test_strict_na_tokens_and_quotes(tmp_path):
    """NA/NaN/N/A (any case) and quoted fields parse; junk raises (any
    field starting with N used to silently become NaN)."""
    p = tmp_path / "ok.csv"
    with open(p, "w") as fh:
        fh.write('1.5,NA,nan,"2.5",N/A\n"3",NaN,-1e3, 4 ,5\n')
    got = native.load_csv(str(p), ",", skip_header=False)
    assert got.shape == (2, 5)
    assert got[0, 0] == pytest.approx(1.5)
    assert np.isnan(got[0, 1]) and np.isnan(got[0, 2]) and np.isnan(got[0, 4])
    assert got[0, 3] == pytest.approx(2.5)
    assert got[1, 0] == pytest.approx(3.0)
    assert np.isnan(got[1, 1])
    assert got[1, 2] == pytest.approx(-1e3)
    assert got[1, 3] == pytest.approx(4.0)

    bad = tmp_path / "bad.csv"
    with open(bad, "w") as fh:
        fh.write("1.0,N5,3.0\n4.0,null,6.0\n")
    with pytest.raises(ValueError, match="2 field"):
        native.load_csv(str(bad), ",", skip_header=False)
    lax = native.load_csv(str(bad), ",", skip_header=False, strict=False)
    assert np.isnan(lax[0, 1]) and np.isnan(lax[1, 1])
    assert lax[1, 2] == pytest.approx(6.0)


def test_log2p1():
    rng = np.random.default_rng(1)
    x = (rng.random((100, 7)) * 50).astype(np.float32)
    want = np.log2(x + 1.0)
    got = native.log2p1(x.copy())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_split_mask_properties():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((200, 100)).astype(np.float32)
    data[rng.random(data.shape) < 0.05] = np.nan
    train, test, na, k = native.split_mask(data, 0.1, seed=123)
    nan = np.isnan(data)
    n_obs = (~nan).sum()
    assert k == int(n_obs * 0.1)
    assert test.sum() == k
    assert np.array_equal(na.astype(bool), nan)
    assert np.all(train + test + na == 1)
    # deterministic
    train2, test2, _, _ = native.split_mask(data, 0.1, seed=123)
    assert np.array_equal(test, test2)
    # different seed differs
    _, test3, _, _ = native.split_mask(data, 0.1, seed=7)
    assert not np.array_equal(test, test3)


def test_split_mask_uniformity():
    """Test sample should be spread roughly uniformly across the matrix."""
    data = np.ones((100, 1000), np.float32)
    _, test, _, k = native.split_mask(data, 0.1, seed=0)
    per_row = test.sum(axis=1)
    assert per_row.mean() == pytest.approx(100, rel=0.05)
    assert per_row.std() < 30


def test_block_read_matches_memmap(tmp_path):
    rng = np.random.default_rng(5)
    N, M = 37, 53
    x = rng.standard_normal((N, M)).astype(np.float32)
    path = str(tmp_path / "mat.f32")
    x.tofile(path)
    from insider_tpu.data.native import read_block

    blk = read_block(path, (N, M), (5, 21), (7, 40))
    np.testing.assert_array_equal(blk, x[5:21, 7:40])
    # full matrix as one block
    np.testing.assert_array_equal(read_block(path, (N, M), (0, N), (0, M)), x)


def test_split_mask_block_tiles_consistently():
    """Blocks of the SAME global split generated independently must tile
    into one consistent global mask — the distributed-determinism
    contract."""
    from insider_tpu.data.native import split_mask_block

    N, M, ratio, seed = 40, 64, 0.1, 123
    full_tr, full_te, full_na = split_mask_block((N, M), (0, N), (0, M),
                                                 ratio, seed)
    # tile from 4 blocks
    for rows in ((0, 17), (17, 40)):
        for cols in ((0, 31), (31, 64)):
            tr, te, na = split_mask_block((N, M), rows, cols, ratio, seed)
            np.testing.assert_array_equal(
                tr, full_tr[rows[0]:rows[1], cols[0]:cols[1]])
            np.testing.assert_array_equal(
                te, full_te[rows[0]:rows[1], cols[0]:cols[1]])
    # test fraction approximately `ratio` and masks partition the matrix
    assert abs(full_te.mean() - ratio) < 0.02
    np.testing.assert_array_equal(full_tr + full_te + full_na,
                                  np.ones((N, M), np.uint8))


def test_split_mask_block_native_matches_numpy_fallback(monkeypatch):
    """The numpy fallback must generate the IDENTICAL splitmix64 stream as
    the C++ implementation (cross-process determinism cannot depend on
    which implementation a host happens to have)."""
    import insider_tpu.data.native as nat

    if not nat.native_available():
        pytest.skip("native lib unavailable")
    a = nat.split_mask_block((30, 40), (3, 20), (5, 33), 0.2, 99)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", True)
    b = nat.split_mask_block((30, 40), (3, 20), (5, 33), 0.2, 99)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_split_mask_block_nan_handling():
    from insider_tpu.data.native import split_mask_block

    blk = np.ones((6, 8), np.float32)
    blk[2, 3] = np.nan
    tr, te, na = split_mask_block((6, 8), (0, 6), (0, 8), 0.3, 7,
                                  data_block=blk)
    assert na[2, 3] == 1 and tr[2, 3] == 0 and te[2, 3] == 0


def test_file_ingest_callbacks_end_to_end(tmp_path):
    """build_problem_distributed fed entirely from a raw f32 file via the
    native per-shard callbacks matches the in-memory build."""
    import jax
    from jax.sharding import PartitionSpec as P

    import insider_tpu as it
    from insider_tpu.config import FitConfig, ShardingConfig
    from insider_tpu.data.native import file_ingest_callbacks, split_mask_block
    from insider_tpu.train import als

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    rng = np.random.default_rng(8)
    N, M, K = 48, 256, 3
    sim = it.simulate_scale(N, M, K, level_counts=(2, 4), noise_std=1.0,
                            seed=3)
    path = str(tmp_path / "data.f32")
    sim.data.astype(np.float32).tofile(path)
    codes = []
    n_levels = []
    for c in range(sim.confounder.shape[1]):
        lv, inv = np.unique(sim.confounder[:, c], return_inverse=True)
        codes.append(inv.astype(np.int32))
        n_levels.append(int(lv.size))

    data_cb, train_cb, test_cb = file_ingest_callbacks(path, (N, M), 0.1,
                                                       seed=77)
    cfg_sh = ShardingConfig(rows=2, cols=4)
    problem = als.build_problem_distributed(
        data=data_cb, train_indicator=train_cb, test_indicator=test_cb,
        codes=codes, n_levels=tuple(n_levels), global_shape=(N, M),
        sharding=cfg_sh, masked=True,
    )
    cfg = FitConfig(latent_dim=K, lambda1=1.0, lambda2=1.0, alpha=0.3,
                    masked=True, max_iter=10, global_tol=0.0,
                    use_pallas=False)
    res = als.optimize(problem, cfg, verbose=False)

    # in-memory reference with the identical split
    tr, te, _ = split_mask_block((N, M), (0, N), (0, M), 0.1, 77,
                                 data_block=sim.data.astype(np.float32))
    problem2 = als.build_problem(sim.data, sim.confounder, tr, te,
                                 masked=True)
    res2 = als.optimize(problem2, cfg, verbose=False)
    assert res.loss == pytest.approx(res2.loss, rel=1e-5)
    assert res.test_rmse == pytest.approx(res2.test_rmse, rel=1e-5)

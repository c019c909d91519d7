"""The hand-written CUDA kernels (K1 and its whitened form, with one
temperature or one per chain, K2, K3, K4, the NUTS leaf, the PT swap)
against their plain PyTorch versions, on the card. These tests need a CUDA device
and skip without one; run them on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

import chip_smoke
from magi_v2_tpu_torch.models import seir_f_vec
from magi_v2_tpu_torch.ops import manifold as mf

pytestmark = pytest.mark.cuda

# relative to each logical output's largest |value| (see chip_smoke.TOL)
TOL = chip_smoke.TOL


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def test_kernels_match_plain_versions(device):
    """The three kernels at the SEIR bench shapes, float32 and float64;
    each launch counted."""
    mf.reset_launch_counts()
    results = chip_smoke.check_kernels(device)
    assert set(results) == set(mf.KERNELS)
    assert all(n > 0 for n in mf.launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,N", [(1, 161), (3, 17), (256, 161)])
def test_fused_target_on_card_matches_cpu(device, dtype, C, N):
    """fwd -> energy -> bwd composed on the card against the same calls
    on the CPU (plain versions), at ragged chain and grid sizes."""
    x = chip_smoke.kernel_inputs(torch.float64, "cpu", C=C, N=N)
    I = torch.zeros((N, 1), dtype=torch.float64)

    def run(dev, dt):
        y = {k: v.to(dev, dt) if isinstance(v, torch.Tensor) else v
             for k, v in x.items()}
        Iy = I.to(dev, dt)
        dr, gcat, t14 = mf.manifold_fwd(
            seir_f_vec, Iy, y["delta"], y["RmD"], y["q"], y["x0T"], y["a0"],
            y["f0"], y["mask"], y["y"], y["sigma_lb"], y["beta_temp"],
            y["beta"])
        lp, gDs = mf.manifold_energy(seir_f_vec, dr, y["s0"], t14, y["q"],
                                     y["sigma_lb"], y["n_ds"],
                                     y["beta_temp"], y["beta"])
        grad = torch.zeros_like(y["q"])
        gpart = mf.manifold_bwd(seir_f_vec, Iy, gDs, y["delta"], y["q"],
                                y["x0T"], y["mask"], y["y"], y["sigma_lb"],
                                y["n_ds"], y["beta_temp"], gcat, grad)
        return [t.double().cpu() for t in (dr, gcat, t14, lp, gDs, gpart,
                                           grad)]

    on_card = run(device, dtype)
    torch.cuda.synchronize()
    on_cpu = run("cpu", dtype)
    names = ("dr", "gcat", "t14", "lp", "gDs", "gpart", "grad")
    errs = chip_smoke.part_errors(zip(names, on_cpu, on_card), N, 3)
    for part, (_, rel) in errs.items():
        assert rel <= TOL[dtype], (part, rel)


def test_wrappers_raise_instead_of_falling_back(device):
    x = chip_smoke.kernel_inputs(torch.float32, device, C=2, N=9)
    I = torch.zeros((9, 1), dtype=torch.float32, device=device)
    with pytest.raises(TypeError, match="float32 or float64"):
        h = {k: v.half() if isinstance(v, torch.Tensor) else v
             for k, v in x.items()}
        mf.manifold_fwd(seir_f_vec, I.half(), h["delta"], h["RmD"], h["q"],
                        h["x0T"], h["a0"], h["f0"], h["mask"], h["y"],
                        h["sigma_lb"], h["beta_temp"], h["beta"])
    # a field with no CUDA functor launches K1's given kernel on the card,
    # chosen by the field, and agrees with the plain version
    field = lambda t, X, th: X * th[:, None, :]
    args = (field, I, x["delta"], x["RmD"], x["q"], x["x0T"], x["a0"],
            x["f0"], x["mask"], x["y"], x["sigma_lb"], x["beta_temp"],
            x["beta"])
    mf.reset_launch_counts()
    got = mf.manifold_fwd(*args)
    assert mf.launch_counts()["manifold_fwd"] == 1
    ref = mf.manifold_fwd_plain(*args)
    # manifold_fwd writes only the first half of gcat
    for a, b in ((got[0], ref[0]), (got[2], ref[2]),
                 (got[1][..., :9], ref[1][..., :9])):
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


def test_sampler_runs_full_float32_on_card(device):
    """A short HMC run of the SEIR slice on the card: the kernels launch,
    draws are finite, and TF32 stays off."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig
    from magi_v2_tpu_torch.utils.data import simulate_ode

    ts, X, _ = simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    cfg = MagiConfig(dtype=torch.float32, device=str(device),
                     hparam_num_iters=50, init_num_iters=100)
    m = MAGI_v2(3, ts, X, None, seir_f_vec, cfg)
    m.initial_fit(1)
    mf.reset_launch_counts()
    res = m.predict(num_results=20, num_burnin_steps=20, num_chains=8,
                    algorithm="hmc", hmc_num_leapfrogs=8, mass_matrix="dense")
    assert all(n > 0 for n in mf.launch_counts().values())
    assert np.all(np.isfinite(res["X_samps"]))
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_lorenz_kernels_match_plain_versions(device):
    """K1 with the Lorenz model functor at the dense-grid shapes (256
    chains, N_I = 1025)."""
    mf.reset_launch_counts()
    results = chip_smoke.check_kernels(device, model="lorenz", N=1025)
    assert set(results) == {f"{k}_lorenz" for k in mf.KERNELS}
    assert all(n > 0 for n in mf.launch_counts().values())


@pytest.mark.parametrize("model,C,N", [
    ("seir", 37, 333), ("lorenz", 1, 128), ("lorenz", 3, 129),
    ("seir", 5, 17), ("lorenz", 300, 1000), ("lorenz", 64, 1025),
    ("lorenz", 257, 1025), ("hes1_log", 64, 129),
    ("protein_transduction", 37, 333), ("sirw", 3, 300)])
def test_kernels_at_sizes_that_fill_no_tile(device, model, C, N):
    """K1 through the target's plan and through the one-shot wrappers, at
    chain counts and grids around the kernels' 128 points per CTA: one CTA
    per chain, a last CTA of one point, several part-filled ones, and the
    banded run's shape (64 chains at N_I = 1025: one point a thread, nine
    CTAs a chain, where 256 chains take five) beside a ragged 257. Two
    runs of each launch agree bit for bit (checked inside)."""
    results = chip_smoke.check_kernels(device, model=model, N=N, C=C)
    assert len(results) == 3


@pytest.mark.parametrize("model,C,N", [("seir", 256, 161), ("seir", 37, 333),
                                       ("fhn", 16, 81)])
def test_whitened_fwd_kernel_matches_plain_version(device, model, C, N):
    """K1's whitened fwd (t1 = ||z||^2; functor and given kernels) against
    its plain version, float32 and float64, each launch twice bit for bit,
    counted under its own name."""
    mf.reset_launch_counts()
    chip_smoke.check_whitened_kernels(device, model=model, C=C, N=N, reps=5)
    name = "manifold_fwd_whitened_" + ("given" if model == "fhn" else model)
    assert mf.functor_launch_counts()[name] > 0


@pytest.mark.parametrize("model,N,C", chip_smoke.K1_PT_CASES)
def test_k1_per_chain_matches_plain_version(device, model, N, C):
    """K1 with a temperature per chain (stride 1: fwd, its whitened form,
    energy, bwd; functor and given kernels) against its plain version,
    float32 and float64; each launch twice bit for bit, equal temperatures
    giving the stride-0 launch's bits (checked inside); counted with
    "_pt"."""
    mf.reset_launch_counts()
    results = chip_smoke.check_k1_per_chain(device, model, N, C, reps=3)
    assert len(results) == 4
    functor = "given" if model == "fhn" else model
    assert all(mf.functor_launch_counts()[f"{k}_{functor}_pt"] > 0
               for k in mf.KERNELS + ("manifold_fwd_whitened",))


def test_pt_swap_kernel_matches_plain_version(device):
    """K6, the swap kernel, against its plain version at the Hes1, SEIR and
    unaligned Lorenz shapes, both parities: equal q, lp and counters
    (checked inside)."""
    from magi_v2_tpu_torch.ops import pt

    pt.reset_launch_counts()
    assert set(chip_smoke.check_pt_swap(device, reps=3)) == {"pt_swap"}
    assert pt.launch_counts()["pt_swap"] > 0


def test_pt_graph_replay_matches_eager(device):
    """PT HMC transitions with swap rounds by replayed CUDA graphs against
    the eager forms on a small SEIR fit, 4 rungs x 8 replicas, bit for bit
    (checked inside)."""
    from magi_v2_tpu_torch.sampler import hmc

    model = _small_seir(device)
    mode, _, _ = model._build_sampling_setup("precond", "dense",
                                             torch.float32)
    dim = model.mag_I * 3 + 6
    q0 = torch.cat([mode.X0.reshape(-1).float(),
                    torch.tensor(chip_smoke.SEIR_TAIL, device=device)])
    g = torch.Generator(device=device).manual_seed(0)
    qs = q0 + 0.01 * torch.randn((32, dim), generator=g, device=device)
    hmc.reset_graph_counts()
    chip_smoke.pt_graph_vs_eager(
        mode.logp_grad, qs, torch.ones(dim, device=device),
        torch.tensor(0.01, device=device), chip_smoke.SEIR_PT_LADDER,
        "small SEIR", transitions=6, algorithm="hmc", max_leapfrogs=8)
    assert hmc.graph_counts()["pt_swap"] == 6


def test_plan_leaves_its_tickets_at_zero(device):
    """A chain's CTAs draw tickets from a counter that the last one
    resets: after any number of launches the counters read 0."""
    x = chip_smoke.kernel_inputs(torch.float32, device, C=9, N=700)
    plan, b, _ = chip_smoke.make_plan(seir_f_vec, x, device, torch.float32)
    stream = torch.cuda.current_stream(device).cuda_stream
    lp = torch.empty((9,), dtype=torch.float32, device=device)
    grad = torch.zeros_like(x["q"])
    for _ in range(3):
        plan.fwd(x["q"], x["beta_temp"], stream)
        plan.energy(x["q"], x["beta_temp"], lp, stream)
        plan.bwd(x["q"], x["beta_temp"], grad, stream)
    torch.cuda.synchronize()
    assert int(plan.scratch[1].abs().sum()) == 0
    assert torch.isfinite(lp).all() and torch.isfinite(grad[:, 2100:]).all()


def test_leapfrog_kernel_matches_plain_version(device):
    """K2 in one launch on the full dense metric (489 wide), a diagonal
    and dense tails of 3 and 8 (3081 wide), at 1, 64, 256 and 257 chains,
    with and without the kinetic energy, each launch run twice bit for
    bit (checked inside); and dense blocks of 256 (48 KB of shared memory,
    the default limit) and 1100 (four columns a thread, five CTAs a
    cluster)."""
    from magi_v2_tpu_torch.sampler import hmc

    hmc.reset_launch_counts()
    cases = chip_smoke.K2_CASES + (("dense256", 256, 256),
                                   ("dense1100", 1100, 1100))
    results = chip_smoke.check_leapfrog(device, chains=(1, 64, 256, 257),
                                        cases=cases)
    assert set(results) == {name for name, _, _ in chip_smoke.K2_ENTRIES}
    assert hmc.launch_counts()["leapfrog_update"] > 0


def test_leapfrog_wrapper_raises_instead_of_falling_back(device):
    from magi_v2_tpu_torch.sampler import hmc

    q, p, g, eps, mass = chip_smoke.leapfrog_case(4, 33, 0, torch.float32,
                                                  device)
    flat = torch.zeros(4 * 33 + 1, device=device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hmc.leapfrog_update(flat[1:].view(4, 33), p, g, eps, mass, 2, True,
                            False)
    # the dense widths K2 refused before its momenta were streamed: checked
    # against the plain version (inside) at 64 and 257 chains
    chip_smoke.check_wide_leapfrog(device)


@pytest.mark.parametrize("storage", ["dense", "hybrid", "banded"])
def test_graph_replay_matches_eager(device, storage):
    """The sampler's bound transition (captured CUDA graphs, replayed)
    against the eager transition for a few transitions from the same state
    and noise, on a small Lorenz fit in each storage: equal bit for bit,
    or within K2's tolerance for one transition (checked inside); every
    transition replays its captured steps."""
    from magi_v2_tpu_torch.sampler import hmc

    model = _small_lorenz(device)
    hmc.reset_graph_counts()
    chip_smoke.graph_vs_eager(
        model, device, storage, 8, 8, (-1.5, -1.5, -1.5, 10.0, 28.0, 2.6),
        step_size=0.02, beta_temp=0.4, dense_mass=storage == "dense",
        sigma_fixed=None if storage == "dense" else 0.25, transitions=4)
    counts = hmc.graph_counts()
    assert counts["captures"] == 3 and counts["first"] >= 4


def test_leapfrog_nuts_form_matches_plain_version(device):
    """K2's NUTS form (a signed step per chain, a mask, the velocities
    out) at 1, 64, 256 and 257 chains, float32 and float64, each launch
    twice bit for bit, masked chains untouched with a NaN force (checked
    inside)."""
    from magi_v2_tpu_torch.sampler import hmc

    hmc.reset_launch_counts()
    results = chip_smoke.check_leapfrog_nuts(device, chains=(1, 64, 256,
                                                             257))
    assert set(results) == {"leapfrog_update_nuts"}
    assert hmc.launch_counts()["leapfrog_update"] > 0


def test_nuts_leaf_kernel_matches_plain_version(device):
    """The NUTS leaf kernel (a leaf's close, epilogue, counter and next
    opening in one launch) on the dense 489 metric, a 3081 diagonal and a
    tail of 8 at 3081, at 1, 64, 256 and 257 chains, float32 and float64,
    at an odd, an even and a one-leaf doubling's leaf: the same flags,
    counts, counter and rows as its plain version, each launch twice bit
    for bit, masked chains untouched, a NaN force included (checked
    inside)."""
    from magi_v2_tpu_torch.ops import nuts

    nuts.reset_launch_counts()
    results = chip_smoke.check_nuts_leaf(device, chains=(1, 64, 256, 257))
    assert set(results) == {"nuts_leaf"}
    assert nuts.launch_counts()["nuts_leaf"] > 0


def test_nuts_graph_replay_matches_eager(device):
    """NUTS by replayed CUDA graphs against the eager transition on a small
    SEIR fit, 6 transitions from the same state and noise, bit for bit
    (checked inside)."""
    from magi_v2_tpu_torch.sampler import hmc

    model = _small_seir(device)
    dim = model.mag_I * 3 + 6
    kr = {"inv_mass": np.ones(dim), "tail_inv_mass": np.eye(dim),
          "step_size": np.float32(0.05)}
    hmc.reset_graph_counts()
    chip_smoke.nuts_graph_vs_eager(model, device, kr, transitions=6)
    counts = hmc.graph_counts()
    assert counts["captures"] == 5 and counts["nuts_leaf"] >= 6


def test_unregistered_field_samples_on_card(device):
    """A field with no CUDA functor (FitzHugh-Nagumo) through predict on the
    card, HMC and NUTS, against the CPU; K1's given kernels launch
    (checked inside)."""
    chip_smoke.unregistered_field(device, steps=150, chains=8)


_SMALL = {}


def _small_seir(device):
    """A SEIR fit of 21 observations (N_I = 21) in float32, made once."""
    if "seir" not in _SMALL:
        from magi_v2_tpu_torch import MAGI_v2, MagiConfig
        from magi_v2_tpu_torch.utils.data import simulate_ode

        ts, X, _ = simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                                thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                                n_obs=21, noise_sd=0.005, substeps=20)
        cfg = MagiConfig(dtype=torch.float32, device=str(device),
                         hparam_num_iters=50, init_num_iters=100)
        _SMALL["seir"] = MAGI_v2(3, ts, X, None, seir_f_vec, cfg)
        _SMALL["seir"].initial_fit(1)
    return _SMALL["seir"]


def _small_lorenz(device):
    """A Lorenz fit of 33 observations (N_I = 129), made once."""
    if "model" not in _SMALL:
        import magi_v2_tpu_torch

        config = magi_v2_tpu_torch.MagiConfig
        try:
            magi_v2_tpu_torch.MagiConfig = lambda **kw: config(
                hparam_num_iters=50, init_num_iters=200, **kw)
            _SMALL["model"] = chip_smoke.lorenz_fit(device, n_obs=33)
        finally:
            magi_v2_tpu_torch.MagiConfig = config
    return _SMALL["model"]


def synthetic_factor(device, N=1025, D=3, bw=1200, seed=0):
    """A float64 K4 factor of the Lorenz shapes without a fit: an upper
    band of width ``bw`` over N*D rows with a dominant diagonal."""
    from magi_v2_tpu_torch.ops import banded as bd

    g = torch.Generator(device="cpu").manual_seed(seed)
    ND = N * D
    band = torch.zeros((2 * bw + 1, ND), dtype=torch.float64)
    band[bw] = 1.0 + torch.rand((ND,), generator=g, dtype=torch.float64)
    for k in range(1, bw + 1):
        band[bw + k, : ND - k] = 0.02 / k ** 0.5 * torch.randn(
            (ND - k,), generator=g, dtype=torch.float64)
    tiles = bd.banded_to_blocks_upper(band.to(device))
    return bd.UpperFactor.make(tiles, bd.banded_diag_tile_inverses(tiles, ND),
                               ND)


def synthetic_banded_ops(device, N=1025, D=3, b=100, bw=1200, seed=0):
    """Float64 operators of the Lorenz shapes without a fit: K3 tiles
    {"R", "m", "S"} of random (D, N, N) matrices at half-bandwidth b, and
    the K4 factor of ``synthetic_factor``."""
    from magi_v2_tpu_torch.ops import banded as bd

    g = torch.Generator(device="cpu").manual_seed(seed)
    A = torch.randn((D, N, N), generator=g, dtype=torch.float64).to(device)
    blocks = {k: bd.banded_to_blocks(bd.dense_to_banded(A * s, b))
              for k, s in (("R", 1.0), ("m", 0.3), ("S", 2.0))}
    return blocks, synthetic_factor(device, N, D, bw, seed)


@pytest.mark.parametrize("N,D,b,bw,chains", [
    (1025, 3, 100, 1200, (1, 33, 64, 65, 128, 256, 257)),
    (65, 3, 4, 48, (7,)),
    (300, 1, 40, 0, (1,))])
def test_banded_kernels_match_plain_versions(device, N, D, b, bw, chains):
    """K3 and K4, forward and adjoint, through the banded target's stages
    at the Lorenz shapes and at ragged sizes (a part-filled last tile, a
    diagonal-only factor, one chain). At the Lorenz shapes the chain
    counts cross K4's group sizes (8 chains per cluster up to 120 chains,
    20 above) and fill one cluster partly (1, 33, 65, 257)."""
    from magi_v2_tpu_torch.ops import banded as bd

    blocks, factor = synthetic_banded_ops(device, N, D, b, bw)
    bd.reset_launch_counts()
    results = chip_smoke.check_banded_ops(blocks, factor, N, D, chains,
                                          device)
    assert set(results) == set(bd.KERNELS)
    assert all(n > 0 for n in bd.launch_counts().values())


def test_solve_launches_are_repeatable(device):
    """K4 and its adjoint, 6000 launches each on one input at 257 chains
    (13 clusters of 20 chains, the last part-filled), float64 and float32:
    every result equals the first bit for bit. Without the proxy fence
    ahead of the slab ring's release about one float64 adjoint launch in
    500 differed."""
    out = chip_smoke.solve_repeatability(synthetic_factor(device), 1025, 3,
                                         257, device, runs=6000)
    assert len(out) == 4 and not any(out.values())


def test_unwhiten_solve_matches_plain_version(device):
    """K4 as ``unwhiten_draws`` gives it (C, 1, N*D) right-hand sides, C
    draws x chains: 20 draws x 256 chains in chunks of 4 draws (float32,
    1024 right-hand sides) and 2 draws (float64, 512), each more than one
    wave of clusters."""
    from magi_v2_tpu_torch.ops import banded as bd

    factor = synthetic_factor(device)
    bd.reset_launch_counts()
    errs = chip_smoke.check_unwhiten(factor, 1025, 3, 20, 256, device,
                                     max_bytes=4 * 256 * 3075 * 4)
    assert len(errs[torch.float32]) == 5 and len(errs[torch.float64]) == 10
    assert bd.launch_counts()["banded_solve"] == 15


def test_banded_wrappers_raise_instead_of_falling_back(device):
    from magi_v2_tpu_torch.ops import banded as bd

    blocks, factor = synthetic_banded_ops(device, 65, 3, 4, 48)
    op = bd.BandedMatrix.make(blocks["R"].half())
    x = torch.zeros((2, 3, 65), dtype=torch.float16, device=device)
    with pytest.raises(TypeError, match="float32 or float64"):
        bd.banded_matvec(op, x, torch.empty_like(x))
    y = torch.zeros((2, 1, 195), dtype=torch.float64, device=device)
    with pytest.raises(ValueError, match="expected"):
        bd.banded_solve(factor, y.cpu(), torch.empty_like(y))


def test_refused_solve_launch_raises_and_does_not_fall_back(device,
                                                            monkeypatch):
    """A K4 cluster launch that the card refuses (here: more shared memory
    per CTA than an SM has, with the wrapper's own check lifted) raises:
    x stays unwritten, no launch is counted, and the next launch runs."""
    from magi_v2_tpu_torch.ops import banded as bd

    N, nwu, C = 256, 360, 256
    tiles = torch.zeros((2, nwu, 128, 128), dtype=torch.float64,
                        device=device)
    tiles[:, 0] = 2.0 * torch.eye(128, dtype=torch.float64, device=device)
    factor = bd.UpperFactor.make(tiles, bd.banded_diag_tile_inverses(tiles,
                                                                     N), N)
    # too much even for the smallest chain group
    assert bd._solve_smem(8, nwu, 8) > 232448
    y = torch.ones((C, 1, N), dtype=torch.float64, device=device)
    x = torch.full_like(y, float("nan"))
    monkeypatch.setattr(bd, "_SMEM_LIMIT", 1 << 30)
    bd.reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch of banded_solve failed"):
        bd.banded_solve(factor, y, x)
    torch.cuda.synchronize()
    assert torch.isnan(x).all()
    assert bd.launch_counts()["banded_solve"] == 0
    _, small = synthetic_banded_ops(device, 65, 3, 4, 48)
    y = torch.ones((C, 3, 65), dtype=torch.float64, device=device)
    x = bd.banded_solve(small, y, torch.empty_like(y))
    ref = bd.banded_solve_plain(small, y, torch.empty_like(y))
    assert torch.allclose(x, ref, rtol=0, atol=1e-12)
    assert bd.launch_counts()["banded_solve"] == 1


def test_large_grid_targets_on_card_match_cpu(device):
    """The composed float64 hybrid and banded targets (K1-Lorenz, K3, K4)
    on the card against the same targets on the CPU, on a small Lorenz
    fit."""
    import magi_v2_tpu_torch

    config = magi_v2_tpu_torch.MagiConfig
    try:
        magi_v2_tpu_torch.MagiConfig = lambda **kw: config(
            hparam_num_iters=50, init_num_iters=200, **kw)
        model = chip_smoke.lorenz_fit(device, n_obs=33)
    finally:
        magi_v2_tpu_torch.MagiConfig = config
    tail = (-1.5, -1.5, -1.5, 10.0, 28.0, 2.6)
    for storage in ("hybrid", "banded"):
        chip_smoke.check_composed(model, device, storage, tail=tail)
    # through the workspace on the card: what a call returned is not
    # touched by the next call
    for storage in ("dense", "hybrid", "banded"):
        mode, _, _ = model._build_sampling_setup("precond", storage,
                                                 torch.float32)
        q0 = torch.cat([mode.X0.reshape(-1).float(),
                        torch.tensor(tail, device=device)])
        g = torch.Generator(device=device).manual_seed(2)
        qs = q0 + 0.05 * torch.randn((10, q0.numel()), generator=g,
                                     device=device)
        bt = torch.tensor(0.4, device=device)
        lp1, g1 = mode.logp_grad(qs[:5], bt)
        keep = lp1.clone(), g1.clone()
        lp2, g2 = mode.logp_grad(qs[5:], bt)
        lp1b, g1b = mode.logp_grad(qs[:5], bt)
        torch.cuda.synchronize()
        assert torch.equal(lp1, keep[0]) and torch.equal(g1, keep[1])
        assert torch.equal(lp1b, lp1) and torch.equal(g1b, g1)
        assert not torch.equal(lp1, lp2)


def test_gn_precision_band_on_card_matches_cpu(device):
    """The banded GN precision assembled from card tensors (float64 GEMMs
    on the card) against the same band built on the CPU, at the Lorenz
    dense grid's shapes; a traced hybrid predict counts the one band it
    assembled on the card."""
    from magi_v2_tpu_torch.sampler.precond import gauss_newton_precision_band

    args, kw = chip_smoke.gn_band_inputs()
    cpu = gauss_newton_precision_band(*args, **kw)
    on_card = lambda a: (torch.as_tensor(a, device=device)
                         if isinstance(a, np.ndarray) else a)
    card = gauss_newton_precision_band(
        *(on_card(a) for a in args), **{k: on_card(v) for k, v in kw.items()})
    assert card.dtype == np.float64
    np.testing.assert_allclose(card, cpu, rtol=0,
                               atol=1e-12 * np.abs(cpu).max())

    res = _small_lorenz(device).predict(
        num_results=2, num_burnin_steps=2, num_chains=4, seed=0,
        algorithm="hmc", hmc_num_leapfrogs=4, storage="hybrid",
        sigma_sqs_fixed=0.25, mass_matrix="diag", profile_timings=True)
    assert res["timings"]["trace"]["counts"]["gn_precision_on_card"] == 1

"""Generate golden parity data by RUNNING the reference SpinRelax code
(/root/reference) on synthetic inputs.

The goldens stored in tests/golden/ are *outputs* of the reference
implementation — used to verify that this rebuild matches the
reference numerics to <=1e-6 (BASELINE.md parity target).  The reference
is executed with small shims (tools/refshim) standing in for its compiled
npufunc and the pip transforms3d dependency.

Usage:  python tools/make_golden.py
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF = "/root/reference"
GOLD = os.path.join(REPO, "tests", "golden")

# refshim FIRST (the documented PYTHONPATH=tools/refshim:/root/reference
# precedence): its shadowing modules must win over same-named reference
# files for the numpy-2 compatibility patches to take effect.
sys.path.insert(0, REF)
sys.path.insert(0, os.path.join(HERE, "refshim"))

import numpy as np  # noqa: E402

rng = np.random.default_rng(1234)


def unit_vecs(shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def main():
    os.makedirs(GOLD, exist_ok=True)
    import spectral_densities as sd  # reference module
    import fitting_Ct_functions as fitCt  # reference module

    # ----------------------------------------------------------------- #
    # 1. J(omega) kernels                                               #
    # ----------------------------------------------------------------- #
    # relaxationModel(bondType, B0): use 600.133 MHz -> B0 in Tesla
    B0 = 2.0 * np.pi * 600.133e6 / 267.513e6
    robj = sd.relaxationModel("NH", B0)
    robj.set_time_unit("ps")
    omega = np.array(robj.omega)  # 5 frequencies in rad/ps

    n_res, n_samp, n_k = 7, 11, 3
    v = unit_vecs((n_res, n_samp))
    S2 = rng.uniform(0.5, 0.95, size=n_res)
    consts = rng.uniform(0.01, 0.2, size=(n_res, n_k))
    taus = rng.uniform(5.0, 2000.0, size=(n_res, n_k))
    tau_iso = 4242.0  # ps
    Diso = 1.0 / (6.0 * tau_iso)
    aniso = 1.6
    Dperp = 3.0 * Diso / (2.0 + aniso)
    Dpar = aniso * Dperp

    J_iso = np.stack(
        [
            sd.J_combine_isotropic_exp_decayN(omega, tau_iso, S2[i], consts[i], taus[i])
            for i in range(n_res)
        ]
    )
    J_symm = np.stack(
        [
            sd.J_combine_symmtop_exp_decayN(
                omega, v[i], Dpar, Dperp, S2[i], consts[i], taus[i]
            )
            for i in range(n_res)
        ]
    )  # (nRes, nSamp, 5)

    # oblate case (aniso < 1 -> unique axis x)
    aniso_o = 0.6
    Dperp_o = 3.0 * Diso / (2.0 + aniso_o)
    Dpar_o = aniso_o * Dperp_o
    J_symm_oblate = np.stack(
        [
            sd.J_combine_symmtop_exp_decayN(
                omega, v[i], Dpar_o, Dperp_o, S2[i], consts[i], taus[i]
            )
            for i in range(n_res)
        ]
    )

    D3 = np.sort(rng.uniform(1e-5, 5e-5, size=3))
    # NOTE: the reference's J_combine_ellipsoid_exp_decayN
    # (spectral_densities.py:2105) collapses its transient terms with an
    # axis-less np.sum — a scalar — which is a latent bug in a path the
    # workflow never exercises (SURVEY §2.7).  The golden here applies the
    # reference's own _do_Jsum per component and sums them correctly,
    # i.e. the *intended* behaviour.
    DJ5_, delta_ = sd.D_coefficients_ellipsoid(D3, True)
    J_ell = []
    for i in range(n_res):
        AJ5_ = sd.A_coefficients_ellipsoid(v[i, 0], delta_, True)
        Jacc = sd._do_Jsum(omega, S2[i] * AJ5_, DJ5_)
        for k in range(n_k):
            Jacc = Jacc + sd._do_Jsum(omega, consts[i, k] * AJ5_, DJ5_ + 1.0 / taus[i, k])
        J_ell.append(Jacc)
    J_ell = np.stack(J_ell)

    J_direct = np.stack(
        [sd.J_direct_transform(omega, consts[i], taus[i]) for i in range(n_res)]
    )

    # ----------------------------------------------------------------- #
    # 2. Relaxation rates via the legacy relaxationModel                #
    # ----------------------------------------------------------------- #
    robj.set_rotdif_model("rigid_symmtop_D", Dpar, Dperp)
    R1 = np.zeros((n_res, n_samp))
    R2 = np.zeros((n_res, n_samp))
    NOE = np.zeros((n_res, n_samp))
    rho = np.zeros((n_res, n_samp))
    for i in range(n_res):
        Jmat = sd.J_combine_symmtop_exp_decayN(
            omega, v[i], Dpar, Dperp, S2[i], consts[i], taus[i]
        )
        r1, r2, noe = robj.get_relax_from_J_simd(Jmat)
        R1[i], R2[i], NOE[i] = r1, r2, noe
        rho[i] = robj.get_rho_from_J_simd(Jmat)

    # CSA-array variant
    csa_arr = rng.uniform(-200e-6, -120e-6, size=n_res)
    R1csa = np.zeros((n_res, n_samp))
    for i in range(n_res):
        Jmat = sd.J_combine_symmtop_exp_decayN(
            omega, v[i], Dpar, Dperp, S2[i], consts[i], taus[i]
        )
        r1, _, _ = robj.get_relax_from_J_simd(Jmat, CSAvalue=csa_arr[i])
        R1csa[i] = r1

    # rho from experimental rates
    rho_exp = np.array(
        [
            robj.calculate_rho_from_relaxation([R1[i, 0], R2[i, 0], NOE[i, 0]])
            for i in range(n_res)
        ]
    )

    np.savez(
        os.path.join(GOLD, "jomega_relax.npz"),
        omega=omega,
        B0=B0,
        vecs=v,
        S2=S2,
        consts=consts,
        taus=taus,
        tau_iso=tau_iso,
        Dpar=Dpar,
        Dperp=Dperp,
        Dpar_oblate=Dpar_o,
        Dperp_oblate=Dperp_o,
        D_ellipsoid=D3,
        J_iso=J_iso,
        J_symm=J_symm,
        J_symm_oblate=J_symm_oblate,
        J_ell=J_ell,
        J_direct=J_direct,
        R1=R1,
        R2=R2,
        NOE=NOE,
        rho=rho,
        csa_arr=csa_arr,
        R1csa=R1csa,
        rho_exp=rho_exp,
        f_DD=robj._get_f_DD(),
        f_CSA=robj._get_f_CSA(),
        gamma_H=robj.gH.gamma,
        gamma_X=robj.gX.gamma,
    )
    print("wrote jomega_relax.npz")

    # ----------------------------------------------------------------- #
    # 3. New-API spinRelaxation classes (weighted vector ensembles)     #
    # ----------------------------------------------------------------- #
    grd = sd.globalRotationalDiffusion_Axisymmetric(D=[Diso, aniso])
    weights = rng.uniform(0.0, 3.0, size=(n_res, n_samp))
    grd.bVecs = True
    grd.vecNames = np.arange(2, 2 + n_res)
    grd.vecXH = np.swapaxes(unit_vecs((n_res, n_samp)), 0, 1)
    grd.vecWeights = np.swapaxes(weights, 0, 1)
    grd.axisAvg = 0
    grd.update_A_coefficients()

    ac = fitCt.autoCorrelations()
    for i in range(n_res):
        ac.add_model(
            str(i + 2), listC=list(consts[i] / 2.0), listTau=list(taus[i]),
            S2=S2[i], bS2Fast=True,
        )
    zeta = 0.890023
    ac.set_zeta(zeta)

    wobj = sd.angularFrequencies(fieldStrength=600.133)
    wobj.set_time_unit("ps")
    spR1 = sd.spinRelaxationR1("R1", timeUnit="ps", angFreq=wobj, globalRotDif=grd, localCtModels=ac)
    spR2 = sd.spinRelaxationR2("R2", timeUnit="ps", angFreq=wobj, globalRotDif=grd, localCtModels=ac)
    spNOE = sd.spinRelaxationNOE("NOE", timeUnit="ps", angFreq=wobj, globalRotDif=grd, localCtModels=ac)
    v1 = spR1.eval()
    v2 = spR2.eval()
    v3 = spNOE.eval()
    np.savez(
        os.path.join(GOLD, "newapi_relax.npz"),
        Diso=Diso,
        aniso=aniso,
        vecs=np.swapaxes(grd.vecXH, 0, 1),
        weights=weights,
        S2=S2,
        consts=consts / 2.0,
        taus=taus,
        zeta=zeta,
        R1=np.asarray(spR1.values),
        R1err=np.asarray(spR1.errors),
        R2=np.asarray(spR2.values),
        R2err=np.asarray(spR2.errors),
        NOE=np.asarray(spNOE.values),
        NOEerr=np.asarray(spNOE.errors),
    )
    print("wrote newapi_relax.npz")

    # ----------------------------------------------------------------- #
    # 4. C(t) multi-exponential model evaluation                        #
    # ----------------------------------------------------------------- #
    dt = np.arange(1, 501, dtype=float) * 4.0
    curves = np.stack([ac.model[k].eval(dt) for k in ac.model])
    np.savez(
        os.path.join(GOLD, "ctmodel_eval.npz"),
        dt=dt,
        S2=S2,
        consts=consts / 2.0,
        taus=taus,
        zeta=zeta,
        curves=curves,
    )
    print("wrote ctmodel_eval.npz")

    # ----------------------------------------------------------------- #
    # 5. A/D coefficients                                               #
    # ----------------------------------------------------------------- #
    AJ_pro = sd.A_coefficients_symmtop(v, bProlate=True)
    AJ_obl = sd.A_coefficients_symmtop(v, bProlate=False)
    DJ = sd.D_coefficients_symmtop((Dpar, Dperp))
    DJ5, delta = sd.D_coefficients_ellipsoid(D3, True)
    AJ5 = np.stack([sd.A_coefficients_ellipsoid(v[i, 0], delta, True) for i in range(n_res)])
    np.savez(
        os.path.join(GOLD, "ad_coeffs.npz"),
        vecs=v,
        Dpar=Dpar,
        Dperp=Dperp,
        D3=D3,
        AJ_pro=AJ_pro,
        AJ_obl=AJ_obl,
        DJ=DJ,
        DJ5=DJ5,
        delta=np.asarray(delta),
        AJ5=AJ5,
    )
    print("wrote ad_coeffs.npz")


if __name__ == "__main__":
    main()

"""Quickstart of the port, the counterpart of examples/quickstart.py: the same
steps in the same order, on float64 tensors on the CUDA card (or the CPU).

    python -m cosmoprimo_tpu_torch.quickstart [--device cpu] [--plot OUTDIR]

Covered: Cosmology construction, clone, fiducials and files; background
distances and the thermodynamics shortcut; engines through the Fourier
section getter; P(k) interpolators and sigma8; FFTLog pk -> xi (the CUDA
kernel on the card); the BAO filters; halofit, HMcode-2020 and
mead2020_feedback; solving h for theta_MC; the batched pipeline over 64
cosmologies; and a forward-mode Jacobian through ``torch.func``. The
example's native-engine step is left out: chip_smoke.py runs that engine.

:func:`main` returns the numbers it printed and its tables, as numpy, by
name; :data:`BARS` is each one's bar when a run on the card is held to a
run on the CPU (of its max, PERF.md section 2).
"""

import argparse
import os
import tempfile

import numpy as np
import torch

THETA_MC_100 = 1.04092

#: Card against CPU, each output's max abs difference over its max abs value:
#: P(k), xi, the solved h and the Jacobian 1e-10; distances, sigma8 and
#: rs_drag 1e-11.
BARS = {name: 1e-10 for name in ('pk', 'pk_nowiggle', 'pk_bbks', 'xi', 'xi_fftlog', 'pknow', 'xinow', 'pk_halofit',
                                 'pk_mead', 'pk_feedback', 'h_solved', 'xi_batched', 'dchi_domega_cdm')}
BARS.update({name: 1e-11 for name in ('chi', 'chi_z1', 'age', 'rs_drag', 'z_drag', 'sigma8', 'chi_batched',
                                      'sigma8_batched')})


def _numpy(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--device', default='cuda', help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--plot', default=None, metavar='OUTDIR',
                        help='write PNG figures to this directory (needs matplotlib)')
    args = parser.parse_args(argv)

    from . import fiducial
    from .bao_filter import CorrelationFunctionBAOFilter, PowerSpectrumBAOFilter
    from .cosmology import Cosmology, Fourier
    from .fftlog import PowerToCorrelation
    from .pipelines import make_pk_to_xi_pipeline_batched
    from .utils import savefig

    device = torch.device(args.device)
    results = {}

    def keep(name, value):
        results[name] = _numpy(value)
        return results[name]

    def figure(name, draw):
        if not args.plot:
            return
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig = plt.figure()
        draw(plt)
        savefig(os.path.join(args.plot, name), fig=fig, dpi=110)

    # ---- Cosmology: defaults, custom parameters, clone -------------------
    cosmo = Cosmology(engine='eisenstein_hu', device=device)
    cosmo_custom = Cosmology(omega_cdm=0.2, sigma8=0.7, engine='eisenstein_hu', device=device)
    print('h:', float(cosmo['h']), '| Omega_cdm (custom):', float(cosmo_custom['Omega_cdm']))
    cosmo_cloned = cosmo_custom.clone(sigma8=1.0)
    assert float(cosmo_cloned['sigma8']) == 1.0

    # ---- Fiducial cosmologies --------------------------------------------
    desi = fiducial.DESI(engine='eisenstein_hu', device=device)
    planck = fiducial.Planck2018FullFlatLCDM(engine='eisenstein_hu', device=device)
    abacus = fiducial.AbacusSummit(0, engine='eisenstein_hu', device=device)
    print('DESI h =', float(desi['h']), '| Planck2018 h =', float(planck['h']),
          '| AbacusSummit(0) == DESI:', float(abacus['h']) == float(desi['h']))

    # ---- Save / load ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, 'cosmo.npy')
        desi.write(fn)
        desi2 = Cosmology.read(fn, device=device)
        assert float(desi2['omega_cdm']) == float(desi['omega_cdm'])

    # ---- Background -------------------------------------------------------
    ba = desi.get_background()
    z = np.linspace(0.0, 10.0, 501)[1:]
    chi = keep('chi', ba.comoving_radial_distance(z))
    chi1 = keep('chi_z1', ba.comoving_radial_distance(np.array([1.0])))[0]
    print('chi(z=1) = %.2f Mpc/h | age = %.3f Gy' % (chi1, keep('age', ba.age)))
    figure('background.png', lambda plt: (
        plt.plot(z, chi, label='radial'),
        plt.plot(z, _numpy(ba.luminosity_distance(z)), label='luminosity'),
        plt.xlabel('$z$'), plt.ylabel('distance [Mpc/$h$]'), plt.legend()))

    # ---- Thermodynamics shortcut ------------------------------------------
    print('rs_drag = %.3f Mpc/h, z_drag = %.1f' % (keep('rs_drag', desi.rs_drag),
                                                     keep('z_drag', desi.get_thermodynamics().z_drag)))

    # ---- Fourier: P(k) interpolators, engine comparison -------------------
    k = np.geomspace(1e-3, 1e2, 512)
    pk = desi.get_fourier().pk_interpolator()
    # Fourier(cosmo, engine=...) switches the cosmology's engine (the
    # reference's semantics too): compare approximations on clones
    pk_nw = Fourier(desi.clone(), engine='eisenstein_hu_nowiggle').pk_interpolator()
    pk_bbks = Fourier(desi.clone(), engine='bbks').pk_interpolator()
    keep('pk', pk(k, 0.0))
    keep('pk_nowiggle', pk_nw(k, 0.0))
    keep('pk_bbks', pk_bbks(k, 0.0))
    print('P(k=0.1, z=0) =', float(_numpy(pk(np.array([0.1]), 0.0))[0]), '(Mpc/h)^3')
    print('sigma8 =', float(keep('sigma8', pk.sigma8_z(0.0))))
    figure('pk_engines.png', lambda plt: (
        plt.loglog(k, results['pk'], label='EH1998'),
        plt.loglog(k, results['pk_nowiggle'], label='EH1998 no wiggle'),
        plt.loglog(k, results['pk_bbks'], label='BBKS'),
        plt.xlabel('$k$ [$h$/Mpc]'), plt.ylabel('$P(k)$'), plt.legend()))

    # ---- FFTLog: pk -> xi and the explicit transform ----------------------
    xi = pk.to_xi()
    s = np.geomspace(1e-2, 300.0, 500)
    pk1d = pk.to_1d(z=0.0)
    kk = np.geomspace(float(pk1d.extrap_kmin) * 1.0001, float(pk1d.extrap_kmax) * 0.9999, 1024)
    s1d, xi1d = PowerToCorrelation(kk, ell=0)(pk1d(kk))
    keep('xi', xi(s, 0.0))
    keep('xi_fftlog', xi1d)
    print('xi(s=100, z=0) =', float(_numpy(xi(np.array([100.0]), 0.0))[0]))
    figure('xi.png', lambda plt: (
        plt.plot(s, s ** 2 * results['xi'], label='interpolator.to_xi'),
        plt.plot(_numpy(s1d), _numpy(s1d) ** 2 * results['xi_fftlog'], '--', label='PowerToCorrelation'),
        plt.xlim(0, 200), plt.xlabel('$s$ [Mpc/$h$]'), plt.ylabel(r'$s^2 \xi(s)$'), plt.legend()))

    # ---- BAO filters ------------------------------------------------------
    pknow = PowerSpectrumBAOFilter(pk.to_1d(z=0.0), engine='wallish2018', cosmo=desi).smooth_pk_interpolator()
    xinow = CorrelationFunctionBAOFilter(xi.to_1d(z=0.0), engine='kirkby2013', cosmo=desi).smooth_xi_interpolator()
    keep('pknow', pknow(k))
    print('wiggle amplitude at k=0.1:', float(_numpy(pk1d(np.array([0.1])) / pknow(np.array([0.1])))[0]) - 1.0)
    figure('bao_filter.png', lambda plt: (
        plt.semilogx(k, _numpy(pk1d(k)) / results['pknow']),
        plt.xlabel('$k$ [$h$/Mpc]'), plt.ylabel('$P / P_{\\rm now}$')))
    assert np.isfinite(keep('xinow', xinow(s))).all()

    # ---- Native non-linear spectra ----------------------------------------
    fo = desi.get_fourier()
    pk_hf = fo.pk_interpolator(non_linear='halofit')
    pk_hm = fo.pk_interpolator(non_linear='mead')
    pk_fb = fo.pk_interpolator(non_linear='mead2020_feedback')
    k_nl = np.geomspace(1e-2, 20.0, 200)
    keep('pk_halofit', pk_hf(k_nl, 0.0))
    keep('pk_mead', pk_hm(k_nl, 0.0))
    keep('pk_feedback', pk_fb(k_nl, 0.0))
    print('halofit boost at k=1:', float(_numpy(pk_hf(np.array([1.0]), 0.0) / pk(np.array([1.0]), 0.0))[0]))
    print('feedback suppression at k=3:',
          float(_numpy(pk_fb(np.array([3.0]), 0.0) / pk_hm(np.array([3.0]), 0.0))[0]))
    figure('nonlinear.png', lambda plt: (
        plt.loglog(k_nl, _numpy(pk(k_nl, 0.0)), label='linear'),
        plt.loglog(k_nl, results['pk_halofit'], label='halofit (Takahashi)'),
        plt.loglog(k_nl, results['pk_mead'], label='HMcode-2020'),
        plt.loglog(k_nl, results['pk_feedback'], '--', label='HMcode-2020 + $T_{\\rm AGN}$'),
        plt.xlabel('$k$ [$h$/Mpc]'), plt.ylabel('$P(k)$'), plt.legend()))

    # ---- Solve: match an observable ---------------------------------------
    solved = desi.solve('h', 'theta_MC_100', THETA_MC_100)
    print('solved h(theta_MC_100 = %.5f) =' % THETA_MC_100, float(keep('h_solved', solved['h'])))
    results['theta_MC_100_solved'] = _numpy(solved['theta_MC_100'])
    assert abs(float(results['theta_MC_100_solved']) - THETA_MC_100) < 1e-6

    # ---- The port's point: batched, on the card, differentiable -----------
    fn, kgrid, sgrid = make_pk_to_xi_pipeline_batched(nk=512)
    n = 64
    rng = np.random.default_rng(0)
    draws = [rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
             rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n)]
    xi_b, chi_b, s8_b = fn(*(torch.from_numpy(d).to(device) for d in draws))
    keep('xi_batched', xi_b)
    keep('chi_batched', chi_b)
    s8_b = keep('sigma8_batched', s8_b)
    print(f'batched pipeline: xi{tuple(xi_b.shape)}, sigma8 in [{s8_b.min():.3f}, {s8_b.max():.3f}] over {n} '
          'cosmologies')

    zq = torch.linspace(0.1, 2.0, 20, dtype=torch.float64, device=device)

    def distances(omega_cdm):
        c = Cosmology(omega_cdm=omega_cdm, omega_b=0.02237, h=0.6736, engine='eisenstein_hu', device=device)
        return c.get_background().comoving_radial_distance(zq)

    dchi = keep('dchi_domega_cdm', torch.func.jacfwd(distances)(torch.tensor(0.12, dtype=torch.float64,
                                                                              device=device)))
    print('d chi / d omega_cdm at z=2:', float(dchi[-1]), '(forward mode through torch.func)')
    print('quickstart: all sections ran.')
    return results


if __name__ == '__main__':
    main()

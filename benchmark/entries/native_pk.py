"""The ``native_pk`` call: one chunk of the 'native-base' emulator recipe's
Fourier sampling, as its sampler makes it. The calculator of
``emulators.get_calculator`` over the DESI fiducial with the native
Einstein-Boltzmann engine (built once, in set-up) is called with the
chunk's parameters; it clones the fiducial per row (a massive neutrino per
row), builds the background, the recombination history, the primordial
spectrum and the Fourier section, and returns their states. The call's
outputs are read from that state: the P(k, z) tables of delta_m and
delta_cb on the emulator's (k, z) grid, each row flattened k major, and
rs_drag, z_drag and z_star."""

OUTPUTS = {'pk_m': 'fourier.pk.delta_m.delta_m', 'pk_cb': 'fourier.pk.delta_cb.delta_cb',
           'rs_drag': 'thermodynamics.rs_drag', 'z_drag': 'thermodynamics.z_drag',
           'z_star': 'thermodynamics.z_star'}


class Entry:

    def __init__(self, config, device):
        from cosmoprimo_tpu_torch.emulators import get_calculator
        from cosmoprimo_tpu_torch.fiducial import DESI
        extra = {'nk_pk': config['nk_pk']}
        if 'n_steps' in config:          # a cut step budget, for the CPU tests
            extra['n_steps_pk'] = tuple(config['n_steps'])
        fiducial = DESI(engine='native', kmax_pk=config['kmax_pk'], extra_params=extra, device=device)
        self.calculator = get_calculator(fiducial, section=config['sections'])

    def call(self, batch):
        state = self.calculator(**batch)
        rows = state['thermodynamics.z_star'].shape[0]
        return {name: state[key].reshape(rows, -1) if name.startswith('pk') else state[key]
                for name, key in OUTPUTS.items()}

    def spans(self, batch):
        """No re-call of a layer: the traced run reads the program's spans."""
        return {}

    def counters(self, batch):
        return {}


def build(config, device):
    return Entry(config, device)

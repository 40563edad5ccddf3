"""sisr_tpu_torch's serving export on the CPU: EDSR with float32 and uint8 input, Q-RCAN
with its metadata, SRMD with its channel concat, and the int8 programs of EDSR and
RCAN, each exported with ``torch.export`` through the custom ops' CPU implementation,
saved, loaded back and run: equal to the live forward within 1e-6, every channel
attention call one ``sisr::ca`` or ``sisr::ca_res`` node and every int8 conv one
``sisr::conv_int8_static`` node, the manifest with sisr_tpu's fields and the custom
ops.  ``torch.library.opcheck`` on the three ops; an eager CA call goes straight to the
launcher."""
import json
import os

import numpy as np
import pytest
import torch

from sisr_tpu.tools.e2e_bench import build_workload
from sisr_tpu_torch.models.handlers import define_model
from sisr_tpu_torch.ops import channel_attention as ca, quantization as qz
from sisr_tpu_torch.tools import export_serving as es
from sisr_tpu_torch.utils import toml_io

# case -> (model, structure, int8, uint8 input, custom-op calls of the program: the CA
# ops, and in int8 every conv one sisr::conv_int8_static)
CASES = {
    'edsr_f32': ('edsr', {'num_features': 16, 'num_blocks': 2}, False, False, {}),
    'edsr_uint8': ('edsr', {'num_features': 16, 'num_blocks': 2}, False, True, {}),
    'qrcan_meta': ('qrcan', {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16,
                             'reduction': 4, 'style': 'max_concat', 'include_q_layer': True,
                             'metadata': ['blur_kernel']}, False, False,
                   {'sisr.ca.default': 4}),
    'srmd_concat': ('srmd', {'nc': 16, 'nb': 4, 'metadata': ['blur_kernel']}, False, False,
                    {}),
    'edsr_int8': ('edsr', {'num_features': 16, 'num_blocks': 2}, True, False,
                  {'sisr.conv_int8_static.default': 8}),
    'rcan_int8': ('rcan', {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 16,
                           'reduction': 4}, True, False,
                  {'sisr.ca_res.default': 4, 'sisr.conv_int8_static.default': 14}),
}


@pytest.fixture(scope='module')
def experiments(tmp_path_factory):
    """One experiment per model of CASES (seed 3, scale 2) and 4 LR images of 12^2 with
    their blur-kernel metadata (the int8 calibration set)."""
    root = str(tmp_path_factory.mktemp('export'))
    lr_dir, _ = build_workload(os.path.join(root, 'data'), 4, lr_size=12, scale=2,
                               metadata_cols=10)
    for case, (model, internal, *_) in CASES.items():
        base = os.path.join(root, case)
        os.makedirs(os.path.join(base, 'saved_models'))
        internal = {'scale': 2, **internal}
        toml_io.dump({'model': {'name': model, 'internal_params': internal}},
                     os.path.join(base, 'config.toml'))
        handler = define_model(model, device='cpu', seed=3, **internal)
        handler.save_model('train_model', 0, os.path.join(base, 'saved_models'))
    return root, lr_dir


@pytest.mark.parametrize('case', sorted(CASES))
def test_exported_program_matches_the_live_forward(experiments, case, tmp_path):
    root, lr_dir = experiments
    model, _, int8, uint8, ops = CASES[case]
    path = es.export_experiment(root, case, 0, 2, 12, 12, out_path=str(tmp_path / 'p.pt2'),
                                uint8_input=uint8, int8=int8,
                                calibration_images=lr_dir if int8 else None, device='cpu')
    with open(path + '.json') as f:
        manifest = json.load(f)
    meta_model = model in ('qrcan', 'srmd')
    assert manifest['format'] == es.MANIFEST_FORMAT and manifest['model'] == model
    assert manifest['custom_ops'] == {
        'namespace': 'sisr', 'calls': ops, 'modules': ['sisr_tpu_torch.ops.channel_attention',
                                                       'sisr_tpu_torch.ops.quantization']}
    assert (manifest['batch_size'], manifest['height'], manifest['width'], manifest['scale'],
            manifest['int8'], manifest['input_dtype'], manifest['platforms']) == \
        (2, 12, 12, 2, int8, 'uint8' if uint8 else 'float32', ['cpu'])
    assert manifest['metadata_keys'] == (['blur_kernel'] * 10 if meta_model else None)
    program = es.load_exported(path)
    assert es.custom_op_calls(program) == ops
    live = es.load_for_export(root, case, 0, int8=int8,
                              calibration_images=lr_dir if int8 else None, device='cpu')
    eager = (es.Int8ServingProgram if int8 else es.ServingProgram)(live.model).eval()
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(2, 12, 12, 3).astype(np.float32))
    if uint8:
        x = torch.round(x * 255).to(torch.uint8)
    args = (x,) + ((torch.from_numpy(rng.rand(2, 10).astype(np.float32)),)
                   if meta_model else ())
    with torch.inference_mode():
        served, want = program.module()(*args), eager(*args)
    assert served.shape == (2, 24, 24, 3) and served.dtype == torch.float32
    torch.testing.assert_close(served, want, atol=1e-6, rtol=0)


def test_export_refuses_what_sisr_tpu_refuses(experiments, tmp_path, monkeypatch):
    root, lr_dir = experiments
    with pytest.raises(RuntimeError, match='calibration_images'):
        es.export_experiment(root, 'rcan_int8', 0, 1, 12, 12, int8=True, device='cpu')
    with pytest.raises(RuntimeError, match='expansion mismatch'):
        es.export_experiment(root, 'qrcan_meta', 0, 1, 12, 12, metadata_keys=['qpi'],
                             device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):  # the card is the default
        es.export_experiment(root, 'edsr_f32', 0, 1, 12, 12)
    calib = tmp_path / 'calib'
    calib.mkdir()
    for name in sorted(os.listdir(lr_dir))[:2]:
        if name.endswith('.png'):
            os.link(os.path.join(lr_dir, name), calib / name)
    with pytest.raises(RuntimeError, match='degradation_metadata.csv'):
        es.export_experiment(root, 'qrcan_meta', 0, 1, 12, 12, int8=True,
                             calibration_images=str(calib), device='cpu')
    (calib / 'degradation_metadata.csv').write_text(
        'image,qpi\n' + ''.join('%s,%d\n' % (n, 20 + i)
                                for i, n in enumerate(sorted(os.listdir(calib)))
                                if n.endswith('.png')))
    with pytest.raises(RuntimeError, match='do not match the model'):
        es.export_experiment(root, 'qrcan_meta', 0, 1, 12, 12, int8=True,
                             calibration_images=str(calib), device='cpu')


def _ca_args(meta):
    rng = np.random.RandomState(5)
    t = lambda *shape: torch.from_numpy(rng.rand(*shape).astype(np.float32))  # noqa: E731
    m = 3 if meta else 0
    return (t(2, 5, 6, 16), t(16 + m, 4), t(4), t(4, 16), t(16),
            t(2, m) if meta else None, t(2, 16) if meta else None)


@pytest.mark.parametrize('meta', [False, True])
def test_opcheck_the_custom_ops(meta):
    x, w1, b1, w2, b2, m, gate = _ca_args(meta)
    torch.library.opcheck(torch.ops.sisr.ca.default,
                          (x, w1, b1, w2, b2, m, gate, [4, 5] if not meta else None))
    torch.library.opcheck(torch.ops.sisr.ca_res.default,
                          (x, x.bfloat16(), w1, b1, w2, b2, m, gate, meta))
    rng = np.random.RandomState(6)
    kernel = torch.from_numpy(rng.randint(-127, 128, (3, 3, 16, 24)).astype(np.int8))
    matrix = qz.pack_kernel_matrix(kernel)
    w_scale = torch.from_numpy(rng.rand(24).astype(np.float32) / 100)
    bias = torch.from_numpy(rng.rand(24).astype(np.float32)) if meta else None
    for packed in (matrix, None):
        args = (x, kernel, w_scale, torch.tensor(0.01), bias, packed)
        torch.library.opcheck(torch.ops.sisr.conv_int8_static.default, args)
        torch.testing.assert_close(torch.ops.sisr.conv_int8_static(*args),
                                   qz.conv_int8_static(x, kernel, w_scale,
                                                       torch.tensor(0.01), bias, matrix),
                                   atol=0, rtol=0)


def test_eager_calls_take_the_op_only_when_asked(monkeypatch):
    """An eager call goes straight to the launcher, and only a traced one (here the
    op called as a traced program calls it) goes through the op; both give the plain
    version's result (the op's CPU implementation)."""
    x, w1, b1, w2, b2, m, gate = _ca_args(True)
    seen = []
    real = ca._ca_forward
    monkeypatch.setattr(ca, '_ca_forward', lambda *a: seen.append('launcher') or real(*a))
    want = ca.reference_channel_attention(x, w1, b1, w2, b2, m, gate)
    torch.testing.assert_close(ca.fused_channel_attention(x, w1, b1, w2, b2, m, gate),
                               want, atol=0, rtol=0)
    torch.testing.assert_close(torch.ops.sisr.ca(x, w1, b1, w2, b2, m, gate, None),
                               want, atol=0, rtol=0)
    assert seen == ['launcher']  # the op's CPU implementation is the plain version

"""The fine-sampling NeRF configuration as a plain dict:
``options/nerf_llff_repr.yaml`` (the NeRF-paper reproduction settings on
LLFF: 64 coarse + 128 fine samples, relu density, density noise, two 8x256
fields) resolved through its ``_parent_`` chain with ``--model=nerf``.

It lets the port run that model without a YAML parser;
tests/test_torch_nerf_system.py checks that it equals what the YAML loader
resolves. Use ``nerf_llff_repr_options()`` for a fresh, mutable DotDict.
"""

import copy

from .dotdict import DotDict

NERF_LLFF_REPR = {   'group': '0_test',
    'name': 'debug',
    'model': 'nerf',
    'yaml': 'nerf_llff_repr',
    'seed': 0,
    'gpu': 0,
    'cpu': False,
    'load': None,
    'arch': {   'layers_feat': [None, 256, 256, 256, 256, 256, 256, 256, 256],
                'layers_rgb': [None, 128, 3],
                'skip': [4],
                'posenc': {'L_3D': 10, 'L_view': 4},
                'density_activ': 'relu',
                'tf_init': True},
    'data': {   'root': None,
                'dataset': 'llff',
                'image_size': [480, 640],
                'num_workers': 4,
                'preload': True,
                'augment': {},
                'center_crop': None,
                'val_on_test': False,
                'train_sub': None,
                'val_sub': None,
                'llffhold': 8,
                'scene': 'fern',
                'val_ratio': 0.1},
    'loss_weight': {'render': 0, 'render_fine': 0},
    'optim': {   'lr': 0.0005,
                 'lr_end': 5e-05,
                 'algo': 'Adam',
                 'sched': {'type': 'ExponentialLR', 'gamma': None},
                 'clip_norm': None,
                 'clip_norm_pose': None},
    'batch_size': None,
    'max_epoch': None,
    'resume': False,
    'output_root': 'output',
    'tb': {'num_images': [4, 8]},
    'visdom': {'server': 'localhost', 'port': 9000},
    'freq': {'scalar': 200, 'vis': 1000, 'val': 2000, 'ckpt': 5000},
    'tpu': {   'fused_kernel': True,
               'fused_pe': True,
               'fused_raymarch': True,
               'fused_raymarch_full': True,
               'fused_train': True,
               'fused_inn': False,
               'procrustes': 'quat',
               'compute_dtype': 'float32',
               'matmul_precision': 'highest',
               'compile_cache': '/tmp/jax_compile_cache',
               'steps_per_call': 20,
               'ray_sample': 'stratified',
               'profile_dir': None},
    'ckpt': {'backend': 'pickle'},
    'debug': {'nan_check': False},
    'novel_view_video': True,
    'nerf': {   'view_dep': True,
                'depth': {'param': 'metric', 'range': [0, 1]},
                'sample_intvs': 64,
                'sample_stratified': True,
                'fine_sampling': True,
                'sample_intvs_fine': 128,
                'rand_rays': 1024,
                'density_noise_reg': 1,
                'setbg_opaque': None},
    'camera': {'model': 'perspective', 'ndc': False},
    'max_iter': 500000}


def nerf_llff_repr_options():
    """A fresh DotDict copy of ``NERF_LLFF_REPR``."""
    return DotDict(copy.deepcopy(NERF_LLFF_REPR))

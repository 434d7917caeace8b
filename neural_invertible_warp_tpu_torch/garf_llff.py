"""The GARF configurations as plain dicts: ``options/nerf_gaussian_llff.yaml``
(the Gaussian-activation field on LLFF: a 6x256 trunk with a skip at 4, a
128-wide view branch, sigma 0.1, a sigmoid; 128 samples, 2048 rays)
resolved through its ``_parent_`` chain with ``--model=nerf_gaussian``, and
what ``options/garf_llff.yaml`` (``--model=garf``: se(3) refinement from the
identity, ``init.pose``, ``init.pose_warmup``) and
``options/garf_llff_se3.yaml`` (``--model=garf_se3_field``: the warp MLP)
add to it.

They let the port run these models without a YAML parser;
tests/test_torch_garf.py checks that each equals what the YAML loader
resolves. Use ``garf_llff_options(model)`` for a fresh, mutable DotDict.
"""

import copy

from .config import override_options
from .dotdict import DotDict

NERF_GAUSSIAN_LLFF = {   'group': '0_test',
    'name': 'debug',
    'model': 'nerf_gaussian',
    'yaml': 'nerf_gaussian_llff',
    'seed': 0,
    'gpu': 0,
    'cpu': False,
    'load': None,
    'arch': {   'depth': 6,
                'width': 256,
                'skip': [4],
                'density_activ': 'softplus',
                'sigmoid': True,
                'gaussian': {'sigma': 0.1}},
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
                'val_ratio': 0.1,
                'bgcolor': 1},
    'loss_weight': {'render': 0, 'render_fine': None},
    'optim': {   'lr': 0.0001,
                 'lr_end': 0.0001,
                 'algo': 'Adam',
                 'sched': {'type': 'ExponentialLR', 'gamma': None},
                 'clip_norm': None,
                 'clip_norm_pose': None,
                 'lr_decay': 250},
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
                'depth': {'param': 'inverse', 'range': [1, 0]},
                'sample_intvs': 128,
                'sample_stratified': True,
                'fine_sampling': False,
                'sample_intvs_fine': None,
                'rand_rays': 2048,
                'density_noise_reg': None,
                'setbg_opaque': None},
    'camera': {'model': 'perspective', 'ndc': False},
    'init': {'weight': {'uniform': False, 'range': 0.1}},
    'max_iter': 200000}

GARF_LLFF = {
    'model': 'garf',
    'yaml': 'garf_llff',
    'camera': {'noise': None},
    'optim': {   'lr_pose': 0.003,
                 'lr_pose_end': 1e-05,
                 'sched_pose': {'type': 'ExponentialLR', 'gamma': None},
                 'warmup_pose': None,
                 'test_photo': True,
                 'test_iter': 100},
    'init': {'pose': False, 'pose_warmup': 0},
    'visdom': {'cam_depth': 0.2}}

GARF_LLFF_SE3 = {
    'model': 'garf_se3_field',
    'yaml': 'garf_llff_se3',
    'arch': {   'layers_warp': [None, 256, 256, 256, 256, 256, 256, 6],
                'skip_warp': [4],
                'embedding_dim': 128,
                'actfn_warp': 'gaussian',
                'sigma_warp': 0.3}}


def garf_llff_options(model="garf"):
    """A fresh DotDict of the resolved options of ``model``: nerf_gaussian,
    garf or garf_se3_field."""
    layers = {"nerf_gaussian": [], "garf": [GARF_LLFF],
              "garf_se3_field": [GARF_LLFF, GARF_LLFF_SE3]}[model]
    opt = DotDict(copy.deepcopy(NERF_GAUSSIAN_LLFF))
    for over in layers:
        opt = override_options(opt, DotDict(copy.deepcopy(over)))
    return opt

"""The option files the quality probes name, as plain dicts, and the
yaml-free way to override them.

``yaml_options(name)`` is ``options/<name>.yaml`` resolved through its
``_parent_`` chain, as ``config.load_options`` resolves it, without a YAML
parser: for ``barf_llff``, ``barf_iphone``, ``barf_blender``,
``barf_blender_inn``, ``nerf_blender_repr``, ``nerf_dtu`` and ``barf_dtu``,
the layers below (each what its YAML file itself
says, ``_parent_`` aside) laid over one another from ``base.yaml`` down,
and the port's other dict configs for the rest, with the command-line keys
those carry taken out. tests/test_torch_evidence.py holds each against the YAML loader.
``apply_overrides(opt, {"dotted.key": value})`` sets typed Python values
with the CLI's rule: a key the options lack raises.
"""

import copy

from ..barf_inn_dtu import barf_inn_dtu_options
from ..config import override_options
from ..dotdict import DotDict
from ..flagship import flagship_options
from ..garf_llff import garf_llff_options
from ..nerf_llff_repr import nerf_llff_repr_options

# options/base.yaml
BASE = {   'group': '0_test',
    'name': 'debug',
    'model': None,
    'yaml': None,
    'seed': 0,
    'gpu': 0,
    'cpu': False,
    'load': None,
    'arch': {},
    'data': {   'root': None,
                'dataset': None,
                'image_size': [None, None],
                'num_workers': 8,
                'preload': False,
                'augment': {},
                'center_crop': None,
                'val_on_test': False,
                'train_sub': None,
                'val_sub': None,
                'llffhold': 8},
    'loss_weight': {},
    'optim': {   'lr': 0.001,
                 'lr_end': None,
                 'algo': 'Adam',
                 'sched': {},
                 'clip_norm': None,
                 'clip_norm_pose': None},
    'batch_size': 16,
    'max_epoch': 1000,
    'resume': False,
    'output_root': 'output',
    'tb': {'num_images': [4, 8]},
    'visdom': {'server': 'localhost', 'port': 9000},
    'freq': {'scalar': 200, 'vis': 1000, 'val': 20, 'ckpt': 50},
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
    'novel_view_video': True}

# options/nerf_llff.yaml, over base.yaml
NERF_LLFF = {   'arch': {   'layers_feat': [None, 256, 256, 256, 256, 256, 256, 256, 256],
                'layers_rgb': [None, 128, 3],
                'skip': [4],
                'posenc': {'L_3D': 10, 'L_view': 4},
                'density_activ': 'softplus',
                'tf_init': True},
    'nerf': {   'view_dep': True,
                'depth': {'param': 'inverse', 'range': [1, 0]},
                'sample_intvs': 128,
                'sample_stratified': True,
                'fine_sampling': False,
                'sample_intvs_fine': None,
                'rand_rays': 2048,
                'density_noise_reg': None,
                'setbg_opaque': None},
    'data': {   'dataset': 'llff',
                'scene': 'fern',
                'image_size': [480, 640],
                'num_workers': 4,
                'preload': True,
                'val_ratio': 0.1},
    'camera': {'model': 'perspective', 'ndc': False},
    'loss_weight': {'render': 0, 'render_fine': None},
    'optim': {   'lr': 0.001,
                 'lr_end': 0.0001,
                 'sched': {'type': 'ExponentialLR', 'gamma': None}},
    'batch_size': None,
    'max_epoch': None,
    'max_iter': 200000,
    'freq': {'scalar': 200, 'vis': 2000, 'val': 2000, 'ckpt': 5000}}

# options/barf_llff.yaml, over nerf_llff.yaml
BARF_LLFF = {   'barf_c2f': None,
    'camera': {'noise': None},
    'optim': {   'lr_pose': 0.003,
                 'lr_pose_end': 1e-05,
                 'sched_pose': {'type': 'ExponentialLR', 'gamma': None},
                 'warmup_pose': None,
                 'test_photo': True,
                 'test_iter': 100},
    'visdom': {'cam_depth': 0.2}}

# options/nerf_blender.yaml, over base.yaml
NERF_BLENDER = {   'arch': {   'layers_feat': [None, 256, 256, 256, 256, 256, 256, 256, 256],
                'layers_rgb': [None, 128, 3],
                'skip': [4],
                'posenc': {'L_3D': 10, 'L_view': 4},
                'density_activ': 'softplus',
                'tf_init': True},
    'nerf': {   'view_dep': True,
                'depth': {'param': 'metric', 'range': [2, 6]},
                'sample_intvs': 128,
                'sample_stratified': True,
                'fine_sampling': False,
                'sample_intvs_fine': None,
                'rand_rays': 1024,
                'density_noise_reg': None,
                'setbg_opaque': False},
    'data': {   'dataset': 'blender',
                'scene': 'lego',
                'image_size': [400, 400],
                'num_workers': 4,
                'preload': True,
                'bgcolor': 1,
                'val_sub': 4},
    'camera': {'model': 'perspective', 'ndc': False},
    'loss_weight': {'render': 0, 'render_fine': None, 'global_alignment': None},
    'optim': {   'lr': 0.0005,
                 'lr_end': 0.0001,
                 'sched': {'type': 'ExponentialLR', 'gamma': None}},
    'batch_size': None,
    'max_epoch': None,
    'max_iter': 200000,
    'trimesh': {'res': 128, 'range': [-1.2, 1.2], 'thres': 25.0, 'chunk_size': 16384},
    'freq': {   'scalar': 200,
                'vis': 1000,
                'val': 2000,
                'ckpt': 5000,
                'early_termination': None}}

# options/barf_blender.yaml, over nerf_blender.yaml
BARF_BLENDER = {   'barf_c2f': None,
    'camera': {'noise': 0.15},
    'optim': {   'lr_pose': 0.001,
                 'lr_pose_end': 1e-05,
                 'sched_pose': {'type': 'ExponentialLR', 'gamma': None},
                 'warmup_pose': None,
                 'test_photo': True,
                 'test_iter': 100},
    'visdom': {'cam_depth': 0.5}}

# options/barf_blender_inn.yaml, over nerf_blender.yaml
BARF_BLENDER_INN = {   'barf_c2f': None,
    'camera': {   'noise_type': None,
                  'noise_barf': 0.15,
                  'noise_l2g_r': None,
                  'noise_l2g_t': None},
    'optim': {   'lr_pose': 0.001,
                 'lr_pose_end': 1e-05,
                 'sched_pose': {   'type': 'ExponentialLR',
                                   'gamma': None,
                                   'step_size': None},
                 'warmup_pose': None,
                 'test_photo': True,
                 'test_iter': 100},
    'visdom': {'cam_depth': 0.5},
    'inn': {   'proj_type': 'fixed_positional_encoding',
               'proj_dims': 256,
               'arch': {'hidden_size': [256, 256, 256], 'num_layers': 6},
               'siren': {'first_omega': 5, 'hidden_omega': 5},
               'gaussian': {'sigma': 0.1},
               'posenc': {'freq': 4},
               'affine': False,
               'real_nvp': {   'anneal': 'reference',
                               'c2f': True,
                               'max_pe_iter': 100000,
                               'd_hidden': 128,
                               'multires': 6},
               'actfn': 'softplus',
               'optimize': {'enabled': True}},
    'warp_latent': {   'enc_type': 'l2fbarf',
                       'optimize': {'enabled': True},
                       'embed_dim': 128,
                       'num_layers': 2,
                       'hidden_size': 64,
                       'normalize': True,
                       'posenc': {'use_identity': True, 'freq_len': 8, 'c2f': None}}}

# options/nerf_blender_repr.yaml, over base.yaml
NERF_BLENDER_REPR = {   'arch': {   'layers_feat': [None, 256, 256, 256, 256, 256, 256, 256, 256],
                'layers_rgb': [None, 128, 3],
                'skip': [4],
                'posenc': {'L_3D': 10, 'L_view': 4},
                'density_activ': 'relu',
                'tf_init': True},
    'nerf': {   'view_dep': True,
                'depth': {'param': 'metric', 'range': [2, 6]},
                'sample_intvs': 64,
                'sample_stratified': True,
                'fine_sampling': True,
                'sample_intvs_fine': 128,
                'rand_rays': 1024,
                'density_noise_reg': 0,
                'setbg_opaque': True},
    'data': {   'dataset': 'blender',
                'scene': 'lego',
                'image_size': [400, 400],
                'num_workers': 4,
                'preload': True,
                'bgcolor': 1,
                'val_sub': 4},
    'camera': {'model': 'perspective', 'ndc': False},
    'loss_weight': {'render': 0, 'render_fine': 0},
    'optim': {   'lr': 0.0005,
                 'lr_end': 5e-05,
                 'sched': {'type': 'ExponentialLR', 'gamma': None}},
    'batch_size': None,
    'max_epoch': None,
    'max_iter': 500000,
    'trimesh': {'res': 128, 'range': [-1.2, 1.2], 'thres': 25.0, 'chunk_size': 16384},
    'freq': {'scalar': 200, 'vis': 1000, 'val': 2000, 'ckpt': 5000}}


# options/nerf_dtu.yaml, over base.yaml
NERF_DTU = {   'arch': {   'layers_feat': [None, 256, 256, 256, 256, 256, 256, 256, 256],
                'layers_rgb': [None, 128, 3],
                'skip': [4],
                'posenc': {'L_3D': 10, 'L_view': 4},
                'density_activ': 'softplus',
                'tf_init': True},
    'nerf': {   'view_dep': True,
                'depth': {'param': 'metric', 'range': [1, 0]},
                'sample_intvs': 128,
                'sample_stratified': True,
                'fine_sampling': False,
                'sample_intvs_fine': None,
                'rand_rays': 2048,
                'density_noise_reg': None,
                'setbg_opaque': None},
    'data': {   'dataset': 'dtu',
                'scene': 'scan82',
                'image_size': [300, 400],
                'num_workers': 4,
                'preload': True,
                'val_ratio': 0.1,
                'dtu': {   'split_type': None,
                           'dtuhold': 8,
                           'train_sub': None,
                           'val_sub': None,
                           'crop_ratio': None,
                           'crop': None,
                           'resize_by': 'max',
                           'resize': None,
                           'resize_factor': None,
                           'mask_img': False,
                           'light_cond': 3,
                           'max_images': 49,
                           'increase_depth_range_by_x_percent': 0}},
    'camera': {'model': 'perspective', 'ndc': False},
    'loss_weight': {'render': 0, 'render_fine': None, 'global_alignment': None},
    'weight_sched': {   'render': {'start_decay': None},
                        'render_fine': {'start_decay': None},
                        'global_alignment': {'start_decay': None}},
    'optim': {   'lr': 0.001,
                 'lr_end': 0.0001,
                 'sched': {'type': 'ExponentialLR', 'gamma': None}},
    'batch_size': None,
    'max_epoch': None,
    'max_iter': 200000,
    'freq': {   'scalar': 200,
                'vis': 1000,
                'val': 2000,
                'ckpt': 5000,
                'early_termination': 100000}}

# options/barf_dtu.yaml, over nerf_dtu.yaml
BARF_DTU = {   'barf_c2f': None,
    'camera': {'noise': None},
    'optim': {   'lr_pose': 0.0005,
                 'lr_pose_end': 1e-08,
                 'sched_pose': {'type': 'ExponentialLR', 'gamma': None},
                 'warmup_pose': None,
                 'test_photo': True,
                 'test_iter': 100},
    'visdom': {'cam_depth': 0.2},
    'pose': {   'parameterization': 'se3',
                'init': 'given',
                'noise': 0.15,
                'n_first_fixed_poses': 0,
                'optimize_relative_poses': False,
                'dtu_reconstruction': False,
                'colmap': {   'flow_ckpt_path': 'pretrained_models/PDCNet_megadepth.pth.tar'},
                'sfm': {'matcher': 'zncc', 'quant_px': 1.0, 'weights_path': None}},
    'inn': {   'proj_type': 'fixed_positional_encoding',
               'proj_dims': 256,
               'real_nvp': {   'anneal': 'reference',
                               'c2f': True,
                               'max_pe_iter': 100000,
                               'd_hidden': 128,
                               'multires': 6,
                               'latent_dim': 128},
               'actfn': 'softplus'},
    'save': {'init_poses': None, 'pred_poses': None}}

# options/barf_iphone.yaml, over barf_llff.yaml
BARF_IPHONE = {'data': {'dataset': 'iphone', 'scene': 'IMG_0239', 'image_size': [480, 640]}}


def _resolved(base, *layers):
    """``base`` with ``layers`` laid over it in order, leaf-wise, as a
    YAML file's ``_parent_`` chain is resolved."""
    opt = DotDict(copy.deepcopy(base))
    for layer in layers:
        opt = override_options(opt, DotDict(copy.deepcopy(layer)))
    return opt


def _without_cli(opt, **cli):
    """``opt`` with the command-line keys a dict config carries set back to
    their YAML values (``model`` and ``yaml`` are empty in every YAML)."""
    return apply_overrides(opt, dict({"model": None, "yaml": None}, **cli))


YAMLS = {
    # flagship.py carries the README's two flagship overrides
    "barf_inn_llff": lambda: _without_cli(flagship_options(), **{
        "barf_c2f": None, "loss_weight.global_alignment": None}),
    "barf_llff": lambda: _resolved(BASE, NERF_LLFF, BARF_LLFF),
    "barf_iphone": lambda: _resolved(BASE, NERF_LLFF, BARF_LLFF, BARF_IPHONE),
    "barf_blender": lambda: _resolved(BASE, NERF_BLENDER, BARF_BLENDER),
    "barf_blender_inn": lambda: _resolved(BASE, NERF_BLENDER, BARF_BLENDER_INN),
    "nerf_blender_repr": lambda: _resolved(BASE, NERF_BLENDER_REPR),
    "nerf_llff_repr": lambda: _without_cli(nerf_llff_repr_options()),
    "nerf_dtu": lambda: _resolved(BASE, NERF_DTU),
    "barf_dtu": lambda: _resolved(BASE, NERF_DTU, BARF_DTU),
    "barf_inn_dtu": lambda: _without_cli(barf_inn_dtu_options()),
    "nerf_gaussian_llff": lambda: _without_cli(garf_llff_options("nerf_gaussian")),
    "garf_llff": lambda: _without_cli(garf_llff_options("garf")),
    "garf_llff_se3": lambda: _without_cli(garf_llff_options("garf_se3_field")),
}


def yaml_options(name):
    """A fresh DotDict of ``options/<name>.yaml``, resolved."""
    if name not in YAMLS:
        raise KeyError("no dict config for options/{}.yaml".format(name))
    return YAMLS[name]()


def apply_overrides(opt, overrides):
    """Set ``{"a.b.c": value}`` on ``opt`` (typed values, no parsing) as
    ``--a.b.c=value`` would: leaf-wise, and a key ``opt`` lacks raises
    KeyError. Returns ``opt``."""
    nested = {}
    for dotted, value in overrides.items():
        keys = dotted.split(".")
        sub = nested
        for k in keys[:-1]:
            sub = sub.setdefault(k, {})
        if keys[-1] in sub:
            raise KeyError("duplicate override: {}".format(dotted))
        sub[keys[-1]] = copy.deepcopy(value)
    return override_options(opt, DotDict(nested), key_stack=[], safe_check=True)

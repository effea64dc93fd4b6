"""Engine configurations and perception recipes as Python data.

Equal to the JAX package's `configs/inference_nuscenes.yaml`,
`configs/tiny_cpu.yaml` and `configs/tiny_stage1.yaml` as `yaml.safe_load`
reads them (YAML anchors expanded), and, in `PERCEPTION`, to its four
`configs/perception/*.yaml` training recipes.
They are Python dicts because the port does not depend on PyYAML.
"""

import copy

# production geometry: 6 views x 8 frames, 32x384 latent
INFERENCE_NUSCENES = {'FrameLength': 8,
 'cond_image_type': 'final_cond_zero',
 'SampleStep': 25,
 'AttenType': 'intra-view',
 'InsertCrossView': True,
 'model': {'target': 'sgm.models.diffusion.DiffusionEngine3D',
           'params': {'share_noise_level': 0.07,
                      'use_ema': False,
                      'scale_factor': 0.18215,
                      'disable_first_stage_autocast': True,
                      'freeze_type': 'none',
                      'wrapper_type': 'OPENAIUNETWRAPPERCONTROLLDM3D',
                      'log_keys': ['txt'],
                      'denoiser_config': {'target': 'sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser',
                                          'params': {'num_idx': 1000,
                                                     'weighting_config': {'target': 'sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting'},
                                                     'scaling_config': {'target': 'sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling'},
                                                     'discretization_config': {'target': 'sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization'}}},
                      'network_config': {'target': 'sgm.modules.diffusionmodules.controlmodel.ControlledUNetModel3D',
                                         'params': {'insert_crossview': True,
                                                    'spatial_only_attn_type': 'intra-view',
                                                    'use_checkpoint': True,
                                                    'use_fp16': True,
                                                    'in_channels': 8,
                                                    'out_channels': 4,
                                                    'model_channels': 320,
                                                    'attention_resolutions': [4,
                                                                              2,
                                                                              1],
                                                    'num_res_blocks': 2,
                                                    'channel_mult': [1,
                                                                     2,
                                                                     4,
                                                                     4],
                                                    'num_head_channels': 64,
                                                    'use_spatial_transformer': True,
                                                    'use_linear_in_transformer': True,
                                                    'transformer_depth': 1,
                                                    'context_dim': 1024,
                                                    'legacy': False,
                                                    'num_frames': 8,
                                                    'alpha': 1,
                                                    'controlnet_config': {'target': 'sgm.modules.diffusionmodules.controlmodel.ControlNet3D',
                                                                          'params': {'insert_crossview': True,
                                                                                     'spatial_only_attn_type': 'intra-view',
                                                                                     'use_checkpoint': True,
                                                                                     'in_channels': 8,
                                                                                     'hint_channels': 19,
                                                                                     'model_channels': 320,
                                                                                     'attention_resolutions': [4,
                                                                                                               2,
                                                                                                               1],
                                                                                     'num_res_blocks': 2,
                                                                                     'channel_mult': [1,
                                                                                                      2,
                                                                                                      4,
                                                                                                      4],
                                                                                     'num_head_channels': 64,
                                                                                     'use_spatial_transformer': True,
                                                                                     'use_linear_in_transformer': True,
                                                                                     'transformer_depth': 1,
                                                                                     'context_dim': 1024,
                                                                                     'legacy': False,
                                                                                     'control_scales': 1.0,
                                                                                     'alpha': 1,
                                                                                     'num_frames': 8}}}},
                      'conditioner_config': {'target': 'sgm.modules.GeneralConditioner',
                                             'params': {'emb_models': [{'is_trainable': False,
                                                                        'input_key': 'txt',
                                                                        'ucg_rate': 0.1,
                                                                        'target': 'sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder',
                                                                        'params': {'freeze': True,
                                                                                   'layer': 'penultimate'}},
                                                                       {'is_trainable': False,
                                                                        'input_key': 'cond_img',
                                                                        'ucg_rate': 0.0,
                                                                        'target': 'sgm.modules.encoders.modules.IdentityEncoder'},
                                                                       {'is_trainable': False,
                                                                        'input_key': 'final_cond_zero',
                                                                        'ucg_rate': 0.0,
                                                                        'target': 'sgm.modules.encoders.modules.VAEEmbedder'}]}},
                      'first_stage_config': {'target': 'sgm.models.autoencoder.AutoencoderKLInferenceWrapper',
                                             'params': {'embed_dim': 4,
                                                        'monitor': 'val/rec_loss',
                                                        'ddconfig': {'double_z': True,
                                                                     'z_channels': 4,
                                                                     'resolution': 256,
                                                                     'in_channels': 3,
                                                                     'out_ch': 3,
                                                                     'ch': 128,
                                                                     'ch_mult': [1,
                                                                                 2,
                                                                                 4,
                                                                                 4],
                                                                     'num_res_blocks': 2,
                                                                     'attn_resolutions': [],
                                                                     'dropout': 0.0},
                                                        'lossconfig': {'target': 'torch.nn.Identity'}}},
                      'sampler_config': {'target': 'sgm.modules.diffusionmodules.sampling.EulerEDMSampler',
                                         'params': {'num_steps': 25,
                                                    'discretization_config': {'target': 'sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization'},
                                                    'guider_config': {'target': 'sgm.modules.diffusionmodules.guiders.VanillaCFG',
                                                                      'params': {'scale': 5.0}}}}}}}

# toy scale for CPU tests, same component graph
TINY_CPU = {'FrameLength': 2,
 'cond_image_type': 'final_cond_zero',
 'SampleStep': 4,
 'AttenType': 'intra-view',
 'InsertCrossView': True,
 'model': {'target': 'sgm.models.diffusion.DiffusionEngine3D',
           'params': {'share_noise_level': 0.07,
                      'scale_factor': 0.18215,
                      'disable_first_stage_autocast': True,
                      'denoiser_config': {'target': 'sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser',
                                          'params': {'num_idx': 1000,
                                                     'weighting_config': {'target': 'sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting'},
                                                     'scaling_config': {'target': 'sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling'},
                                                     'discretization_config': {'target': 'sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization'}}},
                      'network_config': {'target': 'sgm.modules.diffusionmodules.controlmodel.ControlledUNetModel3D',
                                         'params': {'insert_crossview': True,
                                                    'spatial_only_attn_type': 'intra-view',
                                                    'in_channels': 8,
                                                    'out_channels': 4,
                                                    'model_channels': 32,
                                                    'attention_resolutions': [2,
                                                                              1],
                                                    'num_res_blocks': 1,
                                                    'channel_mult': [1, 2],
                                                    'num_head_channels': 16,
                                                    'transformer_depth': 1,
                                                    'context_dim': 64,
                                                    'num_frames': 2,
                                                    'controlnet_config': {'target': 'sgm.modules.diffusionmodules.controlmodel.ControlNet3D',
                                                                          'params': {'insert_crossview': True,
                                                                                     'spatial_only_attn_type': 'intra-view',
                                                                                     'in_channels': 8,
                                                                                     'hint_channels': 19,
                                                                                     'model_channels': 32,
                                                                                     'attention_resolutions': [2,
                                                                                                               1],
                                                                                     'num_res_blocks': 1,
                                                                                     'channel_mult': [1,
                                                                                                      2],
                                                                                     'num_head_channels': 16,
                                                                                     'transformer_depth': 1,
                                                                                     'context_dim': 64,
                                                                                     'control_scales': 1.0,
                                                                                     'num_frames': 2}}}},
                      'conditioner_config': {'target': 'sgm.modules.GeneralConditioner',
                                             'params': {'emb_models': [{'is_trainable': False,
                                                                        'input_key': 'txt',
                                                                        'ucg_rate': 0.1,
                                                                        'target': 'sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder',
                                                                        'params': {'layer': 'penultimate',
                                                                                   'width': 64,
                                                                                   'heads': 4,
                                                                                   'layers': 2,
                                                                                   'vocab_size': 49408}},
                                                                       {'is_trainable': False,
                                                                        'input_key': 'cond_img',
                                                                        'ucg_rate': 0.0,
                                                                        'target': 'sgm.modules.encoders.modules.IdentityEncoder'},
                                                                       {'is_trainable': False,
                                                                        'input_key': 'final_cond_zero',
                                                                        'ucg_rate': 0.0,
                                                                        'target': 'sgm.modules.encoders.modules.VAEEmbedder'}]}},
                      'first_stage_config': {'target': 'sgm.models.autoencoder.AutoencoderKLInferenceWrapper',
                                             'params': {'embed_dim': 4,
                                                        'ddconfig': {'double_z': True,
                                                                     'z_channels': 4,
                                                                     'resolution': 32,
                                                                     'in_channels': 3,
                                                                     'out_ch': 3,
                                                                     'ch': 16,
                                                                     'ch_mult': [1,
                                                                                 2,
                                                                                 2,
                                                                                 2],
                                                                     'num_res_blocks': 1,
                                                                     'attn_resolutions': [],
                                                                     'dropout': 0.0}}},
                      'sampler_config': {'target': 'sgm.modules.diffusionmodules.sampling.EulerEDMSampler',
                                         'params': {'num_steps': 4,
                                                    'discretization_config': {'target': 'sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization'},
                                                    'guider_config': {'target': 'sgm.modules.diffusionmodules.guiders.VanillaCFG',
                                                                      'params': {'scale': 5.0}}}}}},
 'loss_fn_config': {'target': 'sgm.modules.diffusionmodules.loss.StandardDiffusionLoss',
                    'params': {'share_noise_level': 0.07,
                               'num_frames': 2,
                               'sigma_sampler_config': {'target': 'sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling',
                                                        'params': {'num_idx': 1000,
                                                                   'discretization_config': {'target': 'sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization'}}}}}}


def _single_frame(cfg):
    """``cfg`` with every frame count 1: the YAML's ``FrameLength`` anchor
    and the places that reference it."""
    out = copy.deepcopy(cfg)
    out["FrameLength"] = 1
    net = out["model"]["params"]["network_config"]["params"]
    net["num_frames"] = net["controlnet_config"]["params"]["num_frames"] = 1
    out["loss_fn_config"]["params"]["num_frames"] = 1
    return out


# stage 1: single-frame six-view generation at the tiny config's widths
TINY_STAGE1 = _single_frame(TINY_CPU)


# --------------------------------------------------------------------------
# the perception recipes of panacea_tpu/configs/perception/*.yaml, by their
# file names; the detector targets resolve to the port's (registry.py)
# --------------------------------------------------------------------------

def _perception_window():
    return {'perception': {
        'detector': {'target': 'panacea_tpu.perception.detector.StreamPETRWindow',
                     'params': {'num_classes': 10, 'embed_dims': 256, 'num_query': 644,
                                'memory_len': 1024, 'topk_proposals': 256,
                                'num_propagated': 256, 'num_decoder_layers': 6,
                                'num_levels': 5, 'num_cams': 6,
                                'pc_range': [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
                                'with_atss': True, 'atss_stacked_convs': 4}},
        'train': {'queue_length': 8, 'num_frame_losses': 1, 'random_length': 1,
                  'use_grid_mask': True, 'with_dn': True, 'dn_scalar': 10,
                  'dn_noise_scale': 1.0, 'dn_split': 0.75, 'dn_weight': 1.0,
                  'cls_weight': 2.0, 'bbox_weight': 0.25, 'batch_size': 2, 'dp_devices': 8,
                  'num_epochs': 24, 'samples_per_epoch': 28130},
        'optimizer': {'lr': 0.0004, 'weight_decay': 0.01, 'backbone_lr_mult': 0.1,
                      'grad_clip_norm': 35.0,
                      'schedule': {'policy': 'cosine', 'warmup_iters': 500,
                                   'warmup_ratio': 0.333333, 'min_lr_ratio': 0.001}},
        'data': {'data_root': 'data/nuscenes/',
                 'ann_file': 'data/nuscenes/nuscenes2d_temporal_infos_train.pkl',
                 'val_ann_file': 'data/nuscenes/nuscenes2d_temporal_infos_val.pkl',
                 'gen_root': None,
                 'test_gen_root': 'data/nuscenes/gen-nuscenes-val/',
                 'test_filter_file': 'data/nuscenes/gen-nuscenes-val-infos.pkl',
                 'ida': {'resize_lim': [0.3, 0.36], 'final_dim': [256, 512], 'rand_flip': True},
                 'rot_range': [-0.3925, 0.3925], 'scale_ratio_range': [0.95, 1.05]},
        'load_from': 'ckpts/atss_r50_fpn_20epoch_nuim_sgd_remapped.pth',
        'backbone_frozen_stages': 1}}


def _perception_pseudo_pretrain():
    cfg = _perception_window()
    p = cfg['perception']
    p['train']['random_length'] = 0
    data = p['data']
    del data['test_gen_root'], data['test_filter_file']
    data.update(ann_file='data/nuscenes/gen-nuscenes-train-infos.pkl',
                gen_root='data/nuscenes/gen-nuscenes-train/',
                train_filter_file='data/nuscenes/gen-nuscenes-train-infos.pkl')
    data['ida'] = {'resize_lim': [0.32, 0.32], 'final_dim': [256, 512], 'rand_flip': False}
    p.update(load_from=None, backbone_frozen_stages=-1, backbone_bn_trainable=False)
    return cfg


def _perception_streaming(load_from):
    cfg = _perception_window()
    p = cfg['perception']
    p['detector']['target'] = 'panacea_tpu.perception.detector.StreamPETR'
    p['train'].update(queue_length=1, seq_mode=True, seq_split_num=2, random_length=0)
    del p['data']['test_gen_root'], p['data']['test_filter_file']
    p['load_from'] = load_from
    return cfg


PERCEPTION = {
    'streampetr_r50_atss_512x256_window': _perception_window(),
    'streampetr_r50_atss_512x256_window_pseudo_pretrain': _perception_pseudo_pretrain(),
    'streampetr_r50_atss_512x256_nopretrain': _perception_streaming(None),
    'streampetr_r50_atss_512x256_withpretrain_real_finetune': _perception_streaming(
        'work_dirs/streampetr_r50_atss_512x256_window_pseudo_pretrain/final'),
}

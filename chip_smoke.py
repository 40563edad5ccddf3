"""Drive the PyTorch/CUDA port (sisr_tpu_torch) once on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. environment: the card (nvidia-smi), torch and CUDA versions, the build of every
   CUDA kernel from the sources in this checkout, and whether the native host helpers
   (sisr_tpu_torch.native: the Pillow-exact resize and the PNG decoder, g++) loaded,
   with the reason where not;
2. kernel: each kernel against its plain PyTorch version on the card, at the main-path
   shape and at edge shapes, with its time (the CA kernel also with Q-RCAN's meta and
   gate, on both paths, timed beside the meta-less call): ``ms`` per call replayed from a CUDA
   graph (device time with launch gaps, no host), ``host_ms`` per call back to back
   from Python, ``device_ms`` the profiler's sum of its kernels.  The CA kernel in
   bf16 and f32, on each of its four routes (on chip, in rounds, streaming one image
   a round, three passes; which route each shape took is checked against the plan),
   with the on-chip and three-pass kernels timed in turns at the main shape, the
   rounds route against three passes at int8 Q-RCAN's f32 map (with meta and gate,
   and without), and the three passes also at the DIV2K shapes of the stream route
   below; the CA + residual kernel with x f32 and r bf16 or f32, on its three paths
   in the same way (in rounds of images, streaming, or three passes), also with meta,
   gate and the cast-first rounding of int8 Q-RCAN's QRCAB tail, that one-launch tail
   timed in turns against the three-pass CA, cast and add it replaces; then the
   stream route of both ops at DIV2K size (1, 339, 510, 64) and its 512 x 384 bucket,
   f32, in every mode (the CA bare, with the gate, meta + gate and a valid extent; the
   tail with r bf16 and f32, plain and cast first), timed in turns against its three
   passes; and the on-chip
   CA at the standard protocol's batch-1 bf16 maps (128^2, the largest Set14 LR
   shape, 510 x 339) against its bound, with its launches there as each
   standard-protocol run counts them by map;
3. reference: the full-width RCAN, Q-RCAN, EDSR, HAN, Q-HAN, SAN, Q-SAN, SRMD, SFTMD,
   SFTMD with q_injection, SPARNet, Q-SPARNet, SRCNN and VDSR forwards (each on the
   input its _prep_batch makes: SRMD's with the metadata maps concatenated, the
   pre-upscaled families' upscaled on the card, SRCNN's and VDSR's its Y channel;
   SPARNet's and Q-SPARNet's BatchNorms also in train mode) and fused evals on a small input, card (CUDA
   kernels) against the CPU (plain versions), in f32 (every HAN and Q-HAN of this
   script with LAM's and CSAM's gammas non-zero: GAMMAS; every SAN and Q-SAN with gamma and the non-local output conv W
   non-zero: set_gammas); then HAN's LAM and CSAM, and SAN's SOCA and non-local block,
   alone at the fused eval's shapes, card against CPU in f32, and timed in bf16 and
   f32 beside their bounds;
4. int8 reference: one int8 conv's int32 sums, card against CPU, and the time of
   ``torch._int_mm`` in both weight layouts; calibration on the card (with TF32
   allowed globally) against the CPU's; the full-width int8 RCAN and its fused eval
   on the same quantised state, card against CPU; then the same for EDSR 64
   features, 16 blocks with each of its three carries (float32, bfloat16, int16),
   Q-RCAN's e2e configuration cut to 2 x 2 (from 10 x 20, to make room for HAN's
   phases; its 4 CA + residual launches a forward counted, their path held against
   the plan: the int8 main path runs it at full depth), Q-EDSR at 2 blocks and 256
   features (also its f32 module forward), HAN and Q-HAN at 2 x 2 (LAM and CSAM in
   bf16), SAN and Q-SAN at 2 x 2 (SOCA and the non-local block in f32), SRMD (12 convs)
   and SFTMD with q_injection at 2 blocks (SFT branches in bf16; also the int32 sums of
   its 9 x 9 conv_output at HR size, whole and in bands of rows) and VDSR 20 x 64 (on
   the Y channel of the LR upscaled on the card), each with the int32 sums of its
   first two convs;
5. main path: ``eval_sisr --fused_eval`` (sisr_tpu_torch.net_eval) on RCAN 10x20, 64
   features, 4x, bf16, over 16 seeded synthetic 128^2 -> 512^2 PNG pairs; the kernel
   launch counts of that run (every CA call on chip); then the img/s of warm protocol
   passes and a device-time breakdown of one batch;
6. int8 main path: ``eval_sisr --fused_eval --int8`` on the same pairs and weights,
   with its launch counts (every CA + residual call on chip), its mean PSNR against
   the bf16 run's, img/s and breakdown;
7. Q-RCAN main path: ``eval_sisr --fused_eval`` on Q-RCAN 10x20, 64 features, 4x,
   bf16, max_concat with a q_node in every block, over the same pairs with the seeded
   10-value blur kernels of their degradation_metadata.csv: every QRCAB tail one CA
   launch with meta and gate, on chip; launches, img/s and breakdown;
8. EDSR main path: the same for EDSR 64 features, 16 blocks, 4x, bf16 (no kernel of
   ours); then ``--int8`` on EDSR (no kernel of ours) and on Q-RCAN (every QRCAB tail
   one CA + residual launch, cast first, with meta and gate on the f32 map and the
   bf16 carry, all in rounds at this shape),
   and Q-EDSR at configs/div2k/qedsr.toml's width (256 features, 32 blocks, the
   gate's nonlinearity, 10 blur-kernel values, 4x) in bf16 and with ``--int8``; then
   HAN and Q-HAN as configs/div2k/han.toml and qhan.toml build them, cut to 10 x 10
   (64 features, 4x; Q-HAN's QRCABs the standard style with a q_node, on the blur
   kernel) in bf16 (100 CA launches a forward on chip, Q-HAN's with the gate) and
   with ``--int8`` (100 CA + residual launches a forward in rounds, Q-HAN's cast
   first with the gate), LAM, CSAM and last_conv timed apart; SAN and Q-SAN as
   configs/div2k/san.toml and qsan.toml build them, cut to 20 x 5 (64 features, reduction
   16, 4x, max_combined_im_size 20000: no tile grid at 128^2; Q-SAN gated on the blur
   kernel) in bf16 and with ``--int8``, no CA call, their SOCAs and non-local passes
   timed apart; SRMD and SFTMD as configs/div2k/srmd.toml and sftmd.toml build them
   (12 convs of 128 features over 3 + 10 channels; 16 SFT residual blocks of 64
   features, standard SFT) in bf16 and with ``--int8``, no CA call, the forward's
   device time split into convs and the rest and the odd-channel convs (13 and 74
   input channels) timed beside zero-padded copies; each int8 path's mean PSNR within
   1 dB of its bf16 run's, with img/s, a device-time breakdown and peak memory; then
   the pre-upscaled families on the LR upscaled to 512^2 on the card: SPARNet as
   sisr_tpu's e2e benchmark builds it, Q-SPARNet as configs/celebahq/qsparnet.toml
   builds it, SRCNN and VDSR at their default patterns on the Y channel, in bf16 (no CA
   call; the forward's device time split into convs, norms and the rest), VDSR also
   with ``--int8``, and ``--int8`` on SPARNet and SRCNN printing sisr_tpu's notice and
   staying bf16; the img/s of every path is that of warm passes without the
   device-batch cache, and
   RCAN's and EDSR's bf16 paths also give it with the cache (each cached pass decodes
   no item and writes the first pass's metrics);
9. kernel backward: the CA op under autograd (the kernel forward, the plain VJP) at the
   training shape (8, 64, 64, 64) f32 with and without Q-RCAN's gate, and at the f32
   eval shape (in rounds), against plain autograd; the kernel's forward time at the
   training shape;
10. train reference: 10 training steps of RCAN and Q-RCAN (2 x 2 blocks, 64 features,
   f32) on the card against the same 10 on the CPU, from the same weights and batches;
11. train main path: ``train_sisr`` (sisr_tpu_torch.net_train) on the paper's Q-RCAN
   recipe (configs/div2k/qrcan.toml, cut to 5 x 10 QRCABs: 64 features, 4x, standard
   style with a q_node in every block, blur-kernel metadata, batch 8, LR crops of 64,
   flips, Adam with cosine warm restarts, f32, fused validation) on the seeded pairs for
   2 epochs, then a resume for a third, with its kernel launch counts; ``eval_sisr
   --fused_eval`` of the best epoch (f32, the CA in rounds); then 10 timed warm train
   steps each of Q-RCAN, RCAN, HAN and Q-HAN 5 x 10, SAN and Q-SAN 10 x 5 (these and
   this recipe run cut in depth, RECIPE_TRAIN_DEPTH, to keep the script's time), SRMD,
   SFTMD, SPARNet (its BatchNorms in train mode) and VDSR (MSE, its clip of 0.1; both
   on HR-size crops of 256^2) through the handler (forward /
   backward / optimizer, device busy, the CA kernel's share, conv FLOPs against the
   TF32 and f32 peaks, peak memory), and the same step with the CA's plain version in
   its place, in turns;

12. kernel extent (run after phase 2's meta case): the CA with a valid extent (bucketed
   eval) on each of its routes, against its plain version, timed against the same call
   without an extent;
13. standard protocol: ``eval_sisr`` without --fused_eval (batch 1, --save_im,
   comparisons, --time_models) on RCAN and Q-RCAN bf16 over a 31-image mixed-size set
   (the 16 pairs, the HR sizes of Set14's images, one 2040 x 1356 image): launches by
   route against each image's plan, the 16 shared pairs against the fused protocol's
   metrics, img/s and the host time split; then ``--eval_buckets 128`` (every CA call
   given its extent, metrics against the unbucketed run), ``--int8`` (the CA +
   residual's stream route on the 2040-wide image, timed there against its three
   passes), ``--model_only``; then ``--model_only`` of Q-RCAN as configs/div2k/qrcan.toml
   builds it (f32, standard style with a q_node: the CA with a gate), the 510 x 339
   image's CA calls streaming, its SR output against the plain CA's forward; then
   Q-HAN bf16 with ``--no_image_comparison`` and with ``--eval_buckets 128`` (its
   LAM and CSAM on the zero-masked pads), each against the run before it; then Q-SAN
   bf16 with ``--no_image_comparison`` on the tile grid (the Set14 maps 2 x 2, the
   510 x 339 map 16 tiles of 105 x 148; the tile batches counted against the plan,
   no CA call), its shared pairs against the fused run; then Q-SAN at
   10 x 5 with max_combined_im_size 10000 (a 2 x 2 grid on the 128^2 maps) on the 16 pairs, the
   fused and the standard protocol, in bf16 and ``--int8`` (one int8 state), each
   pair's metrics against the other protocol's; then SFTMD bf16 with
   ``--no_image_comparison`` and with ``--eval_buckets 128`` (no CA call), each against
   the run before it; then Q-SPARNet at SPARNet's default sizes, bf16, on the mixed
   set's images whose sides are multiples of 8 (its output's size is its input's only
   there, as in sisr_tpu; the sides that are no multiple of 32 take the hourglasses'
   nearest-exact resize), its shared pairs within 0.3 dB of its fused run, and
   ``--eval_buckets 128`` ignored with sisr_tpu's notice;
14. train_sisr on configs/div2k/qrcan.toml, qhan.toml, qsan.toml and sftmd.toml (both
   training sets on the pairs) and configs/celebahq/qsparnet.toml (on the pairs' LR
   upscaled on the host with Pillow bicubic) as shipped (no fused_val: the standard validation epoch), each
   one's val-PSNR against a fused validation of the same checkpoint;
15. online degradation, attributes and bf16 training (the bf16 steps after phase 11,
   the training runs after phase 14, beside phase 18; phase 9 also
   takes the CA under autograd in bf16, and after phase 10 ``degrade_batch_on_device``
   and the dynamic-scale int8 conv run card against CPU): ``train_sisr`` of
   configs/div2k/qrcan.toml's model at 5 x 10 in bf16 on the 16 HR images in
   device-mode online degradation, with directory checkpoints and bf16 moments, for 2
   epochs and a resume, then ``eval_sisr --fused_eval`` of its best epoch from its
   directory, every CA call counted by map and type; an epoch in host-mode online
   degradation with noise; ``--data_attributes`` on a CelebA attribute file for the
   pairs renamed as CelebA's; ``CelebaSplitSampler`` ordering an epoch; and 10 timed
   bf16 train steps of Q-RCAN and RCAN beside the f32 ones of phase 11;
16. the long tail (after phase 14): ``train_sisr`` of configs/div2k/qrcan.toml's model
   in f32 with the perceptual term on a seeded VGG19, tracked and cleaned every epoch
   (2 epochs and a resume), its loss card against CPU, 10 timed steps with and without
   the term; FACE_SIM on Q-SPARNet's standard protocol with the LightCNN face model,
   both face models' embeddings card against CPU; ``image_manipulate`` against
   ``degrade_batch_on_device``, the reference import and its fused eval,
   ``model_report``, the tracker's records and the profiling helpers; ``export_serving``
   of RCAN in bf16 and int8 and of Q-RCAN (5 x 20), each program run over the 16 LR
   images (``run_serving``: launches, PSNR against the fused or the eager int8
   forward, ms a batch against the eager program's).  The three exports run beside
   phase 14, phase 15's training runs and the perceptual train runs, each in a process
   of its own (with phase 18), and end
   before the timed steps; the served programs' checks run beside phase 17's ranks,
   and their timings after phase 17.  To make room, the timed f32 and bf16 steps of
   Q-RCAN and RCAN (phases 11 and 15) go at 5 x 10, as do the perceptual runs;
17. multi-GPU data parallelism (after phase 16; phase_multi_gpu): two ranks share the
   card over gloo, each a process of this script (``--rank-job``) started through
   sisr_tpu's launcher contract (SISR_TPU_*): ``train_sisr --gpu multi`` of
   configs/div2k/qrcan.toml's model at 5 x 10, f32, on the 16 pairs' 64^2 crops, 2
   epochs and a resume, against the same run in one process (losses, weights, rank 0's
   files, each rank's decoded items and its ca_onchip launches at its (4, 64, 64, 64)
   map); the same command with no launcher (the CLI starts a rank for the card, NCCL)
   against ``--gpu single`` (the ranks, this process's one-process references and the
   serving checks run at once); ``eval_sisr --fused_eval --mesh`` of RCAN in bf16 and
   ``--int8`` against the main paths' runs (each rank's launches at (4, 128, 128, 64)),
   int8 equal to one process running the ranks' halves of each batch; Q-SAN's standard
   protocol with its tile grid shared over the ranks against its one-process run; then,
   with the card the ranks' alone, each rank's DDP step and gradient all-reduce beside
   one process's step;
18. the benchmark tools (phase_bench_tools, a process of its own, ``--rank-job
   bench_tools``, started with the serving exports beside phases 14-16's untimed runs;
   its line printed after the perceptual train runs): each tool of
   sisr_tpu_torch/tools once at full width with few passes — ``flops.py``'s counts of
   EDSR 64f/16b and 256f/32b, RCAN 10 x 20 and Q-RCAN held within 0.1% of the conv
   FLOPs the port's own modules run at 128^2; every ``e2e_bench.E2E_CONFIGS`` key
   through ``run_config`` (16 images, batch 8, one timed pass; finite per-image PSNR,
   edsr_int8 within 1 dB of edsr, qrcan's 200 ca_onchip launches a forward, san on its
   tile grid, no CA on the others); ``bench_models``' family table and ``--paper`` (no
   FAILED row, MFU in (0, 100%], the int8 RCAN row's 200 CA + residual launches a
   forward on its planned route), ``--train --vs-torch`` and ``--val`` (one timed
   epoch each, on 32 and 16 images); ``bench_quantization --all`` (batch 8);
   ``bench_ca_epilogue`` (each shape's route against its launches, 1e-5 abs with the
   f32 carry, 2 bf16 ULPs with the bf16 one, the two epilogues' raw int8 RCAN outputs
   at least min(40 dB, the PSNR a rounding-only change of the plain tail gives) apart;
   its launches kept out of the kernels line, a kernel against its plain version);
   ``bench_bucketed``;
   ``bench_decode_cache --passes 1`` (both arms' per-image PSNR equal); ``train_soak``
   at 256f/32b for 32 steps into a temporary ``--out``;

then the script's total seconds with each family's int8 img/s over its bf16 img/s
(the table of ``INT8_MEASURED_SLOWER``), the ``kernels`` table (a row for each route
of each
TPU kernel: the CA on chip, in three passes, in rounds and streaming, the CA + residual
in rounds, in three passes and streaming), the card's name and power limit, and a last
line
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN throughout, so
f32 comparisons are true f32, except where phase 4 turns it on to show calibration
turns it off for itself, and in phases 11, 14 and 15, which train with PyTorch's default
(cuDNN TF32 on, matmul TF32 off) as a user's run would.  It exits non-zero without a result
when CUDA is absent or when the sisr_tpu_torch package is not beside it.
"""
import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_CUDA_CORE_FLOPS = 67e12  # float32 outside the tensor cores
TF32_TENSOR_FLOPS = 495e12
BF16_TENSOR_FLOPS = 989e12

LR_SIZE, SCALE, N_IMAGES, BATCH = 128, 4, 16, 8
RCAN = {'scale': SCALE, 'n_resgroups': 10, 'n_resblocks': 20, 'n_feats': 64,
        'reduction': 16, 'dtype': 'bf16'}
# sisr_tpu's e2e benchmark configurations (tools/e2e_bench.py:35-47)
META_COLS = 10  # one blur kernel of 10 values per image
QRCAN = {'scale': SCALE, 'n_resgroups': 10, 'n_resblocks': 20, 'n_feats': 64,
         'reduction': 16, 'style': 'max_concat', 'include_q_layer': True,
         'metadata': ['blur_kernel'], 'dtype': 'bf16'}
EDSR = {'scale': SCALE, 'num_features': 64, 'num_blocks': 16, 'dtype': 'bf16'}
# configs/div2k/qedsr.toml's model: the paper's Q-EDSR, the widest model of the configs
QEDSR = {'scale': SCALE, 'num_features': 256, 'num_blocks': 32, 'res_scale': 0.1,
         'q_layer_nonlinearity': True, 'metadata': ['blur_kernel'], 'dtype': 'bf16'}
# configs/div2k/han.toml's and qhan.toml's models (10 x 20, 64 features, 4x; Q-HAN's
# groups take the 'standard' style and a q_node in every block, on the blur kernel), cut
# to 10 blocks a group (the width and the 10 groups LAM weighs unchanged)
HAN = {'scale': SCALE, 'n_resgroups': 10, 'n_resblocks': 10, 'n_feats': 64,
       'reduction': 16, 'dtype': 'bf16'}
QHAN = {**HAN, 'metadata': ['blur_kernel']}
# configs/div2k/san.toml's and qsan.toml's models (20 x 10, 64 features, reduction 16,
# 4x, the tile grid under max_combined_im_size = 20000; Q-SAN's blocks gated on the blur
# kernel), cut to 5 blocks a group (the width and the 20 SOCA groups
# unchanged)
SAN = {'scale': SCALE, 'n_resgroups': 20, 'n_resblocks': 5, 'n_feats': 64,
       'reduction': 16, 'max_combined_im_size': 20000, 'dtype': 'bf16'}
QSAN = {**SAN, 'metadata': ['blur_kernel']}
# Q-SAN at max_combined_im_size = 10000: the 128^2 maps of the fused cell on a 2 x 2 grid
QSAN_GRID = {**QSAN, 'max_combined_im_size': 10000, 'n_resgroups': 10}
# configs/div2k/srmd.toml's and sftmd.toml's models, on the blur kernel: SRMD 12 convs of
# 128 features over 3 + 10 channels; SFTMD 16 SFT residual blocks of 64 features,
# standard SFT, 4x (and with q_injection, held card against CPU)
SRMD = {'scale': SCALE, 'nc': 128, 'nb': 12, 'metadata': ['blur_kernel'], 'dtype': 'bf16'}
SFTMD = {'scale': SCALE, 'num_features': 64, 'num_blocks': 16, 'in_nc': 3,
         'sft_type': 'standard', 'metadata': ['blur_kernel'], 'dtype': 'bf16'}
SFTMD_Q = {**SFTMD, 'q_injection': True}
# the pre-upscaled families, each on the LR upscaled to HR size on the card: sisr_tpu's
# e2e benchmark's SPARNet (tools/e2e_bench.py:54-57: the defaults, in_size 128: 3
# stride-2 steps, 32-128 channels, BatchNorm, LeakyReLU, hourglasses of depth 4 to 2 and
# back to 5); Q-SPARNet as configs/celebahq/qsparnet.toml builds it (in_size = out_size
# = 512: 5 stride-2 steps; the blur kernel's 10 values); Q-SPARNet at SPARNet's default
# sizes, the standard protocol's (its output keeps every side that is a multiple of 8,
# while its hourglasses halve a map 5 times: odd sides); SRCNN [9, 5, 5] over
# [1, 64, 32, 1] and VDSR 20 x 64, on the Y channel
SPARNET = {'scale': SCALE, 'dtype': 'bf16'}
QSPARNET = {'scale': SCALE, 'in_size': 512, 'out_size': 512, 'metadata': ['blur_kernel'],
            'dtype': 'bf16'}
QSPARNET_STD = {'scale': SCALE, 'metadata': ['blur_kernel'], 'dtype': 'bf16'}
SRCNN = {'scale': SCALE, 'dtype': 'bf16'}
VDSR = {'scale': SCALE, 'dtype': 'bf16'}
MODELS = {'rcan_10x20': ('rcan', RCAN), 'qrcan_10x20': ('qrcan', QRCAN),
          'edsr_16b': ('edsr', EDSR), 'qedsr_32b': ('qedsr', QEDSR),
          'han_10x10': ('han', HAN), 'qhan_10x10': ('qhan', QHAN),
          'san_20x5': ('san', SAN), 'qsan_20x5': ('qsan', QSAN),
          'qsan_grid': ('qsan', QSAN_GRID), 'srmd_12': ('srmd', SRMD),
          'sftmd_16b': ('sftmd', SFTMD), 'sftmd_q16b': ('sftmd', SFTMD_Q),
          'sparnet_128': ('sparnet', SPARNET), 'qsparnet_512': ('qsparnet', QSPARNET),
          'qsparnet_128': ('qsparnet', QSPARNET_STD), 'srcnn_955': ('srcnn', SRCNN),
          'vdsr_20': ('vdsr', VDSR),
          # the serving export's Q-RCAN (the e2e configuration cut to 5 x 20)
          'qrcan_5x20': ('qrcan', {**QRCAN, 'n_resgroups': 5})}
# the families whose paths make no call of either CA op
NO_CA_MODELS = ('san', 'qsan', 'srmd', 'sftmd', 'sparnet', 'qsparnet', 'srcnn', 'vdsr')
# the pre-upscaled families' main paths
PRE_UPSCALED_PATHS = ('sparnet_128', 'qsparnet_512', 'srcnn_955', 'vdsr_20')
# LAM's and CSAM's gammas start at 0, where both are the identity: every HAN and Q-HAN
# of this script sets them to these, so each check exercises them; SAN's gamma and its
# non-local output conv W start at 0 too (the block is then the identity): every SAN and
# Q-SAN takes SAN_GAMMA and a W drawn from N(0, 0.3^2), its bias from N(0, 0.1^2), seed 11
GAMMAS = {'la': 0.5, 'csa': -0.7}
SAN_GAMMA = 0.5
CA_PER_FORWARD = RCAN['n_resgroups'] * RCAN['n_resblocks']
CONCAT_PATHS = ('srmd_12', 'sftmd_16b')  # the channel-concat families' main paths
CA_KERNELS = ('ca_onchip', 'ca_rounds', 'ca_pool_partial', 'ca_excite', 'ca_scale')
CA_RES_KERNELS = ('ca_rounds', 'ca_pool_partial', 'ca_excite', 'ca_res_scale')
# substrings of cuBLASLt / CUTLASS integer GEMM kernel names (torch._int_mm)
GEMM_KERNEL_HINTS = ('gemm', 'xmma', 'cutlass', 'imma')
# substrings of cuDNN / CUTLASS convolution and GEMM kernel names
CONV_KERNEL_HINTS = ('conv', 'xmma', 'gemm', 'cutlass', 'cudnn', 'fprop', 'implicit')
# substrings of normalisation kernel names (PyTorch's batch_norm_*, cuDNN's bn_*)
NORM_KERNEL_HINTS = ('norm', 'bn_fw', 'bn_bw')


def set_gammas(module):
    """GAMMAS into a HAN or Q-HAN module's LAM and CSAM; SAN_GAMMA and a seeded W into a
    SAN or Q-SAN module (nothing for other models)."""
    import torch
    with torch.no_grad():
        if hasattr(module, 'la'):
            for name, value in GAMMAS.items():
                getattr(module, name).gamma.fill_(value)
        if hasattr(module, 'non_local'):
            module.gamma.fill_(SAN_GAMMA)
            draw_nonlocal_w(module.non_local)
    return module


def draw_nonlocal_w(nonlocal_ca):
    """A NonlocalCA's output conv W (0 at init: the block is the identity) drawn from
    N(0, 0.3^2), its bias from N(0, 0.1^2), seed 11."""
    import torch
    w, gen = nonlocal_ca.non_local.W, torch.Generator().manual_seed(11)
    with torch.no_grad():
        w.weight.copy_(0.3 * torch.randn(w.weight.shape, generator=gen))
        w.bias.copy_(0.1 * torch.randn(w.bias.shape, generator=gen))
    return nonlocal_ca


START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries ``at_s``, the script's seconds when it
    was printed (the time split of a run)."""
    if 'phase' in obj:
        obj = {**obj, 'at_s': time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=50, rounds=5, warm=5):
    """Median over ``rounds`` of the CUDA-event time of ``reps`` back-to-back calls,
    per call, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def graph_ms(fn, calls=20, rounds=5):
    """Per-call device time of ``fn`` with the host out of the way: ``calls`` calls
    captured in one CUDA graph, replays timed with CUDA events (median of
    ``rounds``)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def device_kernel_ms(fn, reps=20):
    """Per-call device time of ``fn``'s CUDA kernels from torch.profiler, and the
    per-kernel totals (ms over all calls); (None, {}) when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, 'self_device_time_total', None)
        if us is None:
            us = getattr(evt, 'self_cuda_time_total', 0)
        if us:
            per_kernel[evt.key] = us / 1e3
    total = sum(per_kernel.values())
    return (total / reps if total else None), per_kernel


def time_kernel(kern, plain, three_pass=None):
    """A kernel's and its plain version's times and, given ``three_pass``, its
    three-pass path's, in turns (plain, [three-pass,] kernel, kernel, [three-pass,]
    plain: the second turn of each graph timing is reported); and the profiler's
    per-kernel totals of the kernel over 20 calls."""
    fns = [(prefix, fn) for prefix, fn in (('plain_', plain), ('three_pass_', three_pass),
                                            ('', kern)) if fn is not None]
    timing = {}
    for prefix, fn in fns + fns[::-1]:
        timing[prefix + 'ms'] = graph_ms(fn)
    for prefix, fn in fns:
        timing[prefix + 'host_ms'] = cuda_ms(fn)
        timing[prefix + 'device_ms'], detail = device_kernel_ms(fn)
    return timing, detail  # the kernel comes last


def ca_bound(x, w1):
    """Bytes, operations and the bound (ms) of the CA on x: one read and one write of
    the map plus the excite's weights; the pool's add and the scale's multiply per
    element plus the excite."""
    n, h, w, c = x.shape
    cr = w1.shape[1]
    bytes_moved = 2 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr)
    ops = 2 * x.numel() + n * (4 * c * cr + 2 * c)
    return bytes_moved, ops, max(bytes_moved / HBM_BYTES_PER_S,
                                 ops / F32_CUDA_CORE_FLOPS) * 1e3


def synthetic_pair(rng, height, width):
    """One HR PNG image of height x width (smooth structure: sinusoids and a gradient,
    plus per-pixel noise) and its PIL bicubic 1/SCALE downscale, as PIL images."""
    import numpy as np
    from PIL import Image
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy, xx = yy / height, xx / width
    fx, fy, phase = rng.uniform(2, 12), rng.uniform(2, 12), rng.uniform(0, 6.3, 3)
    chans = [0.5 + 0.35 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase[c])
             * np.cos(2 * np.pi * fy * xx * (c + 1) / 3) + 0.15 * (xx - yy)
             for c in range(3)]
    img = np.stack(chans, -1) * 255 + rng.normal(0, 12, (height, width, 3))
    hr = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    return hr, hr.resize((width // SCALE, height // SCALE), Image.BICUBIC)


def write_metadata(lr_dir, names, rng):
    """degradation_metadata.csv beside the LR images: one 10-value blur kernel (a
    Dirichlet draw, as sisr_tpu's e2e benchmark writes them) per image."""
    import numpy as np
    with open(os.path.join(lr_dir, 'degradation_metadata.csv'), 'w') as f:
        f.write('image,blur_kernel\n')
        for name in names:
            kernel = rng.dirichlet(np.ones(META_COLS) * 5)
            f.write('%s,"%s"\n' % (name, json.dumps(kernel.tolist())))


def write_workload(root, rng):
    """16 LR/HR PNG pairs of 128^2 -> 512^2 (synthetic_pair), with their
    degradation_metadata.csv."""
    hr_size = LR_SIZE * SCALE
    lr_dir, hr_dir = os.path.join(root, 'lr'), os.path.join(root, 'hr')
    os.makedirs(lr_dir)
    os.makedirs(hr_dir)
    names = ['im_%03d.png' % i for i in range(N_IMAGES)]
    for name in names:
        hr, lr = synthetic_pair(rng, hr_size, hr_size)
        hr.save(os.path.join(hr_dir, name))
        lr.save(os.path.join(lr_dir, name))
    write_metadata(lr_dir, names, rng)
    return lr_dir, hr_dir


# the HR sizes (width, height) of Set14's images, each cut to multiples of 4, and of a
# DIV2K validation image: synthetic stand-ins for the sizes of those sets (neither set
# is in the repo)
SET14_HR = {'baboon': (500, 480), 'barbara': (720, 576), 'bridge': (512, 512),
            'coastguard': (352, 288), 'comic': (248, 360), 'face': (276, 276),
            'flowers': (500, 360), 'foreman': (352, 288), 'lenna': (512, 512),
            'man': (512, 512), 'monarch': (768, 512), 'pepper': (512, 512),
            'ppt3': (528, 656), 'zebra': (584, 388)}
DIV2K_HR = {'div2k_0801': (2040, 1356)}
DIV2K_LR = (1356 // SCALE, 2040 // SCALE)  # (h, w) of its LR map


def write_mixed_workload(dirs, root):
    """The mixed-size eval set: the 16 pairs of ``dirs`` (hard links), one synthetic
    pair at each Set14 HR size and one at 2040 x 1356 (numpy seed 12), and a
    degradation_metadata.csv for all 31."""
    import numpy as np
    rng = np.random.RandomState(12)
    mixed = {'lr_dir': os.path.join(root, 'mixed', 'lr'),
             'hr_dir': os.path.join(root, 'mixed', 'hr'),
             'model_loc': dirs['model_loc'], 'out_loc': os.path.join(root, 'out_mixed')}
    names = sorted(n for n in os.listdir(dirs['lr_dir']) if n.endswith('.png'))
    for key in ('lr_dir', 'hr_dir'):
        os.makedirs(mixed[key])
        for name in names:
            os.link(os.path.join(dirs[key], name), os.path.join(mixed[key], name))
    for stem, (width, height) in {**SET14_HR, **DIV2K_HR}.items():
        name = ('set14_%s.png' if stem in SET14_HR else '%s.png') % stem
        hr, lr = synthetic_pair(rng, height, width)
        hr.save(os.path.join(mixed['hr_dir'], name))
        lr.save(os.path.join(mixed['lr_dir'], name))
        names.append(name)
    write_metadata(mixed['lr_dir'], names, rng)
    return mixed


def write_experiment(model_loc, name, seed):
    """A ready-to-evaluate experiment of MODELS[name]: config.toml +
    saved_models/train_model_0."""
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.utils import toml_io
    model, internal = MODELS[name]
    base = os.path.join(model_loc, name)
    os.makedirs(os.path.join(base, 'saved_models'))
    toml_io.dump({'model': {'name': model, 'internal_params': internal}},
                 os.path.join(base, 'config.toml'))
    handler = define_model(model, device='cpu', seed=seed, **internal)
    set_gammas(handler.module)
    handler.save_model('train_model', 0, os.path.join(base, 'saved_models'))


def phase_environment():
    """The card, the versions, the CUDA kernels built (one nvcc each, all at once) and
    whether the native host helpers (sisr_tpu_torch.native: the Pillow-exact resize
    and the PNG decoder, g++) loaded on this host, with the reason where not."""
    import torch
    from sisr_tpu_torch import native
    from sisr_tpu_torch.ops.cuda import build
    tic = time.perf_counter()
    built = build.build()
    native_tic = time.perf_counter()
    native_status = native.status()
    native_seconds = time.perf_counter() - native_tic
    from PIL import Image, features
    Image.init()
    emit({'phase': 'environment', 'nvidia_smi': nvidia_smi_line(),
          'native': native_status, 'native_build_seconds': native_seconds,
          'pil': {'save_formats': sorted(Image.SAVE), 'jpeg_codec': features.check_codec('jpg'),
                  'zlib_codec': features.check_codec('zlib')},
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'python': sys.version.split()[0], 'nvcc': build.nvcc_path(),
          'nvcc_flags': ' '.join(build.NVCC_FLAGS),
          'build_seconds': round(time.perf_counter() - tic, 3),
          'libraries': {k: {'path': os.path.relpath(v['path']),
                            'nvcc_seconds': round(v['seconds'], 3)}
                        for k, v in built.items()}})
    for name, info in built.items():
        print('[%s ptxas]\n%s' % (name, info['log'].strip()), file=sys.stderr)


def ca_inputs(shape, dtype, reduction, gen):
    """x and the excite's weights, the weights as the main path passes them:
    transposed views of conv_du's (out, in) matrices."""
    import torch
    c = shape[-1]
    cr = c // reduction
    x = torch.rand(shape, generator=gen).to(dtype).cuda()
    w1 = (torch.randn(cr, c, generator=gen) * 0.1).cuda().t()
    b1 = (torch.randn(cr, generator=gen) * 0.1).cuda()
    w2 = (torch.randn(c, cr, generator=gen) * 0.1).cuda().t()
    b2 = (torch.randn(c, generator=gen) * 0.1).cuda()
    return x, w1, b1, w2, b2


ONCHIP_KEYS = ('blocks_per_image', 'slab_pixels', 'smem_bytes')
ROUNDS_KEYS = ('rounds', 'images_per_round', 'blocks_per_image', 'slab_pixels',
               'smem_bytes')
STREAM_KEYS = ('rounds', 'blocks_per_image', 'slab_pixels', 'head_pixels', 'smem_bytes')


def path_run(op, args, **kwargs):
    """``op`` (fused_channel_attention or fused_channel_attention_residual) twice on
    ``args``: the output, the repeat, and the route both calls took by the op's route
    counts: 'onchip' (the CA's ca_onchip, or the CA + residual's rounds route, which
    its onchip_launches count), 'rounds' (the CA's rounds route), 'stream' or
    'three_pass'."""
    import torch
    counters = [c for c in ('onchip_launches', 'rounds_launches', 'stream_launches')
                if hasattr(op, c)]
    before = [getattr(op, c) for c in counters]
    out = op(*args, **kwargs)
    again = op(*args, **kwargs)
    torch.cuda.synchronize()
    took = [(c.split('_')[0], getattr(op, c) - b) for c, b in zip(counters, before)]
    taken = [route for route, k in took if k]
    if any(k not in (0, 2) for _, k in took) or len(taken) > 1:
        raise AssertionError('%s: route launches %s in 2 calls' % (op.__name__, took))
    return out, again, taken[0] if taken else 'three_pass'


def planned_ca_route(shape, cr, itemsize, m=0, device=0):
    """(route, plan as a dict) that ca_plan gives the CA on card ``device`` for a
    16-byte aligned x of ``shape``."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    props = torch.cuda.get_device_properties(device)
    n, h, w, c = shape
    route, plan = ca.ca_plan(n, h * w, c, cr, itemsize, True, props.multi_processor_count,
                             props.shared_memory_per_block_optin, m=m)
    if route == 'three_pass':
        return route, dict(zip(('vectorized', 'slabs_per_image'), ca.launch_plan(
            n, h * w, c, itemsize, True, props.multi_processor_count)))
    keys = {'onchip': ONCHIP_KEYS, 'rounds': ROUNDS_KEYS, 'stream': STREAM_KEYS}[route]
    return route, dict(zip(keys, plan))


def planned_res_route(shape, cr, x_itemsize, r_itemsize, aligned=True, m=0, device=0):
    """(route as path_run names it, plan as a dict) that ca_res_plan gives the CA +
    residual on card ``device``: 'onchip' (its rounds route), 'stream' or 'three_pass'."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    props = torch.cuda.get_device_properties(device)
    n, h, w, c = shape
    route, plan = ca.ca_res_plan(n, h * w, c, cr, x_itemsize, r_itemsize, aligned,
                                 props.multi_processor_count,
                                 props.shared_memory_per_block_optin, m=m)
    if route == 'rounds':
        return 'onchip', dict(zip(ROUNDS_KEYS, plan))
    if route == 'stream':
        return route, dict(zip(STREAM_KEYS, plan))
    return route, dict(zip(('vectorized', 'slabs_per_image'), ca.launch_plan(
        n, h * w, c, x_itemsize, aligned, props.multi_processor_count)))


def phase_kernel():
    """fused_channel_attention against reference_channel_attention, on each route.
    Each shape's route is the one ca_plan gives for this card, and all four routes
    are taken.  Tolerances: f32 1e-5 abs (summation order only); bf16 2 bf16 ULPs of
    the output (rtol 1.6e-2), since the summation order can flip how att rounds to
    bf16.  At the main shape (on chip) the on-chip kernel is timed against the
    three-pass kernel (its private launcher) in turns (the rounds route in
    phase_kernel_meta, the stream route in phase_kernel_stream)."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    gen = torch.Generator().manual_seed(0)
    props = torch.cuda.get_device_properties(0)
    shapes = [((BATCH, LR_SIZE, LR_SIZE, 64), 16), ((1, 13, 8, 32), 4),
              ((2, 16, 8, 32), 4), ((1, 512, 512, 64), 16),
              ((1, 7, 5, 20), 4), ((2, 9, 3, 18), 3), ((3, 37, 29, 64), 16)]
    checks = []
    with torch.inference_mode():
        for shape, reduction in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = ca_inputs(shape, dtype, reduction, gen)
                out, again, path = path_run(ca.fused_channel_attention, args)
                ref = ca.reference_channel_attention(*args)
                err = (out.float() - ref.float()).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
                else:
                    torch.testing.assert_close(out.float(), ref.float(), atol=1e-6,
                                               rtol=1.6e-2)
                if not torch.equal(out, again):
                    raise AssertionError('fused_channel_attention is not deterministic '
                                         'at %s %s' % (shape, dtype))
                planned, plan = planned_ca_route(shape, shape[-1] // reduction,
                                                 args[0].element_size())
                if path != planned:
                    raise AssertionError('%s %s took the %s path against plan %s %s'
                                         % (shape, dtype, path, planned, plan))
                checks.append({'shape': list(shape), 'dtype': str(dtype).split('.')[-1],
                               'path': path, 'max_abs_err': err, **plan})
        if {c['path'] for c in checks} != {'onchip', 'rounds', 'stream', 'three_pass'}:
            raise AssertionError('the shapes did not take all four routes')


        x, w1, b1, w2, b2 = ca_inputs((BATCH, LR_SIZE, LR_SIZE, 64), torch.bfloat16, 16,
                                      gen)
        out, _, path = path_run(ca.fused_channel_attention, (x, w1, b1, w2, b2))
        if path != 'onchip':
            raise AssertionError('the main shape is not on the on-chip path')
        n, h, w, c = x.shape
        plan = dict(zip(ONCHIP_KEYS, ca.onchip_plan(
            n, h * w, c, w1.shape[1], x.element_size(), True, props.multi_processor_count,
            props.shared_memory_per_block_optin)))
        kern = lambda: ca.fused_channel_attention(x, w1, b1, w2, b2)
        three_pass = lambda: ca._three_pass(x, w1, b1, w2, b2)
        plain = lambda: ca.reference_channel_attention(x, w1, b1, w2, b2)
        ref, three_out = plain().float(), three_pass().float()
        torch.testing.assert_close(three_out, ref, atol=1e-6, rtol=1.6e-2)
        err = (out.float() - ref).abs().max().item()
        three_pass_err = (three_out - ref).abs().max().item()
        timing, kern_detail = time_kernel(kern, plain, three_pass)
        # a yardstick, not the same function: one read and one write of the map
        timing['copy_ms'] = graph_ms(lambda: x.clone())
    bytes_moved, ops, bound_ms = ca_bound(x, w1)
    emit({'phase': 'kernel', 'name': 'fused_channel_attention', 'checks': checks,
          'main_shape': list(x.shape), 'dtype': 'bfloat16', 'path': path,
          'max_abs_err': err, 'three_pass_max_abs_err': three_pass_err,
          'bound_ms': bound_ms, 'bound_us': bound_ms * 1e3, 'bytes': bytes_moved, 'ops': ops,
          'device_kernels_ms_per_20_calls': kern_detail, 'nvidia_smi': nvidia_smi_line(),
          **timing})
    return {'max_abs_err': err, 'bound_ms': bound_ms, 'path': path, 'plan': plan, **timing}


def res_bound(x, r, w1):
    """Bytes, operations and the bound (ms) of the CA + residual: one read of x and of
    r, one write of out (r's type), plus the excite's weights; the pool's add, the
    multiply and the add per element plus the excite."""
    n, h, w, c = x.shape
    cr = w1.shape[1]
    bytes_moved = (x.numel() * x.element_size() + 2 * r.numel() * r.element_size()
                   + 4 * (2 * c * cr + c + cr))
    ops = 3 * x.numel() + n * (4 * c * cr + 2 * c)
    return bytes_moved, ops, max(bytes_moved / HBM_BYTES_PER_S,
                                 ops / F32_CUDA_CORE_FLOPS) * 1e3


def phase_kernel_residual():
    """fused_channel_attention_residual against reference_channel_attention_residual,
    on its three paths: x f32 (the dequantised conv output) with r bf16 (the main path) or
    f32, at the main-path shape, 7 images (a ragged last round), (3, 37, 29, 64)
    (ragged slabs), a 512^2 map, C = 18 and 20 (C = 18 takes one element a thread; C
    = 20 with r bf16 has 40-byte pixels of r, three passes) and an odd H x W; then
    with Q-RCAN's meta (M = 10) and gate, cast first and not, on each path (the main
    shape with r bf16 and f32, 7 images, a 512^2 map, a misaligned r).  Each case's
    path is the one ca_res_plan gives for this card (the 512^2 map streams), and all
    three paths are taken.
    Tolerances: f32 out 1e-5 abs (summation order only); bf16 out 2 bf16 ULPs (rtol
    1.6e-2) of the output or, cast first, of the bf16 branch, since the pool's
    summation order can flip a rounding.  At the main shape (on chip) the on-chip
    kernel is timed against the three-pass kernel (its private launcher) in turns; and
    int8 Q-RCAN's one-launch QRCAB tail (x f32, r bf16, meta and gate, cast first) in turns
    against the sequence it replaces: the three-pass CA with meta and gate, then
    ``.to(bf16)``, then ``+ r``."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    op = ca.fused_channel_attention_residual
    gen = torch.Generator().manual_seed(1)
    props = torch.cuda.get_device_properties(0)
    main_shape = (BATCH, LR_SIZE, LR_SIZE, 64)
    cases = [(main_shape, 16, torch.bfloat16), (main_shape, 16, torch.float32),
             ((7, LR_SIZE, LR_SIZE, 64), 16, torch.bfloat16),
             ((3, 37, 29, 64), 16, torch.bfloat16),
             ((1, 512, 512, 64), 16, torch.bfloat16), ((2, 9, 3, 18), 3, torch.bfloat16),
             ((1, 7, 5, 20), 4, torch.float32), ((1, 7, 5, 20), 4, torch.bfloat16),
             ((1, 13, 7, 32), 4, torch.bfloat16)]

    def inputs(shape, reduction, r_dtype):
        x, w1, b1, w2, b2 = ca_inputs(shape, torch.float32, reduction, gen)
        x = (x - 0.5) * 4  # a conv output: signed
        r = torch.rand(shape, generator=gen).to(r_dtype).cuda()
        return x, r, w1, b1, w2, b2

    def plan_of(args, out, m=0):
        x, r, w1 = args[:3]
        if ca.res_onchip_aligned(x, r, out):
            return planned_res_route(x.shape, w1.shape[1], x.element_size(),
                                     r.element_size(), m=m)
        n, h, w, c = x.shape
        return 'three_pass', dict(zip(('vectorized', 'slabs_per_image'), ca.launch_plan(
            n, h * w, c, x.element_size(), ca.residual_aligned(x, r, out),
            props.multi_processor_count)))

    def check(out, ref, r_dtype, r=None):
        if r_dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        elif r is None:
            torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)
        else:  # cast first: 2 ULPs of the bf16 branch, |branch| <= |out| + |r|
            err = (out.float() - ref.float()).abs()
            if not bool((err <= 1.6e-2 * (ref.float().abs() + r.float().abs())
                         + 1e-6).all()):
                raise AssertionError('cast-first tail: max err %g' % err.max().item())

    def tail_inputs(shape, r_dtype, offset=0):
        """x f32 (signed), r (``offset`` elements into its storage), the weights with
        w1 (C + 10, Cr), meta (N, 10) and gate (N, C)."""
        (x, w1, b1, w2, b2), extra = meta_gate_inputs(shape, torch.float32, gen)
        r = torch.rand(int(x.numel()) + offset, generator=gen).to(r_dtype).cuda()
        return ((x - 0.5) * 4, r[offset:].view(shape), w1, b1, w2, b2), extra

    checks = []
    with torch.inference_mode():
        for shape, reduction, r_dtype in cases:
            args = inputs(shape, reduction, r_dtype)
            out, again, path = path_run(op, args)
            ref = ca.reference_channel_attention_residual(*args)
            if out.dtype != r_dtype:
                raise AssertionError('CA + residual output is %s, not r\'s %s'
                                     % (out.dtype, r_dtype))
            check(out, ref, r_dtype)
            if not torch.equal(out, again):
                raise AssertionError('fused_channel_attention_residual is not '
                                     'deterministic at %s r %s' % (shape, r_dtype))
            planned, plan = plan_of(args, out)
            if path != planned:
                raise AssertionError('%s r %s took the %s path against plan %s'
                                     % (shape, r_dtype, path, plan))
            checks.append({'shape': list(shape), 'x_dtype': 'float32',
                           'r_dtype': str(r_dtype).split('.')[-1], 'path': path,
                           'max_abs_err': (out.float() - ref.float()).abs().max().item(),
                           **plan})
        if {c['path'] for c in checks} != {'onchip', 'stream', 'three_pass'}:
            raise AssertionError('the CA + residual cases did not take all three paths')

        tail_checks = []
        for shape, r_dtype, offset, cast_first in (
                (main_shape, torch.bfloat16, 0, True), (main_shape, torch.float32, 0, True),
                (main_shape, torch.bfloat16, 0, False),
                ((7, LR_SIZE, LR_SIZE, 64), torch.bfloat16, 0, True),
                ((1, 512, 512, 64), torch.bfloat16, 0, True),
                ((2, 16, 8, 64), torch.bfloat16, 2, True)):
            args, extra = tail_inputs(shape, r_dtype, offset)
            out, again, path = path_run(op, args, cast_first=cast_first, **extra)
            ref = ca.reference_channel_attention_residual(*args, cast_first=cast_first,
                                                          **extra)
            check(out, ref, r_dtype, args[1] if cast_first else None)
            if out.dtype != r_dtype or not torch.equal(out, again):
                raise AssertionError('CA + residual with meta/gate at %s r %s: type %s or '
                                     'not deterministic' % (shape, r_dtype, out.dtype))
            planned, plan = plan_of(args, out, m=META_COLS)
            if path != planned:
                raise AssertionError('meta/gate tail %s r %s took the %s path against plan '
                                     '%s' % (shape, r_dtype, path, plan))
            tail_checks.append({'shape': list(shape), 'r_dtype': str(r_dtype).split('.')[-1],
                                'r_offset': offset, 'cast_first': cast_first,
                                'meta_values': META_COLS, 'gate': True, 'path': path,
                                'max_abs_err': (out.float() - ref.float()).abs().max().item(),
                                **plan})
        if {c['path'] for c in tail_checks} != {'onchip', 'stream', 'three_pass'}:
            raise AssertionError('the meta/gate tail cases did not take all three paths')

        # int8 Q-RCAN's QRCAB tail: one launch against the three-pass CA, cast and add
        (x, r, w1, b1, w2, b2), extra = tail_inputs(main_shape, torch.bfloat16)
        tail = lambda: op(x, r, w1, b1, w2, b2, cast_first=True, **extra)
        sequence = lambda: ca._three_pass(x, w1, b1, w2, b2, **extra).to(r.dtype) + r
        plain = lambda: ca.reference_channel_attention_residual(x, r, w1, b1, w2, b2,
                                                                cast_first=True, **extra)
        ref = plain()
        tail_out, seq_out = tail(), sequence()
        check(tail_out, ref, r.dtype, r)
        check(seq_out, ref, r.dtype, r)
        tail_timing = {}
        for name, fn in (('sequence_ms', sequence), ('ms', tail), ('ms', tail),
                         ('sequence_ms', sequence)):
            tail_timing[name] = graph_ms(fn)  # the second turn of each is kept
        tail_timing['plain_ms'] = graph_ms(plain)
        tail_bytes, tail_ops, _ = res_bound(x, r, w1)
        tail_bytes += 4 * (x.shape[0] * (META_COLS + 64) + META_COLS * w1.shape[1])
        tail_ops += x.shape[0] * (2 * META_COLS * w1.shape[1] + 64)
        tail_timing.update({
            'shape': list(x.shape), 'x_dtype': 'float32', 'r_dtype': 'bfloat16',
            'meta_values': META_COLS, 'gate': True, 'cast_first': True,
            'plan': plan_of((x, r, w1), tail_out, m=META_COLS)[1],
            'max_abs_err': (tail_out.float() - ref.float()).abs().max().item(),
            'sequence_max_abs_err': (seq_out.float() - ref.float()).abs().max().item(),
            'bytes': tail_bytes, 'ops': tail_ops,
            'bound_ms': max(tail_bytes / HBM_BYTES_PER_S, tail_ops / F32_CUDA_CORE_FLOPS) * 1e3})
        tail_timing['tail_over_sequence'] = tail_timing['ms'] / tail_timing['sequence_ms']

        x, r, w1, b1, w2, b2 = inputs(main_shape, 16, torch.bfloat16)
        out, _, path = path_run(op, (x, r, w1, b1, w2, b2))
        if path != 'onchip':
            raise AssertionError('the main shape is not on the on-chip path')
        kern = lambda: op(x, r, w1, b1, w2, b2)
        three_pass = lambda: ca._res_three_pass(x, r, w1, b1, w2, b2)
        plain = lambda: ca.reference_channel_attention_residual(x, r, w1, b1, w2, b2)
        ref, three_out = plain().float(), three_pass().float()
        check(three_out, ref, torch.bfloat16)
        err = (out.float() - ref).abs().max().item()
        three_pass_err = (three_out - ref).abs().max().item()
        timing, kern_detail = time_kernel(kern, plain, three_pass)
        # a yardstick, not the same function: a copy of x moves the same 67.1 MB
        timing['copy_ms'] = graph_ms(lambda: x.clone())
        plan = plan_of((x, r, w1), out)[1]
    bytes_moved, ops, bound_ms = res_bound(x, r, w1)
    emit({'phase': 'kernel', 'name': 'fused_channel_attention_residual', 'checks': checks,
          'main_shape': list(x.shape), 'x_dtype': 'float32', 'r_dtype': 'bfloat16',
          'path': path, 'plan': plan, 'max_abs_err': err,
          'three_pass_max_abs_err': three_pass_err, 'bound_ms': bound_ms,
          'bound_us': bound_ms * 1e3, 'bytes': bytes_moved, 'ops': ops,
          'onchip_over_three_pass': timing['ms'] / timing['three_pass_ms'],
          'device_kernels_ms_per_20_calls': kern_detail, 'meta_gate_checks': tail_checks,
          'qrcab_tail': tail_timing, 'nvidia_smi': nvidia_smi_line(), **timing})
    return {'max_abs_err': err, 'three_pass_max_abs_err': three_pass_err,
            'bound_ms': bound_ms, 'path': path, 'plan': plan, 'qrcab_tail': tail_timing,
            **timing}


def meta_gate_inputs(shape, dtype, gen):
    """x and the excite's weights as Q-RCAN's max_concat QCALayer passes them (w1 with
    C + 10 rows, transposed views of conv_du's matrices), with meta (N, 10) (blur
    kernels, Dirichlet-like rows) and gate (N, C) (a q_node's sigmoid)."""
    import torch
    n, c = shape[0], shape[-1]
    x, _, b1, w2, b2 = ca_inputs(shape, dtype, 16, gen)
    w1 = (torch.randn(c // 16, c + META_COLS, generator=gen) * 0.1).cuda().t()
    meta = torch.rand(n, META_COLS, generator=gen)
    meta = (meta / meta.sum(dim=1, keepdim=True)).cuda()
    gate = torch.sigmoid(torch.randn(n, c, generator=gen)).cuda()
    return (x, w1, b1, w2, b2), {'meta': meta, 'gate': gate}


def phase_kernel_meta():
    """fused_channel_attention with meta (M = 10: w1 is 74 x 4 at C = 64) and gate
    against reference_channel_attention with the same, on each route: the main shape
    in bf16 (on chip, as the Q-RCAN main path takes it), in f32 (in rounds: the map of
    int8 Q-RCAN's QRCAB tail and of the f32 eval) and one 512^2 bf16 map (streaming).
    Tolerances as phase_kernel's: f32 1e-5 abs, bf16 2 ULPs; the same bits on a rerun.
    Each is timed in graph replay beside the meta-less call on the same x and the
    first C rows of w1, in turns (meta-less, meta, meta, meta-less), and beside its
    plain version; the f32 case also against the three passes (its private
    launcher) with and without meta, in turns, each with its bound.  Returns the
    cases' results."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    op = ca.fused_channel_attention
    gen = torch.Generator().manual_seed(4)
    cases = [((BATCH, LR_SIZE, LR_SIZE, 64), torch.bfloat16, 'onchip'),
             ((BATCH, LR_SIZE, LR_SIZE, 64), torch.float32, 'rounds'),
             ((1, 512, 512, 64), torch.bfloat16, 'stream')]
    results = []
    with torch.inference_mode():
        for shape, dtype, expect in cases:
            args, extra = meta_gate_inputs(shape, dtype, gen)
            out, again, path = path_run(op, args, **extra)
            planned, plan = planned_ca_route(shape, shape[-1] // 16,
                                             args[0].element_size(), m=META_COLS)
            if path != expect or path != planned:
                raise AssertionError('meta/gate %s %s took the %s path (plan %s %s)'
                                     % (shape, dtype, path, planned, plan))
            ref = ca.reference_channel_attention(*args, **extra)
            if dtype == torch.float32:
                torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
            else:
                torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)
            if not torch.equal(out, again):
                raise AssertionError('meta/gate %s %s is not deterministic' % (shape, dtype))
            x, w1, b1, w2, b2 = args
            kern = lambda args=args, extra=extra: op(*args, **extra)
            bare = lambda x=x, w1=w1[:shape[-1]], b1=b1, w2=w2, b2=b2: op(x, w1, b1, w2, b2)
            plain = lambda args=args, extra=extra: ca.reference_channel_attention(*args,
                                                                                  **extra)
            turns, extra_err = [('no_meta_ms', bare), ('ms', kern)], {}
            if path == 'rounds':
                three = lambda args=args, extra=extra: ca._three_pass(*args, **extra)
                bare_three = lambda x=x, w1=w1[:shape[-1]], b1=b1, w2=w2, b2=b2: \
                    ca._three_pass(x, w1, b1, w2, b2)
                three_out = three()
                torch.testing.assert_close(three_out, ref, atol=1e-5, rtol=0)
                extra_err['three_pass_max_abs_err'] = (three_out - ref).abs().max().item()
                turns = [('three_pass_ms', three), ('no_meta_three_pass_ms', bare_three)] \
                    + turns
            timing = {}
            for name, fn in turns + turns[::-1]:
                timing[name] = graph_ms(fn)  # the second turn of each is kept
            timing['plain_ms'] = graph_ms(plain)
            no_meta_bytes, no_meta_ops, no_meta_bound = ca_bound(x, w1[:shape[-1]])
            n, c = shape[0], shape[-1]
            bytes_moved = no_meta_bytes + 4 * (n * (META_COLS + c) + META_COLS * w1.shape[1])
            ops = no_meta_ops + n * (2 * META_COLS * w1.shape[1] + c)
            results.append({'shape': list(shape), 'dtype': str(dtype).split('.')[-1],
                            'path': path, 'plan': plan, 'max_abs_err':
                            (out.float() - ref.float()).abs().max().item(),
                            'bytes': bytes_moved, 'ops': ops,
                            'bound_ms': max(bytes_moved / HBM_BYTES_PER_S,
                                            ops / F32_CUDA_CORE_FLOPS) * 1e3,
                            'no_meta_bound_ms': no_meta_bound, **extra_err, **timing})
    emit({'phase': 'kernel', 'name': 'fused_channel_attention meta+gate',
          'meta_values': META_COLS, 'cases': results, 'nvidia_smi': nvidia_smi_line()})
    return results


# the CA op's valid-extent pool (bucketed eval), one case per route: the 512 x 384
# bucket of a DIV2K-size 510 x 339 LR image in bf16 (on chip) and f32 (streaming),
# the f32 eval batch of 128^2 maps with a (100, 120) extent (in rounds), and 40-byte
# pixels (three passes)
EXTENT_CASES = (((1, 384, 512, 64), (339, 510), 'bfloat16', 'onchip'),
                ((1, 384, 512, 64), (339, 510), 'float32', 'stream'),
                ((BATCH, LR_SIZE, LR_SIZE, 64), (100, 120), 'float32', 'rounds'),
                ((1, 7, 5, 20), (4, 3), 'bfloat16', 'three_pass'))


def phase_kernel_extent():
    """fused_channel_attention with a valid extent (``valid_hw``) against
    reference_channel_attention with the same, on each route of EXTENT_CASES (each
    route checked against ca_plan), without and with Q-RCAN's meta (M = 10) and gate;
    the pad region holds garbage the pool must skip.  Tolerances as phase_kernel's:
    f32 1e-5 abs, bf16 2 ULPs; the same bits on a rerun; the full extent bit-equal to
    no extent; every call counted in masked_launches.  Each case is timed in graph
    replay with and without the extent on the same x, in turns (without, with, with,
    without), beside its plain version; its bound reads and writes the whole map and
    pools the valid pixels only."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    op = ca.fused_channel_attention
    gen = torch.Generator().manual_seed(11)
    results = []
    with torch.inference_mode():
        for shape, valid, dtype_name, expect in EXTENT_CASES:
            dtype = getattr(torch, dtype_name)
            for with_meta in (False, True):
                if with_meta:
                    args, extra = meta_gate_inputs(shape, dtype, gen)
                else:
                    args, extra = ca_inputs(shape, dtype, 16, gen), {}
                x = args[0]
                x[:, valid[0]:] += 3
                x[:, :, valid[1]:] += 3
                masked = op.masked_launches
                out, again, path = path_run(op, args, valid_hw=valid, **extra)
                m = META_COLS if with_meta else 0
                planned, plan = planned_ca_route(shape, shape[-1] // 16, x.element_size(),
                                                 m=m)
                if path != expect or path != planned:
                    raise AssertionError('extent %s %s took the %s path (plan %s %s)'
                                         % (shape, dtype, path, planned, plan))
                if op.masked_launches - masked != 2:
                    raise AssertionError('masked_launches counted %d of 2 calls'
                                         % (op.masked_launches - masked))
                ref = ca.reference_channel_attention(*args, valid_hw=valid, **extra)
                if dtype == torch.float32:
                    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
                else:
                    torch.testing.assert_close(out.float(), ref.float(), atol=1e-6,
                                               rtol=1.6e-2)
                full = op(*args, valid_hw=shape[1:3], **extra)
                bare = op(*args, **extra)
                if not torch.equal(out, again) or not torch.equal(full, bare):
                    raise AssertionError('extent %s %s: a rerun or the full extent '
                                         'differs' % (shape, dtype))
                kern = lambda args=args, extra=extra: op(*args, valid_hw=valid, **extra)
                unmasked = lambda args=args, extra=extra: op(*args, **extra)
                plain = lambda args=args, extra=extra: ca.reference_channel_attention(
                    *args, valid_hw=valid, **extra)
                turns, timing = [('unmasked_ms', unmasked), ('ms', kern)], {}
                for name, fn in turns + turns[::-1]:
                    timing[name] = graph_ms(fn)  # the second turn of each is kept
                timing['plain_ms'] = graph_ms(plain)
                n, h, w, c = shape
                cr = args[1].shape[1]
                bytes_moved = (2 * x.numel() * x.element_size()
                               + 4 * ((2 * c + m) * cr + c + cr + n * (m + c) * with_meta))
                ops = (n * valid[0] * valid[1] * c + x.numel()
                       + n * (2 * (c + m) * cr + 2 * cr * c + 2 * c))
                results.append({'shape': list(shape), 'valid_hw': list(valid),
                                'dtype': dtype_name, 'meta_gate': with_meta, 'path': path,
                                'plan': plan, 'max_abs_err':
                                (out.float() - ref.float()).abs().max().item(),
                                'bytes': bytes_moved, 'ops': ops, 'bound_by': 'bytes'
                                if bytes_moved / HBM_BYTES_PER_S >= ops / F32_CUDA_CORE_FLOPS
                                else 'operations',
                                'bound_ms': max(bytes_moved / HBM_BYTES_PER_S,
                                                ops / F32_CUDA_CORE_FLOPS) * 1e3, **timing})
    emit({'phase': 'kernel', 'name': 'fused_channel_attention valid extent',
          'cases': results, 'nvidia_smi': nvidia_smi_line()})
    return results


# the stream route's shapes, f32: a DIV2K validation image's LR map (x of the int8 RCAB
# tail under --int8 and of the f32 Q-RCAN forward, in the standard protocol) and its
# 512 x 384 bucket
STREAM_SHAPES = ((1, 339, 510, 64), (1, 384, 512, 64))


def phase_kernel_stream():
    """The stream route (``ca_stream``) of both ops against their plain versions at
    STREAM_SHAPES, x f32: the CA bare, with Q-RCAN's gate (the f32 recipe's standard
    style with a q_node), with meta (M = 10) and gate, with a valid extent (bare and
    with meta and gate); the CA + residual with r bf16 (int8 RCAN's tail) and f32,
    plain, and cast first with meta and gate.  Every call on the stream route (the plan
    and the launch counts), within 1e-5 abs (f32 out) or 2 bf16 ULPs (of the output,
    or cast first of the bf16 branch), the same bits on a rerun and the full extent
    bit-equal to none.  At each shape, in turns: the CA with the gate and the tail
    with r bf16 against their three passes (private launchers; three-pass, stream,
    stream, three-pass: the second turn of each is kept), beside their plain versions,
    each with its bound.  Returns {'ca': [...], 'res': [...]}: the timings at each
    shape, the first at (1, 339, 510, 64)."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    gen = torch.Generator().manual_seed(21)
    checks, timings = [], {'ca': [], 'res': []}

    def check(out, ref, r=None):
        """f32 within 1e-5; bf16 within 2 ULPs of out or, given the cast-first tail's
        r, of its bf16 branch (|branch| <= |out| + |r|)."""
        if out.dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        elif r is None:
            torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)
        else:
            err = (out.float() - ref.float()).abs()
            if not bool((err <= 1.6e-2 * (ref.float().abs() + r.float().abs())
                         + 1e-6).all()):
                raise AssertionError('stream tail: max err %g' % err.max().item())

    with torch.inference_mode():
        for shape in STREAM_SHAPES:
            (x, w1m, b1, w2, b2), mg = meta_gate_inputs(shape, torch.float32, gen)
            x = (x - 0.5) * 4  # a conv output: signed
            w1 = w1m[:shape[-1]]  # the CA without meta: the first C rows
            gate = {'gate': mg['gate']}
            valid = (shape[1] * 7 // 8, shape[2] * 5 // 6)  # edges mid-slab
            r16 = torch.rand(shape, generator=gen).to(torch.bfloat16).cuda()
            r32 = torch.rand(shape, generator=gen).cuda()
            bare, with_meta = (x, w1, b1, w2, b2), (x, w1m, b1, w2, b2)
            cases = [('ca', None, bare, {}), ('ca_gate', None, bare, gate),
                     ('ca_meta_gate', None, with_meta, mg),
                     ('ca_extent', None, bare, {'valid_hw': valid}),
                     ('ca_extent_meta_gate', None, with_meta, {**mg, 'valid_hw': valid})]
            for r, tag in ((r16, 'bf16'), (r32, 'f32')):
                cases += [('res_' + tag, r, bare, {}),
                          ('res_%s_meta_gate_cast_first' % tag, r, with_meta,
                           {**mg, 'cast_first': True})]
            for name, r, args, kw in cases:
                m = META_COLS if 'meta' in kw else 0
                if r is None:
                    op, full_args = ca.fused_channel_attention, args
                    planned, plan = planned_ca_route(shape, 4, 4, m=m)
                    ref = ca.reference_channel_attention(*args, **kw)
                else:
                    op, full_args = ca.fused_channel_attention_residual, (x, r) + args[1:]
                    planned, plan = planned_res_route(shape, 4, 4, r.element_size(), m=m)
                    ref = ca.reference_channel_attention_residual(*full_args, **kw)
                out, again, path = path_run(op, full_args, **kw)
                if path != 'stream' or planned != 'stream':
                    raise AssertionError('stream %s %s took %s (plan %s %s)'
                                         % (name, shape, path, planned, plan))
                check(out, ref, r if kw.get('cast_first') else None)
                if not torch.equal(out, again):
                    raise AssertionError('stream %s %s is not deterministic' % (name, shape))
                if 'valid_hw' in kw:
                    full = op(*full_args, **{**kw, 'valid_hw': shape[1:3]})
                    if not torch.equal(full, op(*full_args, **{k: v for k, v in kw.items()
                                                              if k != 'valid_hw'})):
                        raise AssertionError('stream %s: the full extent differs from none'
                                             % name)
                checks.append({'shape': list(shape), 'case': name, 'path': path,
                               'max_abs_err': (out.float() - ref.float()).abs().max().item(),
                               **plan})

            # in turns against the three passes
            for key, r in (('ca', None), ('res', r16)):
                if r is None:
                    kern = lambda: ca.fused_channel_attention(*bare, **gate)
                    three = lambda: ca._three_pass(*bare, **gate)
                    plain = lambda: ca.reference_channel_attention(*bare, **gate)
                    bytes_moved, ops, _ = ca_bound(x, w1)
                    bytes_moved += 4 * x.shape[0] * x.shape[-1]  # the gate
                    plan = planned_ca_route(shape, 4, 4)[1]
                else:
                    kern = lambda r=r: ca.fused_channel_attention_residual(x, r, *bare[1:])
                    three = lambda r=r: ca._res_three_pass(x, r, *bare[1:])
                    plain = lambda r=r: ca.reference_channel_attention_residual(x, r,
                                                                                *bare[1:])
                    bytes_moved, ops, _ = res_bound(x, r, w1)
                    plan = planned_res_route(shape, 4, 4, 2)[1]
                ref = plain()
                three_out = three()
                check(three_out, ref)
                timing = {}
                for name, fn in (('three_pass_ms', three), ('ms', kern), ('ms', kern),
                                 ('three_pass_ms', three)):
                    timing[name] = graph_ms(fn)  # the second turn of each is kept
                timing['plain_ms'] = graph_ms(plain)
                bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_CUDA_CORE_FLOPS) * 1e3
                timings[key].append({
                    'shape': list(shape), 'x_dtype': 'float32',
                    'r_dtype': None if r is None else 'bfloat16', 'gate': r is None,
                    'plan': plan, 'bytes': bytes_moved, 'ops': ops, 'bound_ms': bound_ms,
                    'bound_by': 'bytes' if bytes_moved / HBM_BYTES_PER_S
                    >= ops / F32_CUDA_CORE_FLOPS else 'operations',
                    'max_abs_err': (kern().float() - ref.float()).abs().max().item(),
                    'three_pass_max_abs_err': (three_out.float() - ref.float()).abs().max()
                    .item(), 'share_of_bound': bound_ms / timing['ms'],
                    'stream_over_three_pass': timing['ms'] / timing['three_pass_ms'],
                    **timing})
    emit({'phase': 'kernel', 'name': 'ca_stream (both ops)', 'checks': checks,
          'timings': timings, 'nvidia_smi': nvidia_smi_line()})
    return timings


def largest_set14_lr():
    """The LR shape (h, w) of the mixed set's largest Set14 image."""
    return max(((h // SCALE, w // SCALE) for w, h in SET14_HR.values()),
               key=lambda hw: hw[0] * hw[1])


def phase_kernel_batch1():
    """Row 1a (``ca_onchip``) at the standard protocol's batch-1 bf16 maps: one 128^2 LR
    image, the largest Set14 LR shape of the mixed set, and the DIV2K-size 510 x 339:
    on chip by the plan, within 2 bf16 ULPs of the plain version, timed in turns
    against it (plain, kernel, kernel, plain), with its bound."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    gen = torch.Generator().manual_seed(23)
    rows = []
    with torch.inference_mode():
        for hw in ((LR_SIZE, LR_SIZE), largest_set14_lr(), DIV2K_LR):
            shape = (1,) + hw + (64,)
            args = ca_inputs(shape, torch.bfloat16, 16, gen)
            out, again, path = path_run(ca.fused_channel_attention, args)
            planned, plan = planned_ca_route(shape, 4, 2)
            if path != 'onchip' or planned != 'onchip' or not torch.equal(out, again):
                raise AssertionError('batch-1 %s took %s (plan %s %s) or is not '
                                     'deterministic' % (shape, path, planned, plan))
            ref = ca.reference_channel_attention(*args)
            torch.testing.assert_close(out.float(), ref.float(), atol=1e-6, rtol=1.6e-2)
            kern = lambda args=args: ca.fused_channel_attention(*args)
            plain = lambda args=args: ca.reference_channel_attention(*args)
            timing = {}
            for name, fn in (('plain_ms', plain), ('ms', kern), ('ms', kern),
                             ('plain_ms', plain)):
                timing[name] = graph_ms(fn)  # the second turn of each is kept
            bytes_moved, ops, bound_ms = ca_bound(args[0], args[1])
            rows.append({'shape': list(shape), 'dtype': 'bfloat16', 'plan': plan,
                         'max_abs_err': (out.float() - ref.float()).abs().max().item(),
                         'bytes': bytes_moved, 'bound_ms': bound_ms,
                         'share_of_bound': bound_ms / timing['ms'], **timing})
    emit({'phase': 'kernel', 'name': 'ca_onchip at batch-1 maps', 'cases': rows,
          'nvidia_smi': nvidia_smi_line()})
    return rows


def module_input(handler, x, meta=None, device=None, hr_hw=None):
    """(the module's input, its metadata input) as the handler's _prep_batch makes them
    from an f32 NHWC LR batch and its raw metadata (SRMD's with the maps concatenated;
    given ``hr_hw``, a pre-upscaled family's LR upscaled to it on the device first, and
    its Y channel for SRCNN and VDSR), moved to ``device`` first when given."""
    if device is not None:
        x, meta = x.to(device), None if meta is None else meta.to(device)
    if hr_hw is not None and handler.im_input == 'interp':
        from sisr_tpu_torch.ops.resize import resize_bicubic
        x = handler._module_image(resize_bicubic(x, *hr_hw))
    inp, _, module_meta = handler._prep_batch({'lr': x, 'metadata': meta})
    return inp, module_meta


def phase_reference(name='rcan_10x20', seed=3):
    """Full-width MODELS[name] (seeded weights; HAN's gammas, SAN's gamma and W set) on a
    32^2 LR input in f32 (with 10 seeded metadata values per image for the Q-models; a
    pre-upscaled family on it upscaled to 128^2, SRCNN and VDSR on its Y channel): the
    card (CUDA kernels, cuDNN, cuBLAS) against the CPU (plain versions), in eval mode.
    Forward <= 5e-4 abs; fused-eval PSNR within 0.01 dB and SSIM within 1e-3; SAN,
    Q-SAN, SRMD, SFTMD and the pre-upscaled families launch neither CA op.  A model
    with BatchNorms (SPARNet, Q-SPARNet) also runs one train-mode forward on each side
    (the batch's statistics): the outputs within 5e-4 of their largest magnitude, the
    running statistics it leaves within 1e-4 of each other's."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    model, internal = MODELS[name]
    f32 = {**internal, 'dtype': 'f32'}
    card = define_model(model, device='cuda', seed=seed, **f32)
    host = define_model(model, device='cpu', seed=seed, **f32)
    for handler in (card, host):
        set_gammas(handler.module)
    rng = np.random.RandomState(5)
    lr = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    hr = rng.randint(0, 256, (2, 32 * SCALE, 32 * SCALE, 3)).astype(np.uint8)
    batch = {'lr': lr, 'hr': hr}
    x = torch.from_numpy(lr).float() / 255.0
    meta = None
    if card.uses_metadata:
        batch['metadata'] = rng.dirichlet(np.ones(META_COLS) * 5, 2).astype(np.float32)
        for handler in (card, host):
            handler.set_metadata_keys(['blur_kernel'] * META_COLS)
        meta = torch.from_numpy(batch['metadata'])
    hr_hw = (32 * SCALE, 32 * SCALE)
    reset_launches()
    for handler in (card, host):
        handler._set_training(False)
    with torch.inference_mode():
        out_card = card.forward(*module_input(card, x, meta, 'cuda', hr_hw)).cpu()
        out_host = host.forward(*module_input(host, x, meta, hr_hw=hr_hw))
    fwd_err = (out_card - out_host).abs().max().item()
    train_mode = {}
    norms = [m for m in host.module.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if norms:
        for handler in (card, host):
            handler._set_training(True)
        with torch.no_grad():
            t_card = card.forward(*module_input(card, x, meta, 'cuda', hr_hw)).cpu()
            t_host = host.forward(*module_input(host, x, meta, hr_hw=hr_hw))
        card_norms = [m for m in card.module.modules()
                      if isinstance(m, torch.nn.BatchNorm2d)]
        stats_err = max((c.running_var.cpu() - h.running_var).abs().max().item()
                        / max(1.0, h.running_var.abs().max().item())
                        for c, h in zip(card_norms, norms))
        train_mode = {'train_forward_max_abs_err': (t_card - t_host).abs().max().item(),
                      'train_output_max_abs': t_host.abs().max().item(),
                      'batchnorms': len(norms), 'running_var_max_rel_err': stats_err}
        if not train_mode['train_forward_max_abs_err'] <= \
                5e-4 * max(1.0, train_mode['train_output_max_abs']) or stats_err > 1e-4:
            raise AssertionError('%s train-mode forward on the card disagrees with the '
                                 'CPU: %s' % (name, train_mode))
    (keys, m_card), _ = card.run_eval_fused(batch)
    (_, m_host), _ = host.run_eval_fused(batch)
    if model in NO_CA_MODELS:
        torch.cuda.synchronize()
        expect_launches(read_launches(), NO_LAUNCHES, '%s reference' % name)
    m_card, m_host = m_card.cpu().numpy(), m_host.numpy()
    diff = {k: float(np.abs(m_card[i] - m_host[i]).max()) for i, k in enumerate(keys)}
    emit({'phase': 'reference', 'model': name, 'forward_max_abs_err': fwd_err,
          'metric_max_abs_diff': diff, 'output_shape': list(out_card.shape), **train_mode})
    if not np.isfinite(out_card.numpy()).all() or fwd_err > 5e-4:
        raise AssertionError('%s forward on the card disagrees with the CPU: %g'
                             % (name, fwd_err))
    for i, k in enumerate(keys):
        bar = 0.01 if k.endswith('PSNR') else 1e-3
        if not diff[k] <= bar:
            raise AssertionError('%s fused eval %s on the card is %g from the CPU'
                                 % (name, k, diff[k]))


def phase_holistic_attention():
    """HAN's LAM and CSAM alone (the port's modules, GAMMAS, CSAM's conv seeded), at the
    fused eval's shapes: LAM over 11 maps of (8, 128, 128, 64) (0.05 * U(0, 1): energies
    near 870 that differ by about 1, so the softmax mixes the layers), CSAM on one map,
    in f32 with TF32 off, card (cuBLAS, cuDNN) against the CPU: LAM <= 5e-5 abs (the
    bar of the CPU tests: the gram's summation order moves the energies), CSAM
    <= 1e-5.  Then each on the card in bf16 (the fused eval's type) and f32
    (training's), CUDA-event ms a call, beside the bound of its bytes (the maps read
    once, the output written once) and of LAM's two f32 products."""
    import torch
    from sisr_tpu_torch.models.advanced import CSAM, LAM
    from sisr_tpu_torch.models.blocks import torch_default_init_
    gen = torch.Generator().manual_seed(9)
    shape = (BATCH, LR_SIZE, LR_SIZE, 64)
    n_maps = HAN['n_resgroups'] + 1
    maps = [0.05 * torch.rand(shape, generator=gen) for _ in range(n_maps)]
    vol = torch.randn(shape, generator=gen)
    lam, csam = LAM(), torch_default_init_(CSAM(), gen)
    with torch.no_grad():
        lam.gamma.fill_(GAMMAS['la'])
        csam.gamma.fill_(GAMMAS['csa'])

    def calls(device, dtype):
        lam.to(device)
        csam.to(device)
        nchw = [m.to(device, dtype).permute(0, 3, 1, 2) for m in maps]
        x = vol.to(device, dtype).permute(0, 3, 1, 2)
        return lambda: lam(nchw), lambda: csam(x)

    report = {'phase': 'holistic_attention', 'lam_shape': [BATCH, n_maps] + list(shape[1:]),
              'csam_shape': list(shape)}
    with torch.inference_mode():
        host = [fn().permute(0, 2, 3, 1) for fn in calls('cpu', torch.float32)]
        card = [fn().permute(0, 2, 3, 1).cpu() for fn in calls('cuda', torch.float32)]
        for key, a, b in (('lam', card[0], host[0]), ('csam', card[1], host[1])):
            report[key + '_max_abs_err'] = (a - b).abs().max().item()
        map_bytes = BATCH * LR_SIZE ** 2 * 64
        lam_flops = 2 * 2 * BATCH * n_maps ** 2 * LR_SIZE ** 2 * 64
        for dtype, itemsize in ((torch.bfloat16, 2), (torch.float32, 4)):
            tag = str(dtype).split('.')[-1]
            lam_fn, csam_fn = calls('cuda', dtype)
            report['lam_%s_ms' % tag] = cuda_ms(lam_fn, reps=10, rounds=3)
            report['csam_%s_ms' % tag] = cuda_ms(csam_fn, reps=10, rounds=3)
            report['lam_%s_bound_ms' % tag] = max(
                2 * n_maps * map_bytes * itemsize / HBM_BYTES_PER_S,
                lam_flops / F32_CUDA_CORE_FLOPS) * 1e3
            report['csam_%s_bound_ms' % tag] = 2 * map_bytes * itemsize / HBM_BYTES_PER_S * 1e3
    report['nvidia_smi'] = nvidia_smi_line()
    emit(report)
    for key, bar in (('lam', 5e-5), ('csam', 1e-5)):
        if not report[key + '_max_abs_err'] <= bar:
            raise AssertionError('%s on the card is %g from the CPU'
                                 % (key, report[key + '_max_abs_err']))


def phase_san_attention():
    """SAN's SOCA and non-local block alone (the port's modules, seeded: SOCA at
    reduction 16, NonlocalCA 64 -> 8 channels with W drawn), at the fused eval's shape:
    SOCA on one (8, 128, 128, 64) map (N(0, 1)), NonlocalCA on one (its four 64^2
    quadrants), in f32 with TF32 off, card (cuBLAS, cuDNN) against the CPU: each
    <= 1e-5 abs; neither launches a CA op.  Then each on the card in bf16 (the fused
    eval's type, under autocast: the covariance, the square root and the logits stay
    f32) and f32 (training's), CUDA-event ms a call, beside its bound: the map read
    once and written once at the HBM rate, or the f32 products (SOCA's covariance,
    2 B M C^2; the non-local logits, 2 B M_q (M_q / 4) I per quadrant, and the
    attention's product as many, at the f32 rate without TF32), whichever is longer."""
    import torch
    from sisr_tpu_torch.models.blocks import torch_default_init_
    from sisr_tpu_torch.models.san import SOCA, NonlocalCA
    gen = torch.Generator().manual_seed(10)
    shape = (BATCH, LR_SIZE, LR_SIZE, 64)
    vol = torch.randn(shape, generator=gen)
    soca = torch_default_init_(SOCA(64, SAN['reduction']), gen)
    non_local = draw_nonlocal_w(torch_default_init_(NonlocalCA(64, 8), gen))

    def calls(device, dtype):
        soca.to(device)
        non_local.to(device)
        x = vol.to(device, dtype).permute(0, 3, 1, 2)
        return lambda: soca(x), lambda: non_local(x)

    report = {'phase': 'san_attention', 'shape': list(shape)}
    reset_launches()
    with torch.inference_mode():
        host = [fn().permute(0, 2, 3, 1) for fn in calls('cpu', torch.float32)]
        card = [fn().permute(0, 2, 3, 1).cpu() for fn in calls('cuda', torch.float32)]
        for key, a, b in (('soca', card[0], host[0]), ('non_local', card[1], host[1])):
            report[key + '_max_abs_err'] = (a - b).abs().max().item()
        report['non_local_changes_its_input_by'] = (host[1] - vol).abs().max().item()
        m, c, i = LR_SIZE ** 2, 64, 8
        m_q = m // 4
        soca_flops = 2 * BATCH * m * c * c
        non_local_flops = 4 * 2 * 2 * BATCH * m_q * (m_q // 4) * i
        for dtype, itemsize in ((torch.bfloat16, 2), (torch.float32, 4)):
            tag = str(dtype).split('.')[-1]
            soca_fn, non_local_fn = calls('cuda', dtype)
            with torch.autocast('cuda', dtype=torch.bfloat16, enabled=tag == 'bfloat16'):
                report['soca_%s_ms' % tag] = cuda_ms(soca_fn, reps=10, rounds=3)
                report['non_local_%s_ms' % tag] = cuda_ms(non_local_fn, reps=10, rounds=3)
            map_s = 2 * BATCH * m * c * itemsize / HBM_BYTES_PER_S
            report['soca_%s_bound_ms' % tag] = max(map_s, soca_flops / F32_CUDA_CORE_FLOPS) * 1e3
            report['non_local_%s_bound_ms' % tag] = max(
                map_s, non_local_flops / F32_CUDA_CORE_FLOPS) * 1e3
    torch.cuda.synchronize()
    expect_launches(read_launches(), NO_LAUNCHES, 'SOCA and the non-local block')
    report['nvidia_smi'] = nvidia_smi_line()
    emit(report)
    if not report['non_local_changes_its_input_by'] > 0.1:
        raise AssertionError('the non-local block is near the identity')
    for key in ('soca', 'non_local'):
        if not report[key + '_max_abs_err'] <= 1e-5:
            raise AssertionError('%s on the card is %g from the CPU'
                                 % (key, report[key + '_max_abs_err']))


def int_mm_layout_ms(m, k, n, gen):
    """torch._int_mm time (CUDA events) with the (k, n) operand row-major and
    column-major, on the same values; raises if the two disagree."""
    import torch
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8, device='cuda')
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8, device='cuda')
    layouts = {'row_major': b, 'column_major': b.t().contiguous().t()}
    out = {name: torch._int_mm(a, mat) for name, mat in layouts.items()}
    if not torch.equal(out['row_major'], out['column_major']):
        raise AssertionError('torch._int_mm disagrees between weight layouts')
    return {name: cuda_ms(lambda mat=mat: torch._int_mm(a, mat), reps=20, rounds=3)
            for name, mat in layouts.items()}


def phase_int8_reference():
    """The int8 path, card against CPU.  One full-width int8 conv: int32 sums equal.
    Calibration on the card with TF32 allowed globally: scales within rtol 1e-5 of
    the CPU's (the library turns TF32 off for its own convs).  Full-width int8 RCAN
    (seeded weights, 10x20, 64f) on a 32^2 LR batch with the CPU's quantised state
    and scales on both: the forward's PSNR card-vs-CPU is reported; fused-eval PSNR
    within 0.01 dB and SSIM within 1e-3."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.ops import quantization as qz
    gen = torch.Generator().manual_seed(2)
    x_q = torch.randint(-127, 128, (BATCH, 32, 32, 64), generator=gen, dtype=torch.int8)
    kernel = torch.randint(-127, 128, (3, 3, 64, 64), generator=gen, dtype=torch.int8)
    acc_host = qz.conv_int8_accumulate(x_q, kernel)
    acc_card = qz.conv_int8_accumulate(x_q.cuda(), kernel.cuda()).cpu()
    if acc_card.dtype != torch.int32 or not torch.equal(acc_card, acc_host):
        raise AssertionError('int8 conv on the card: int32 sums differ from the CPU\'s')
    # the body conv's product at the main-path shape, and the tail's at 512^2
    card_gen = torch.Generator(device='cuda').manual_seed(2)
    layouts = {'body_131072x576x64': int_mm_layout_ms(BATCH * LR_SIZE ** 2, 576, 64,
                                                      card_gen),
               'tail_2097152x576x8': int_mm_layout_ms(BATCH * (LR_SIZE * SCALE) ** 2, 576,
                                                      8, card_gen)}

    f32 = {**RCAN, 'dtype': 'f32'}
    card = define_model('rcan', device='cuda', seed=3, **f32)
    host = define_model('rcan', device='cpu', seed=3, **f32)
    rng = np.random.RandomState(6)
    lr = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    hr = rng.randint(0, 256, (2, 32 * SCALE, 32 * SCALE, 3)).astype(np.uint8)
    x = torch.from_numpy(lr).float() / 255.0
    for handler in (card, host):
        handler.set_int8(True)
    host._ensure_int8_ctx(x)
    torch.backends.cudnn.allow_tf32 = True
    try:
        card._ensure_int8_ctx(x.cuda())
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError('int8 calibration left a global TF32 flag changed')
    finally:
        torch.backends.cudnn.allow_tf32 = False
    scales_card, scales_host = card._int8_ctx[2], host._int8_ctx[2]
    scale_rel = max(abs(float(scales_card[k]) / float(scales_host[k]) - 1)
                    for k in scales_host)
    if sorted(scales_card) != sorted(scales_host) or not scale_rel <= 1e-5:
        raise AssertionError('calibration on the card is %g from the CPU\'s (TF32?)'
                             % scale_rel)

    state = host._int8_ctx[1:]

    def forward_psnr(residual_dtype):
        """PSNR of the card's int8 forward against the CPU's, on the same state."""
        for handler in (card, host):
            handler.set_int8(True, residual_dtype=residual_dtype)
            handler.load_int8_state(*state)
        with torch.inference_mode():
            ours, theirs = card._int8_ctx[0](x.cuda()).cpu(), host._int8_ctx[0](x)
        mse = (ours - theirs).pow(2).mean().item()
        return ours, theirs, float('inf') if mse == 0 else 10 * np.log10(1.0 / mse)

    # the f32 carry isolates what the bf16 carry's roundings add to the divergence
    f32_carry_psnr = forward_psnr('float32')[2]
    out_card, out_host, fwd_psnr = forward_psnr('bfloat16')
    (keys, m_card), _ = card.run_eval_fused({'lr': lr, 'hr': hr})
    (_, m_host), _ = host.run_eval_fused({'lr': lr, 'hr': hr})
    m_card, m_host = m_card.cpu().numpy(), m_host.numpy()
    diff = {k: float(np.abs(m_card[i] - m_host[i]).max()) for i, k in enumerate(keys)}
    emit({'phase': 'int8_reference', 'conv_int32_equal': True,
          'int_mm_ms_by_weight_layout': layouts, 'calibration_max_rel_diff': scale_rel,
          'forward_psnr_card_vs_cpu': fwd_psnr,
          'forward_psnr_card_vs_cpu_f32_carry': f32_carry_psnr,
          'forward_max_abs_err': (out_card - out_host).abs().max().item(),
          'metric_max_abs_diff': diff, 'output_shape': list(out_card.shape),
          'nvidia_smi': nvidia_smi_line()})
    if not np.isfinite(out_card.numpy()).all() or out_card.shape != out_host.shape:
        raise AssertionError('int8 RCAN on the card: non-finite or misshapen output')
    for i, k in enumerate(keys):
        bar = 0.01 if k.endswith('PSNR') else 1e-3
        if not diff[k] <= bar:
            raise AssertionError('int8 fused eval %s on the card is %g from the CPU'
                                 % (k, diff[k]))


# int8 card-vs-CPU phases: name -> (model, structure in f32, LR size, carries; the
# fused eval runs the last, bfloat16, the serving default)
INT8_REFERENCE = {
    'edsr': ('edsr', {**EDSR, 'dtype': 'f32'}, 32, ('float32', 'int16', 'bfloat16')),
    'qrcan': ('qrcan', {**QRCAN, 'n_resgroups': 2, 'n_resblocks': 2, 'dtype': 'f32'}, 32,
              ('bfloat16',)),
    'qedsr': ('qedsr', {**QEDSR, 'num_blocks': 2, 'dtype': 'f32'}, 16, ('bfloat16',)),
    'han': ('han', {**HAN, 'n_resgroups': 2, 'n_resblocks': 2, 'dtype': 'f32'}, 32,
            ('bfloat16',)),
    'qhan': ('qhan', {**QHAN, 'n_resgroups': 2, 'n_resblocks': 2, 'dtype': 'f32'}, 32,
             ('bfloat16',)),
    'san': ('san', {**SAN, 'n_resgroups': 2, 'n_resblocks': 2, 'dtype': 'f32'}, 32,
            ('bfloat16',)),
    'qsan': ('qsan', {**QSAN, 'n_resgroups': 2, 'n_resblocks': 2, 'dtype': 'f32'}, 32,
             ('bfloat16',)),
    'srmd': ('srmd', {**SRMD, 'dtype': 'f32'}, 32, ('bfloat16',)),
    'sftmd': ('sftmd', {**SFTMD_Q, 'num_blocks': 2, 'dtype': 'f32'}, 32, ('bfloat16',)),
    'vdsr': ('vdsr', {**VDSR, 'dtype': 'f32'}, 32, ('bfloat16',)),
}


def psnr_between(a, b):
    import numpy as np
    mse = (a - b).pow(2).mean().item()
    return float('inf') if mse == 0 else 10 * np.log10(1.0 / mse)


def phase_int8_family_reference(name):
    """The int8 program of INT8_REFERENCE[name] (seeded weights, 10 seeded metadata
    values per image for the Q-models), card against CPU, in f32 with TF32 off.  The
    int32 sums of the head and of the first body conv, with the model's quantised
    kernels on seeded int8 inputs, are equal; calibration on the card (TF32 allowed
    globally) within rtol 1e-5 of the CPU's; on the CPU's quantised state, each
    carry's forward: finite, the CPU's shape, its PSNR card-vs-CPU reported; the fused
    eval (bfloat16 carry) within 0.01 dB PSNR and 1e-3 SSIM.  Q-RCAN, HAN and Q-HAN
    (2 x 2, gammas set; LAM and CSAM in bf16 on cuBLAS and cuDNN) count their CA +
    residual launches (one per block: the RCAB tail, or the cast-first QRCAB tail) and
    hold their path against res_onchip_plan, and launch no CA; SAN and Q-SAN (2 x 2,
    gamma and W set; the non-local block and SOCA in f32), SRMD (12 convs, on its
    concatenated input) and SFTMD (2 blocks, q_injection: SFT branches in bf16, gates in
    f32) and VDSR (20 x 64, on the Y channel of the LR upscaled to 128^2 on the card,
    the program's and calibration's input) launch neither op; SFTMD also holds the
    int32 sums of its 9 x 9 conv_output at HR size, gathered whole and in bands of 16
    rows; Q-EDSR also holds its f32 module forward to 5e-4."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.ops import channel_attention as ca
    from sisr_tpu_torch.ops import quantization as qz
    model, internal, size, carries = INT8_REFERENCE[name]
    card = define_model(model, device='cuda', seed=3, **internal)
    host = define_model(model, device='cpu', seed=3, **internal)
    for handler in (card, host):
        set_gammas(handler.module)
    rng = np.random.RandomState(7)
    lr = rng.randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    batch = {'lr': lr,
             'hr': rng.randint(0, 256, (2, size * SCALE, size * SCALE, 3)).astype(np.uint8)}
    x = torch.from_numpy(lr).float() / 255.0
    raw_meta = None
    if host.uses_metadata:
        batch['metadata'] = rng.dirichlet(np.ones(META_COLS) * 5, 2).astype(np.float32)
        for handler in (card, host):
            handler.set_metadata_keys(['blur_kernel'] * META_COLS)
        raw_meta = torch.from_numpy(batch['metadata'])
    # the program's input: the LR batch (SRMD's with its maps concatenated) and the
    # prepared metadata (None where the program takes none)
    x, meta = module_input(host, x, raw_meta, hr_hw=(size * SCALE, size * SCALE))
    x_card = x.cuda()
    meta_card = None if meta is None else meta.cuda()
    report = {'phase': 'int8_reference', 'model': name, 'structure': internal,
              'lr': size}
    if name == 'qedsr':
        with torch.inference_mode():
            fwd_err = (card.forward(x_card, meta_card).cpu()
                       - host.forward(x, meta)).abs().max().item()
        report['f32_forward_max_abs_err'] = fwd_err
        if not fwd_err <= 5e-4:
            raise AssertionError('qedsr f32 forward on the card is %g from the CPU' % fwd_err)

    for handler in (card, host):
        handler.set_int8(True)
    host._ensure_int8_ctx(x, meta)
    with tf32(True, True):  # calibration turns TF32 off for its own convs and products
        card._ensure_int8_ctx(x_card, meta_card)
        if not (torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32):
            raise AssertionError('int8 calibration left a global TF32 flag changed')
    scales_card, scales_host = card._int8_ctx[2], host._int8_ctx[2]
    scale_rel = max(abs(float(scales_card[k]) / float(scales_host[k]) - 1)
                    for k in scales_host)
    if sorted(scales_card) != sorted(scales_host) or not scale_rel <= 1e-5:
        raise AssertionError('%s calibration on the card is %g from the CPU\'s'
                             % (name, scale_rel))
    report['calibration_max_rel_diff'] = scale_rel

    qp = host._int8_ctx[1]
    if model in ('srmd', 'vdsr'):
        head, first_body = qp['conv_0'], qp['conv_1']
    elif model == 'sftmd':
        head, first_body = qp['conv1'], qp['sft_residual_1']['conv1']
    elif 'block_0' in qp:
        head, first_body = qp['head'], qp['block_0']['conv_0']
    elif 'rg_0' in qp:
        head = qp['head']
        first_body = qp['rg_0'].get('rb_0', qp['rg_0'].get('qrb_0'))['conv_0']
    else:
        head = qp['head']
        first_body = qp['group_0'].get('rcab_0', qp['group_0'].get('qrcab_0'))['conv_0']
    convs = [('head', head, size, None), ('first_body_conv', first_body, size, None)]
    if model == 'sftmd':  # the 9 x 9 tail at HR size, whole and in bands of 16 rows
        hr = size * SCALE
        convs += [('conv_output', qp['conv_output'], hr, None),
                  ('conv_output_banded', qp['conv_output'], hr,
                   16 * 2 * hr * qp['conv_output']['matrix'].shape[0])]
    gen = torch.Generator().manual_seed(8)
    whole_bytes = qz.IM2COL_BAND_BYTES
    for conv_name, entry, side, band_bytes in convs:
        x_q = torch.randint(-127, 128, (2, side, side, entry['kernel'].shape[2]),
                            generator=gen, dtype=torch.int8)
        acc_host = qz.conv_int8_accumulate(x_q, entry['kernel'], entry['matrix'])
        qz.IM2COL_BAND_BYTES = band_bytes or whole_bytes
        try:
            acc_card = qz.conv_int8_accumulate(x_q.cuda(), entry['kernel'].cuda(),
                                               entry['matrix'].cuda()).cpu()
        finally:
            qz.IM2COL_BAND_BYTES = whole_bytes
        if acc_card.dtype != torch.int32 or not torch.equal(acc_card, acc_host):
            raise AssertionError('%s int8 %s on the card: int32 sums differ from the CPU\'s'
                                 % (name, conv_name))
    report['conv_int32_equal'] = [c[0] for c in convs]

    state = host._int8_ctx[1:]
    props = torch.cuda.get_device_properties(0)
    # Q-RCAN, HAN, Q-HAN: one CA + residual launch a block (its f32 map, the bf16
    # carry; Q-RCAN's max_concat with its metadata), on the path the plan gives
    blocks = internal['n_resgroups'] * internal['n_resblocks'] \
        if name in ('qrcan', 'han', 'qhan') else 0
    plan = ca.res_onchip_plan(2, size * size, 64, 4, 4, 2, True, props.multi_processor_count,
                              props.shared_memory_per_block_optin,
                              m=META_COLS if name == 'qrcan' else 0)
    report['carries'] = {}
    for carry in carries:
        for handler in (card, host):
            handler.set_int8(True, residual_dtype=carry)
            handler.load_int8_state(*state)
        reset_launches()
        with torch.inference_mode():
            ours = card._int8_ctx[0](x_card, meta_card).cpu()
            theirs = host._int8_ctx[0](x, meta)
        torch.cuda.synchronize()
        launches = read_launches()
        if not torch.isfinite(ours).all() or ours.shape != theirs.shape:
            raise AssertionError('int8 %s (%s carry) on the card: non-finite or misshapen'
                                 % (name, carry))
        report['carries'][carry] = {'forward_psnr_card_vs_cpu': psnr_between(ours, theirs),
                                    'forward_max_abs_err': (ours - theirs).abs().max().item(),
                                    'launches': launches}
        expect_launches(launches, {**NO_LAUNCHES, 'fused_channel_attention_residual': blocks,
                                   'fused_channel_attention_residual_onchip':
                                       blocks if plan is not None else 0},
                        'int8 %s forward (%s carry)' % (name, carry))
        if blocks:
            report['carries'][carry]['ca_res_path'] = 'onchip' if plan is not None \
                else 'three_pass'
    (keys, m_card), _ = card.run_eval_fused(batch)
    (_, m_host), _ = host.run_eval_fused(batch)
    m_card, m_host = m_card.cpu().numpy(), m_host.numpy()
    diff = {k: float(np.abs(m_card[i] - m_host[i]).max()) for i, k in enumerate(keys)}
    report.update({'metric_max_abs_diff': diff, 'output_shape': list(ours.shape),
                   'nvidia_smi': nvidia_smi_line()})
    emit(report)
    for i, k in enumerate(keys):
        bar = 0.01 if k.endswith('PSNR') else 1e-3
        if not diff[k] <= bar:
            raise AssertionError('int8 %s fused eval %s on the card is %g from the CPU'
                                 % (name, k, diff[k]))


def prepare_workload(root):
    """The 16 synthetic pairs (with their metadata CSV) and one seeded experiment of
    each model (seed 8), shared by every path."""
    import numpy as np
    lr_dir, hr_dir = write_workload(root, np.random.RandomState(0))
    model_loc = os.path.join(root, 'Results')
    for name in MODELS:
        write_experiment(model_loc, name, seed=8)
    return {'lr_dir': lr_dir, 'hr_dir': hr_dir, 'model_loc': model_loc,
            'out_loc': os.path.join(root, 'out')}


def reset_launches():
    from sisr_tpu_torch.ops import channel_attention as ca
    ca.fused_channel_attention.launches = 0
    ca.fused_channel_attention.onchip_launches = 0
    ca.fused_channel_attention.onchip_shapes.clear()
    ca.fused_channel_attention.rounds_launches = 0
    ca.fused_channel_attention.stream_launches = 0
    ca.fused_channel_attention.masked_launches = 0
    ca.fused_channel_attention_residual.launches = 0
    ca.fused_channel_attention_residual.onchip_launches = 0
    ca.fused_channel_attention_residual.stream_launches = 0


# the counts of read_launches: each wrapper's launches, the CA's on chip, in rounds,
# streaming and given a valid extent (bucketed eval), the CA + residual's in rounds (its
# onchip_launches) and streaming
NO_LAUNCHES = dict.fromkeys(('fused_channel_attention', 'fused_channel_attention_onchip',
                             'fused_channel_attention_rounds',
                             'fused_channel_attention_stream',
                             'fused_channel_attention_masked',
                             'fused_channel_attention_residual',
                             'fused_channel_attention_residual_onchip',
                             'fused_channel_attention_residual_stream'), 0)


def read_launches():
    """Each wrapper's launches, and how many of each took its on-chip, rounds or
    stream route."""
    from sisr_tpu_torch.ops import channel_attention as ca
    op, res = ca.fused_channel_attention, ca.fused_channel_attention_residual
    return {'fused_channel_attention': op.launches,
            'fused_channel_attention_onchip': op.onchip_launches,
            'fused_channel_attention_rounds': op.rounds_launches,
            'fused_channel_attention_stream': op.stream_launches,
            'fused_channel_attention_masked': op.masked_launches,
            'fused_channel_attention_residual': res.launches,
            'fused_channel_attention_residual_onchip': res.onchip_launches,
            'fused_channel_attention_residual_stream': res.stream_launches}


def read_onchip_shapes():
    """ca_onchip's launches by map: {'1x128x128x64 bfloat16': n}."""
    from sisr_tpu_torch.ops import channel_attention as ca
    return {'%s %s' % ('x'.join(map(str, shape)), str(dtype).split('.')[-1]): n
            for (shape, dtype), n in ca.fused_channel_attention.onchip_shapes.items()}


def run_eval_cli(dirs, results_name, extra=(), experiment='rcan_10x20', epoch='0'):
    """``eval_sisr --fused_eval`` through the CLI entry point; the launch counts of
    exactly this run (set to 0 just before, read just after), its seconds, and its
    per-image CSV, checked for 16 finite rows."""
    import numpy as np
    import pandas as pd
    from sisr_tpu_torch import net_eval
    args = ['--hr_dir', dirs['hr_dir'], '--lr_dir', dirs['lr_dir'], '-me', experiment, epoch,
            '--model_loc', dirs['model_loc'], '--out_loc', dirs['out_loc'],
            '--results_name', results_name, '-m', 'PSNR', '-m', 'SSIM', '--scale',
            str(SCALE), '--batch_size', str(BATCH), '--full_directory', '--fused_eval',
            '--no_image_comparison', '--no-time_models', *extra]
    reset_launches()
    tic = time.perf_counter()
    net_eval.eval_run.main(args=args, standalone_mode=False)
    seconds = time.perf_counter() - tic
    launches = read_launches()
    csv = os.path.join(dirs['out_loc'], results_name, 'standard_metrics',
                       'individual_metrics.csv')
    frame = pd.read_csv(csv, header=[0, 1], index_col=0)
    vals = frame[[(experiment, 'PSNR'), (experiment, 'SSIM'), ('LR', 'PSNR'),
                  ('LR', 'SSIM')]].to_numpy()
    if len(frame) != N_IMAGES or not np.isfinite(vals).all():
        raise AssertionError('%s individual_metrics.csv: %d rows, finite=%s'
                             % (results_name, len(frame), np.isfinite(vals).all()))
    return launches, seconds, frame


def expect_launches(launches, expected, path):
    if launches != expected:
        raise AssertionError('%s launches %s, expected %s' % (path, launches, expected))


def eval_hub(dirs, experiment, results_name, fused, int8, batch_size, cache_device=False):
    """An EvalHub over ``dirs`` (no images saved, no comparisons, not timed), by default
    without the device-batch cache (every pass uploads its batches)."""
    from sisr_tpu_torch.evaluation.standard_eval import EvalHub
    return EvalHub(hr_dir=dirs['hr_dir'], lr_dir=dirs['lr_dir'],
                   model_and_epoch=[(experiment, '0')], results_name=results_name,
                   gpu=True, metrics=['PSNR', 'SSIM'], data_split=None, save_im=False,
                   batch_size=batch_size, full_directory=True, lr_dir_interp=None,
                   model_only=False, scale=SCALE, model_loc=dirs['model_loc'],
                   out_loc=dirs['out_loc'], use_test_group=False, no_image_comparison=True,
                   num_image_save=0, qpi_selection=(None, None), data_attributes=None,
                   dataset_name=None, image_shortlist=None, metadata_file=None, sp_gpu=0,
                   time_models=False, recursive=False, fused_eval=fused, int8=int8,
                   cache_device=cache_device)


def warm_passes(dirs, results_name, int8, experiment='rcan_10x20'):
    """img/s of 3 warm fused protocol passes on one hub without the device-batch cache
    (the series of PRs 1-12: decoded images cached on the host, batches uploaded every
    pass; the first pass decodes and sets up, the rest are timed), and the hub's
    handler."""
    hub = eval_hub(dirs, experiment, results_name, True, int8, BATCH)
    hub.full_image_protocol()
    rates = []
    for _ in range(3):
        tic = time.perf_counter()
        hub.full_image_protocol()
        rates.append(N_IMAGES / (time.perf_counter() - tic))
    return rates, hub.model_bundles[0].model


def cached_passes(dirs, results_name, experiment):
    """img/s of 3 warm fused protocol passes on one hub with the device-batch cache (the
    EvalHub default): the first pass decodes, uploads and fills the cache, each later
    pass runs from it and must decode no item (ITEMS_LOADED) and write the first pass's
    metrics."""
    import pandas as pd
    from sisr_tpu_torch.data import loader
    hub = eval_hub(dirs, experiment, results_name, True, False, BATCH, cache_device=True)
    hub.full_image_protocol()
    if hub._device_batch_cache is None:
        raise AssertionError('%s: the first pass left no device-batch cache' % experiment)
    csv = os.path.join(dirs['out_loc'], results_name, 'standard_metrics',
                       'individual_metrics.csv')
    first = pd.read_csv(csv, header=[0, 1], index_col=0)
    rates, decoded = [], []
    for _ in range(3):
        before = loader.ITEMS_LOADED
        tic = time.perf_counter()
        hub.full_image_protocol()
        rates.append(N_IMAGES / (time.perf_counter() - tic))
        decoded.append(loader.ITEMS_LOADED - before)
        pd.testing.assert_frame_equal(pd.read_csv(csv, header=[0, 1], index_col=0), first)
    if any(decoded):
        raise AssertionError('%s: cached passes decoded %s items' % (experiment, decoded))
    cache_mb = sum(v.numel() * v.element_size() for b in hub._device_batch_cache
                   for v in b.values() if hasattr(v, 'element_size')) / 1e6
    return {'img_per_s_cached_passes': rates, 'img_per_s_cached': statistics.median(rates),
            'cached_passes_decoded_items': decoded, 'device_batch_cache_mb': cache_mb}


def breakdown_batch(handler=None):
    """One seeded uint8 batch on the card, and the module's input (the f32 LR, SRMD's
    with its maps concatenated, a pre-upscaled family's upscaled to 512^2 on the card)
    and metadata input (None without) as module_input makes them; for a metadata
    model (``handler.uses_metadata``) the batch has 10 metadata
    values per image."""
    import numpy as np
    import torch
    rng = np.random.RandomState(1)
    batch = {'lr': rng.randint(0, 256, (BATCH, LR_SIZE, LR_SIZE, 3)).astype(np.uint8),
             'hr': rng.randint(0, 256, (BATCH, LR_SIZE * SCALE, LR_SIZE * SCALE, 3))
             .astype(np.uint8)}
    if handler is not None and handler.uses_metadata:
        batch['metadata'] = rng.dirichlet(np.ones(META_COLS) * 5, BATCH).astype(np.float32)
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    x, meta = module_input(handler, dev['lr'].float() / 255.0, dev.get('metadata'),
                           hr_hw=dev['hr'].shape[1:3])
    return dev, x, meta


def step_times(handler, dev, warm=5):
    """The fused step's wall ms (CUDA events, after ``warm`` calls), its device-busy ms
    (profiler) and the idle share; and the step's per-kernel device ms."""
    step = lambda: handler.run_eval_fused(dev)[0][1]
    step_ms = cuda_ms(step, reps=5, rounds=3, warm=warm)
    step_device_ms, per_kernel = device_kernel_ms(step, reps=3)
    return ({'fused_step_ms': step_ms, 'fused_step_device_ms': step_device_ms,
             'device_idle_share': (1 - step_device_ms / step_ms) if step_device_ms
             else None}, {k: v / 3 for k, v in per_kernel.items()})


# bf16 main paths: experiment -> (phase name prefix, description, CA calls a forward)
BF16_PATHS = {
    'rcan_10x20': ('', 'rcan 10x20 64f 4x bf16', CA_PER_FORWARD),
    'qrcan_10x20': ('qrcan_', 'qrcan 10x20 64f 4x bf16, max_concat + q_node, '
                    '10 blur-kernel values', QRCAN['n_resgroups'] * QRCAN['n_resblocks']),
    'edsr_16b': ('edsr_', 'edsr 16b 64f 4x bf16', 0),
    'qedsr_32b': ('qedsr_', 'qedsr 32b 256f 4x bf16, q_layer_nonlinearity, '
                  '10 blur-kernel values', 0),
    'han_10x10': ('han_', 'han 10x10 64f 4x bf16, LAM over 11 maps + CSAM',
                  HAN['n_resgroups'] * HAN['n_resblocks']),
    'qhan_10x10': ('qhan_', 'qhan 10x10 64f 4x bf16, standard + q_node, 10 blur-kernel '
                   'values, LAM + CSAM', QHAN['n_resgroups'] * QHAN['n_resblocks']),
    'san_20x5': ('san_', 'san 20x5 64f 4x bf16, 20 SOCA + 2 non-local passes, no tile '
                  'grid at 128^2 (max_combined_im_size 20000)', 0),
    'qsan_20x5': ('qsan_', 'qsan 20x5 64f 4x bf16, ParaCALayer gates on 10 blur-kernel '
                   'values, 20 SOCA + 2 non-local passes', 0),
    'srmd_12': ('srmd_', 'srmd 12 convs 128f 4x bf16, 3 + 10 input channels (the '
                'blur-kernel maps concatenated)', 0),
    'sftmd_16b': ('sftmd_', 'sftmd 16b 64f 4x bf16, standard SFT on 10 blur-kernel maps', 0),
    'sparnet_128': ('sparnet_', 'sparnet defaults (in_size 128, 32-128 ch, bn, leakyrelu) '
                    'bf16 on the LR upscaled to 512^2 on the card', 0),
    'qsparnet_512': ('qsparnet_', 'qsparnet in_size 512 (configs/celebahq/qsparnet.toml) '
                     'bf16, 10 blur-kernel values, on the LR upscaled to 512^2', 0),
    'srcnn_955': ('srcnn_', 'srcnn [9, 5, 5] [1, 64, 32, 1] bf16 on the Y of the LR '
                  'upscaled to 512^2', 0),
    'vdsr_20': ('vdsr_', 'vdsr 20 x 64 bf16 on the Y of the LR upscaled to 512^2', 0),
}


def odd_channel_convs(handler, x, meta):
    """The convs whose input channels are no multiple of 8 (SRMD's first: 13; each SFT
    branch's first: 74), each timed alone (CUDA events, under the bf16 autocast) on the
    input one forward gives the first of its kind, beside the same conv with its input
    channels zero-padded to the next multiple of 8; with the calls a forward makes."""
    import torch
    from torch.nn import functional as F
    odd = [m for m in handler.module.modules()
           if isinstance(m, torch.nn.Conv2d) and m.in_channels % 8]
    seen = {}
    def keep_first(mod, args):
        seen.setdefault(mod.in_channels, (mod, args[0]))

    hooks = [m.register_forward_pre_hook(keep_first) for m in odd]
    try:
        with torch.inference_mode():
            handler.forward(x, meta)
    finally:
        for hook in hooks:
            hook.remove()
    out = {}
    with torch.inference_mode(), torch.autocast('cuda', dtype=torch.bfloat16):
        for cin, (mod, inp) in seen.items():
            pad = -cin % 8
            inp_p = F.pad(inp, (0, 0, 0, 0, 0, pad)).contiguous(
                memory_format=torch.channels_last)
            w_p = F.pad(mod.weight, (0, 0, 0, 0, 0, pad)).contiguous(
                memory_format=torch.channels_last)
            calls = sum(1 for m in odd if m.in_channels == cin)
            ms = cuda_ms(lambda mod=mod, inp=inp: mod(inp), reps=10, rounds=3)
            out['conv_in%d' % cin] = {
                'calls_per_forward': calls, 'input_shape': list(inp.shape),
                'out_channels': mod.out_channels, 'ms': ms, 'ms_per_forward': ms * calls,
                'padded_to_%d_ms' % (cin + pad): cuda_ms(
                    lambda: F.conv2d(inp_p, w_p, mod.bias, padding=mod.padding),
                    reps=10, rounds=3)}
    return out


def norm_breakdown(handler, x, meta):
    """A pre-upscaled family's forward device time split into the convs (cuDNN kernel
    names), the norms (batch-norm kernel names: SPARNet's and Q-SPARNet's BatchNorms in
    eval mode) and the rest (activations, the hourglass resizes and gates, the
    residual adds, ParaCALayer gates)."""
    import torch
    with torch.inference_mode():
        device_ms, per_kernel = device_kernel_ms(lambda: handler.forward(x, meta), reps=3)
    norm_ms = sum(v for k, v in per_kernel.items()
                  if any(t in k.lower() for t in NORM_KERNEL_HINTS)) / 3
    conv_ms = sum(v for k, v in per_kernel.items()
                  if not any(t in k.lower() for t in NORM_KERNEL_HINTS)
                  and any(t in k.lower() for t in CONV_KERNEL_HINTS)) / 3
    return {'forward_device_ms': device_ms, 'forward_conv_device_ms': conv_ms,
            'forward_norm_device_ms': norm_ms,
            'forward_other_device_ms': device_ms - conv_ms - norm_ms if device_ms else None,
            'forward_input_shape': list(x.shape)}


def concat_breakdown(handler, x, meta):
    """SRMD's and SFTMD's forward device time split into the convs (cuDNN kernel
    names) and the rest (the concats, the maps, the SFT products, the shuffles), and
    its odd-channel convs timed alone (odd_channel_convs)."""
    import torch
    with torch.inference_mode():
        device_ms, per_kernel = device_kernel_ms(lambda: handler.forward(x, meta), reps=3)
    conv_ms = sum(v for k, v in per_kernel.items()
                  if any(t in k.lower() for t in CONV_KERNEL_HINTS)) / 3
    return {'forward_device_ms': device_ms, 'forward_conv_device_ms': conv_ms,
            'forward_other_device_ms': device_ms - conv_ms if device_ms else None,
            'odd_channel_convs': odd_channel_convs(handler, x, meta)}


def peak_forward_gb(fn):
    """Peak device memory (GB) allocated while ``fn`` runs once."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def holistic_ms(module, forward):
    """HAN's LAM, CSAM and ``last_conv`` each timed alone (CUDA events, under the bf16
    autocast the forward runs them in) on the inputs one ``forward`` gives them."""
    import torch
    inputs = {}
    hooks = [getattr(module, name).register_forward_pre_hook(
        lambda mod, args, name=name: inputs.setdefault(name, args))
        for name in ('la', 'csa', 'last_conv')]
    try:
        with torch.inference_mode():
            forward()
    finally:
        for hook in hooks:
            hook.remove()
    with torch.inference_mode(), torch.autocast('cuda', dtype=torch.bfloat16):
        return {name + '_ms': cuda_ms(lambda fn=getattr(module, name), args=args: fn(*args),
                                      reps=10, rounds=3) for name, args in inputs.items()}


def holistic_int8_ms(handler, x, meta):
    """The int8 program's LAM and CSAM (bf16) and its int8 ``last_conv``, each timed
    alone (CUDA events) on the inputs one forward gives them."""
    import torch
    from sisr_tpu_torch.ops import quantization as qz
    program, qparams, scales = handler._int8_ctx
    seen, lam, csam = {}, qz._lam_apply, qz._csam_apply

    def spy(key, fn):
        def call(*args, **kwargs):
            seen[key] = (args, kwargs, fn(*args, **kwargs))
            return seen[key][2]
        return call

    qz._lam_apply, qz._csam_apply = spy('la', lam), spy('csa', csam)
    try:
        with torch.inference_mode():
            program(x, meta)
    finally:
        qz._lam_apply, qz._csam_apply = lam, csam
    entry, x_scale = qparams['last_conv'], qz.scales_on(scales, x.device)['last_conv']
    with torch.inference_mode():
        return {'la_ms': cuda_ms(lambda: lam(*seen['la'][0], **seen['la'][1]), 10, 3),
                'csa_ms': cuda_ms(lambda: csam(*seen['csa'][0], **seen['csa'][1]), 10, 3),
                'last_conv_ms': cuda_ms(lambda: qz.conv_int8_static(
                    seen['la'][2], entry['kernel'], entry['scale'], x_scale, entry['bias'],
                    entry['matrix']), 10, 3)}


def san_attention_ms(module, forward):
    """SAN's and Q-SAN's 20 SOCAs and 2 non-local passes of one forward, each set timed
    alone (CUDA events, under the forward's bf16 autocast) on the inputs that
    ``forward`` gives them: ms per forward."""
    import torch
    inputs = {'soca': [], 'non_local': []}
    hooks = [group.soca.register_forward_pre_hook(
        lambda mod, args: inputs['soca'].append((mod, args))) for group in module.RG]
    hooks.append(module.non_local.register_forward_pre_hook(
        lambda mod, args: inputs['non_local'].append((mod, args))))
    try:
        with torch.inference_mode():
            forward()
    finally:
        for hook in hooks:
            hook.remove()
    with torch.inference_mode(), torch.autocast('cuda', dtype=torch.bfloat16):
        return {key + '_ms_per_forward': cuda_ms(
            lambda calls=calls: [mod(*args) for mod, args in calls], reps=5, rounds=3)
            for key, calls in inputs.items()}


def san_int8_attention_ms(handler, x, meta):
    """The int8 program's SOCAs and non-local passes (f32), each set timed alone (CUDA
    events) on the inputs one forward gives them: ms per forward."""
    import torch
    from sisr_tpu_torch.ops import quantization as qz
    program, qparams, _ = handler._int8_ctx
    seen = {'soca': [], 'non_local': []}
    soca, non_local = qz._soca_apply, qz._nonlocal_ca_apply

    def spy(key, fn):
        def call(*args):
            seen[key].append(args)
            return fn(*args)
        return call

    qz._soca_apply, qz._nonlocal_ca_apply = spy('soca', soca), spy('non_local', non_local)
    try:
        with torch.inference_mode():
            program(x, meta)
    finally:
        qz._soca_apply, qz._nonlocal_ca_apply = soca, non_local
    with torch.inference_mode():
        return {key + '_ms_per_forward': cuda_ms(
            lambda fn=fn, calls=seen[key]: [fn(*args) for args in calls], reps=5, rounds=3)
            for key, fn in (('soca', soca), ('non_local', non_local))}


def phase_main_path(dirs, experiment='rcan_10x20'):
    """``eval_sisr --fused_eval`` in bf16 on ``experiment``: every CALayer or QRCAB tail
    through the on-chip CA kernel (200 per forward for RCAN, Q-RCAN, HAN and Q-HAN,
    none for EDSR, Q-EDSR, SAN, Q-SAN, SRMD, SFTMD and the pre-upscaled families), the
    CA + residual kernel not at all; HAN's LAM, CSAM and last_conv, SAN's SOCAs and
    non-local passes, SRMD's and SFTMD's convs, the rest and their odd-channel convs,
    the pre-upscaled families' convs, norms and the rest timed apart; for RCAN and EDSR
    also the img/s of warm passes from the device-batch cache."""
    import torch
    prefix, description, ca_calls = BF16_PATHS[experiment]
    launches, cli_seconds, frame = run_eval_cli(dirs, prefix + 'smoke', experiment=experiment)
    n_batches = -(-N_IMAGES // BATCH)
    expect_launches(launches, {**NO_LAUNCHES,
                               'fused_channel_attention': ca_calls * n_batches,
                               'fused_channel_attention_onchip': ca_calls * n_batches},
                    '%s bf16 main path' % experiment)
    rates, handler = warm_passes(dirs, prefix + 'smoke_timed', int8=False,
                                 experiment=experiment)
    cached = cached_passes(dirs, prefix + 'smoke_cached', experiment) \
        if experiment in ('rcan_10x20', 'edsr_16b') else {}

    dev, x, meta = breakdown_batch(handler)
    conv_flops = count_conv_flops(handler, x, meta)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: handler.forward(x, meta), reps=5, rounds=3)
    peak_gb = peak_forward_gb(lambda: handler.forward(x, meta))
    steps, per_kernel = step_times(handler, dev)
    ca_ms = sum(v for k, v in per_kernel.items() if any(n in k for n in CA_KERNELS))
    conv_ms = sum(v for k, v in per_kernel.items() if not any(n in k for n in CA_KERNELS)
                  and any(t in k.lower() for t in CONV_KERNEL_HINTS))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    mean_psnr = float(frame[(experiment, 'PSNR')].mean())
    holistic = holistic_ms(handler.module, lambda: handler.forward(x, meta)) \
        if hasattr(handler.module, 'la') else san_attention_ms(
            handler.module, lambda: handler.forward(x, meta)) \
        if hasattr(handler.module, 'non_local') else concat_breakdown(handler, x, meta) \
        if experiment in CONCAT_PATHS else norm_breakdown(handler, x, meta) \
        if experiment in PRE_UPSCALED_PATHS else {}
    emit({'phase': prefix + 'main_path', 'model': description, 'images': N_IMAGES,
          'batch': BATCH, 'lr': LR_SIZE, 'cli_seconds': cli_seconds, 'launches': launches,
          'mean_psnr': mean_psnr, 'mean_lr_psnr': float(frame[('LR', 'PSNR')].mean()),
          'img_per_s_warm_passes': rates, 'img_per_s': statistics.median(rates), **cached,
          'nvidia_smi': nvidia_smi_line()})
    emit({'phase': prefix + 'breakdown', 'batch': BATCH, 'forward_ms': forward_ms,
          'forward_conv_gflop': conv_flops / 1e9,
          'forward_bf16_bound_ms': conv_flops / BF16_TENSOR_FLOPS * 1e3, **steps,
          'forward_peak_memory_gb': peak_gb, 'ca_device_ms': ca_ms, 'conv_device_ms': conv_ms,
          'device_kernel_kinds': len(per_kernel), 'top_kernels_ms': top, **holistic,
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'mean_psnr': mean_psnr, 'frame': frame,
            'img_per_s': statistics.median(rates)}


# int8 main paths: experiment -> (phase name prefix, description)
INT8_PATHS = {
    'rcan_10x20': ('', 'rcan 10x20 64f 4x int8 (bf16 carry)'),
    'edsr_16b': ('edsr_', 'edsr 16b 64f 4x int8 (bf16 carry)'),
    'qrcan_10x20': ('qrcan_', 'qrcan 10x20 64f 4x int8 (bf16 carry), max_concat + q_node, '
                    '10 blur-kernel values'),
    'qedsr_32b': ('qedsr_', 'qedsr 32b 256f 4x int8 (bf16 carry), q_layer_nonlinearity, '
                  '10 blur-kernel values'),
    'han_10x10': ('han_', 'han 10x10 64f 4x int8 (bf16 carry), LAM + CSAM in bf16'),
    'qhan_10x10': ('qhan_', 'qhan 10x10 64f 4x int8 (bf16 carry), standard + q_node, '
                   '10 blur-kernel values, LAM + CSAM in bf16'),
    'san_20x5': ('san_', 'san 20x5 64f 4x int8 (bf16 carry), SOCA + non-local in f32'),
    'qsan_20x5': ('qsan_', 'qsan 20x5 64f 4x int8 (bf16 carry), f32 ParaCALayer gates '
                   'on 10 blur-kernel values, SOCA + non-local in f32'),
    'srmd_12': ('srmd_', 'srmd 12 convs 128f 4x int8, the whole chain on the concatenated '
                'input'),
    'sftmd_16b': ('sftmd_', 'sftmd 16b 64f 4x int8 conv spine, standard SFT branches in '
                  'bf16, the 9x9 conv_output gathered in bands'),
    'vdsr_20': ('vdsr_', 'vdsr 20 x 64 int8, the whole chain at 512^2 on the Y of the '
                'LR upscaled on the card'),
}


def phase_int8_ignored(dirs, bf16_frame, experiment):
    """``eval_sisr --fused_eval --int8`` on a family without an int8 program (SPARNet,
    SRCNN): sisr_tpu's notice, the run in bf16 (every image's PSNR within 1e-3 dB of
    the bf16 run's), no CA launch."""
    import io
    import numpy as np
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launches, seconds, frame = run_eval_cli(dirs, experiment + '_int8_ignored',
                                                ['--int8'], experiment=experiment)
    notice = 'no int8 serving path for this architecture' in out.getvalue()
    diff = float(np.abs(frame[(experiment, 'PSNR')].to_numpy()
                        - bf16_frame[(experiment, 'PSNR')].to_numpy()).max())
    same = diff <= 1e-3
    emit({'phase': experiment.split('_')[0] + '_int8_ignored', 'notice': notice,
          'max_psnr_diff_to_bf16': diff, 'launches': launches, 'cli_seconds': seconds})
    expect_launches(launches, NO_LAUNCHES, '%s --int8' % experiment)
    if not (notice and same):
        raise AssertionError('%s --int8: notice %s, metrics equal to bf16 %s'
                             % (experiment, notice, same))
    return {'launches': launches}


def int8_expected_launches(experiment, forwards):
    """The kernel launches of ``forwards`` int8 forwards of ``experiment``: RCAN's and
    HAN's RCAB tails through the CA + residual kernel in rounds; Q-RCAN's and Q-HAN's
    QRCAB tails through it too (cast first, with the gate (and Q-RCAN's meta), on the
    f32 map and the bf16 carry), in rounds at this shape (asserted from the plan), and
    no CA launch; none for EDSR and Q-EDSR."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    counts = dict(NO_LAUNCHES)
    tails = {'rcan_10x20': CA_PER_FORWARD,
             'qrcan_10x20': QRCAN['n_resgroups'] * QRCAN['n_resblocks'],
             'han_10x10': HAN['n_resgroups'] * HAN['n_resblocks'],
             'qhan_10x10': QHAN['n_resgroups'] * QHAN['n_resblocks']}.get(experiment, 0)
    if tails:
        props = torch.cuda.get_device_properties(0)
        plan = ca.res_onchip_plan(BATCH, LR_SIZE ** 2, 64, 4, 4, 2, True,
                                  props.multi_processor_count,
                                  props.shared_memory_per_block_optin,
                                  m=META_COLS if experiment == 'qrcan_10x20' else 0)
        if plan is None:
            raise AssertionError('int8 %s\'s tail does not take the rounds route on this '
                                 'card' % experiment)
    counts['fused_channel_attention_residual'] = tails * forwards
    counts['fused_channel_attention_residual_onchip'] = tails * forwards
    return counts


def phase_int8_main_path(dirs, bf16_mean_psnr, experiment='rcan_10x20'):
    """``eval_sisr --fused_eval --int8`` on the same pairs and weights as
    ``experiment``'s bf16 run: the launches of int8_expected_launches, the module's
    kernels not at all; mean PSNR within 1 dB of the bf16 run's; img/s, the forward's
    device time by kind (our kernels, int8 GEMMs, the rest) and its peak memory; HAN's
    LAM, CSAM and int8 last_conv timed apart."""
    import torch
    prefix, description = INT8_PATHS[experiment]
    launches, cli_seconds, frame = run_eval_cli(dirs, prefix + 'smoke_int8', ['--int8'],
                                                experiment=experiment)
    n_batches = -(-N_IMAGES // BATCH)
    expect_launches(launches, int8_expected_launches(experiment, n_batches),
                    '%s int8 main path' % experiment)
    mean_psnr = float(frame[(experiment, 'PSNR')].mean())
    if not abs(mean_psnr - bf16_mean_psnr) < 1.0:
        raise AssertionError('%s int8 mean PSNR %.4f is not within 1 dB of bf16\'s %.4f'
                             % (experiment, mean_psnr, bf16_mean_psnr))
    rates, handler = warm_passes(dirs, prefix + 'smoke_int8_timed', int8=True,
                                 experiment=experiment)

    dev, x, meta = breakdown_batch(handler)
    program = handler._int8_ctx[0]
    # the program ran in the CLI run and the warm passes: one call warms each timing
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: program(x, meta), reps=3, rounds=3, warm=1)
        forward_device_ms, per_kernel = device_kernel_ms(lambda: program(x, meta), reps=3)
    peak_gb = peak_forward_gb(lambda: program(x, meta))
    steps, _ = step_times(handler, dev, warm=1)
    per_kernel = {k: v / 3 for k, v in per_kernel.items()}
    ours = CA_KERNELS + CA_RES_KERNELS
    ca_ms = sum(v for k, v in per_kernel.items() if any(n in k for n in ours))
    gemm_ms = sum(v for k, v in per_kernel.items() if not any(n in k for n in ours)
                  and any(t in k.lower() for t in GEMM_KERNEL_HINTS))
    other_ms = sum(per_kernel.values()) - ca_ms - gemm_ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    holistic = holistic_int8_ms(handler, x, meta) if hasattr(handler.module, 'la') \
        else san_int8_attention_ms(handler, x, meta) if hasattr(handler.module, 'non_local') \
        else {}
    emit({'phase': prefix + 'int8_main_path', 'model': description,
          'images': N_IMAGES, 'batch': BATCH, 'lr': LR_SIZE, 'cli_seconds': cli_seconds,
          'launches': launches, 'mean_psnr': mean_psnr, 'bf16_mean_psnr': bf16_mean_psnr,
          'mean_lr_psnr': float(frame[('LR', 'PSNR')].mean()),
          'img_per_s_warm_passes': rates, 'img_per_s': statistics.median(rates),
          'nvidia_smi': nvidia_smi_line()})
    emit({'phase': prefix + 'int8_breakdown', 'batch': BATCH, 'forward_ms': forward_ms,
          'forward_device_ms': forward_device_ms, **steps,
          'forward_int8_gemm_device_ms': gemm_ms, 'forward_ca_kernels_device_ms': ca_ms,
          'forward_ca_kernels_share': ca_ms / forward_device_ms if forward_device_ms
          else None, 'forward_other_device_ms': other_ms,
          'forward_peak_memory_gb': peak_gb, 'forward_kernels': len(per_kernel),
          'top_forward_kernels_ms': top, **holistic, 'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'mean_psnr': mean_psnr, 'frame': frame,
            'img_per_s': statistics.median(rates)}


def count_conv_flops(handler, x, meta=None):
    """Multiply-add FLOPs of every Conv2d the forward runs, from forward hooks (the
    1x1 convs of the attention vectors are not called as modules and are left out)."""
    import torch
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.in_channels // mod.groups \
            * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(hook) for m in handler.module.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            handler.forward(x, meta)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


# --- training -------------------------------------------------------------------------------
TRAIN_CROP = 64  # LR crop of configs/div2k/qrcan.toml
TRAIN_SHAPE = (BATCH, TRAIN_CROP, TRAIN_CROP, 64)  # the CA's x in a train step
# configs/div2k/qrcan.toml's [model] (the paper's recipe); RCAN's the same without meta
QRCAN_TRAIN = {'scale': SCALE, 'lr': 1e-4, 'style': 'standard', 'include_q_layer': True,
               'metadata': ['blur_kernel'], 'scheduler': 'cosine_annealing_warm_restarts',
               'scheduler_params': {'t_mult': 1, 'restart_period': 125000, 'lr_min': 1e-7}}
RCAN_TRAIN = {k: v for k, v in QRCAN_TRAIN.items()
              if k not in ('style', 'include_q_layer', 'metadata')}
# configs/div2k/han.toml's and qhan.toml's [model]
HAN_TRAIN = {'scale': SCALE, 'lr': 1e-4, 'scheduler': 'cosine_annealing_warm_restarts',
             'scheduler_params': {'t_mult': 1, 'restart_period': 40000, 'lr_min': 1e-7}}
QHAN_TRAIN = {**HAN_TRAIN, 'metadata': ['blur_kernel']}
# configs/div2k/san.toml's and qsan.toml's [model], at their full depth of 20 x 10
SRMD_TRAIN = {**{k: v for k, v in SRMD.items() if k != 'dtype'}, 'lr': 1e-4}
SFTMD_TRAIN = {**{k: v for k, v in SFTMD.items() if k != 'dtype'}, 'lr': 1e-4}
# the pre-upscaled families train on HR-size crops (the LR upscaled on the host): SPARNet
# with its BatchNorms in train mode, VDSR with the MSE loss and its clip of 0.1
SPARNET_TRAIN = {**{k: v for k, v in SPARNET.items() if k != 'dtype'}, 'lr': 1e-4}
VDSR_TRAIN = {**{k: v for k, v in VDSR.items() if k != 'dtype'}, 'lr': 1e-4}
SAN_TRAIN = {**HAN_TRAIN, 'max_combined_im_size': 20000, 'n_resgroups': 20,
             'n_resblocks': 10}
QSAN_TRAIN = {**SAN_TRAIN, 'metadata': ['blur_kernel']}


FULL_DEPTH = {'n_resgroups': 10, 'n_resblocks': 20, 'n_feats': 64}
# earlier training paths cut in depth to keep the script within its time (the main
# paths evaluate the full-depth models): the f32 train_sisr of the Q-RCAN recipe, the
# timed f32 and bf16 steps of Q-RCAN, RCAN, HAN and Q-HAN, phase 15's online-degradation
# run, phase 16's perceptual runs and timed steps and phase 17's multi-GPU runs at
# 5 x 10 (RECIPE_TRAIN_DEPTH); the timed steps of SAN and Q-SAN at 10 x 5
RECIPE_TRAIN_DEPTH = {'n_resgroups': 5, 'n_resblocks': 10}
RECIPE_CA_PER_FORWARD = RECIPE_TRAIN_DEPTH['n_resgroups'] * RECIPE_TRAIN_DEPTH['n_resblocks']


@contextlib.contextmanager
def tf32(cudnn, matmul):
    """cuDNN's and matmul's TF32 flags set for a block, restored after."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def bf16_ulps(a, b):
    """max |a - b| in units of b's bf16 spacing (the gap between b and the next bf16 of
    larger magnitude; 2^-133 at zero)."""
    import torch
    b = b.float()
    exponent = torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126)))
    return ((a.float() - b).abs() / torch.pow(2.0, exponent - 7)).max().item()


def phase_kernel_backward():
    """fused_channel_attention under autograd (the Function: the kernel forward, the
    plain version's VJP in f32 in the backward) against plain autograd through
    reference_channel_attention: in f32 at the training shape (on chip) with and
    without a gate (Q-RCAN's q_node), and at (8, 128, 128, 64), which takes the rounds
    route; in bf16 at the training shape with and without the gate, under the bf16
    train step's autocast (the map bf16, the weights and the gate f32), against plain
    autograd of the f32 inputs.  Bars: f32 output and every grad 1e-5 abs; bf16 output
    within 2 bf16 ULPs of the plain version on the same bf16 map, the map's grad within
    1 bf16 ULP of the f32 grad, the weights' and the gate's within 1e-5 abs + 1e-5 rel
    (the same f32 computation); the same bits on a rerun; the route the plan gives, and
    the bf16 launches counted by map and type.  Times per forward + backward (CUDA
    events) of both; and the kernel's forward alone at the training shape in graph
    replay, f32 and bf16, against its plain version and its bound."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    op = ca.fused_channel_attention
    gen = torch.Generator().manual_seed(7)
    results = []
    for shape, with_gate, dtype in ((TRAIN_SHAPE, False, torch.float32),
                                    (TRAIN_SHAPE, True, torch.float32),
                                    ((BATCH, LR_SIZE, LR_SIZE, 64), False, torch.float32),
                                    (TRAIN_SHAPE, False, torch.bfloat16),
                                    (TRAIN_SHAPE, True, torch.bfloat16)):
        args = ca_inputs(shape, dtype, 16, gen)
        gate = torch.sigmoid(torch.randn(shape[0], shape[-1], generator=gen)).cuda() \
            if with_gate else None
        cot = torch.randn(shape, generator=gen).cuda().to(dtype)
        bf16 = dtype == torch.bfloat16

        def run(fn, f32_inputs=False):
            leaves = [t.detach().clone().float() if f32_inputs else t.detach().clone()
                      for t in args]
            leaves = [t.requires_grad_() for t in leaves]
            g = None if gate is None else gate.clone().requires_grad_()
            with torch.autocast('cuda', dtype=torch.bfloat16, enabled=bf16):
                out = fn(*leaves, gate=g)
            out.backward(cot.float() if f32_inputs else cot)
            return out.detach(), [t.grad for t in leaves] + ([] if g is None else [g.grad])

        reset_launches()
        out, grads = run(op)
        again, grads_again = run(op)
        torch.cuda.synchronize()
        launches = read_launches()
        by_map = read_onchip_shapes()
        path, plan = planned_ca_route(shape, shape[-1] // 16, args[0].element_size())
        expected = {**NO_LAUNCHES, 'fused_channel_attention': 2}
        if path != 'three_pass':
            expected['fused_channel_attention_' + path] = 2
        expect_launches(launches, expected, 'backward case %s %s, plan %s %s'
                        % (shape, dtype, path, plan))
        names = ['x', 'w1', 'b1', 'w2', 'b2'] + (['gate'] if with_gate else [])
        grad_err = {}
        if bf16:
            if by_map != {'%s bfloat16' % 'x'.join(map(str, shape)): 2}:
                raise AssertionError('bf16 backward case launched %s' % by_map)
            with torch.no_grad(), torch.autocast('cuda', dtype=torch.bfloat16):
                plain_out = ca.reference_channel_attention(*args, gate=gate)
            out_err = bf16_ulps(out, plain_out)
            ref, ref_grads = run(ca.reference_channel_attention, f32_inputs=True)
            if out.dtype != torch.bfloat16 or out_err > 2:
                raise AssertionError('bf16 forward %s, %.2f ULPs from the plain version'
                                     % (out.dtype, out_err))
            for name, a, b in zip(names, grads, ref_grads):
                if name == 'x':
                    if a.dtype != torch.bfloat16 or bf16_ulps(a, b) > 1:
                        raise AssertionError('bf16 grad of x: %s, %.2f ULPs'
                                             % (a.dtype, bf16_ulps(a, b)))
                    grad_err[name] = bf16_ulps(a, b)
                else:
                    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                               msg=lambda m: name + ': ' + m)
                    grad_err[name] = (a - b).abs().max().item()
            max_err = {'ulps_from_plain': out_err,
                       'abs_from_f32': (out.float() - ref).abs().max().item()}
        else:
            ref, ref_grads = run(ca.reference_channel_attention)
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
            for name, a, b in zip(names, grads, ref_grads):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0,
                                           msg=lambda m: name + ': ' + m)
                grad_err[name] = (a - b).abs().max().item()
            max_err = (out - ref).abs().max().item()
        for name, a, c2 in zip(names, grads, grads_again):
            if not torch.equal(a, c2):
                raise AssertionError('grad of %s differs on a rerun' % name)
        if not torch.equal(out, again):
            raise AssertionError('the forward under autograd is not deterministic')
        results.append({'shape': list(shape), 'dtype': str(dtype).split('.')[-1],
                        'gate': with_gate, 'path': path, 'max_abs_err': max_err,
                        'grad_max_err': grad_err, 'grad_x_unit': 'bf16 ULPs' if bf16
                        else 'abs', 'launches_by_map': by_map,
                        'fwd_bwd_ms': cuda_ms(lambda: run(op), reps=10, rounds=3),
                        'plain_fwd_bwd_ms': cuda_ms(lambda: run(ca.reference_channel_attention),
                                                    reps=10, rounds=3)})
    forwards = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w1, b1, w2, b2 = ca_inputs(TRAIN_SHAPE, dtype, 16, gen)
        with torch.inference_mode():
            kern = lambda: op(x, w1, b1, w2, b2)
            plain = lambda: ca.reference_channel_attention(x, w1, b1, w2, b2)
            if dtype == torch.float32:
                err = (kern() - plain()).abs().max().item()
            else:
                err = bf16_ulps(kern(), plain())
                if err > 2:
                    raise AssertionError('bf16 forward at the training shape: %.2f ULPs' % err)
            timing = {}
            for name, fn in (('plain_ms', plain), ('ms', kern), ('ms', kern),
                             ('plain_ms', plain)):
                timing[name] = graph_ms(fn)  # the second turn of each is kept
        bytes_moved, ops, bound_ms = ca_bound(x, w1)
        forwards[str(dtype).split('.')[-1]] = {
            'shape': list(TRAIN_SHAPE), 'dtype': str(dtype).split('.')[-1],
            'max_abs_err' if dtype == torch.float32 else 'max_ulps': err,
            'bound_ms': bound_ms, 'bytes': bytes_moved, 'ops': ops, **timing}
    emit({'phase': 'kernel_backward', 'cases': results, 'forward_at_training_shape':
          forwards, 'nvidia_smi': nvidia_smi_line()})
    return forwards


def train_batches(n, rng, lr_size=16, meta=True):
    import numpy as np
    out = []
    for _ in range(n):
        batch = {'lr': rng.randint(0, 256, (2, lr_size, lr_size, 3)).astype(np.uint8),
                 'hr': rng.randint(0, 256, (2, lr_size * SCALE, lr_size * SCALE, 3))
                 .astype(np.uint8)}
        if meta:
            batch['metadata'] = rng.dirichlet(np.ones(META_COLS) * 5, 2).astype(np.float32)
        out.append(batch)
    return out


def phase_train_reference():
    """10 train steps (run_train: forward with the CA kernel, the plain VJP, Adam with
    the recipe's schedule) of RCAN and Q-RCAN at 2 x 2 blocks, 64 features, 4x, f32
    with TF32 off, on the card against the same 10 on the CPU from the same weights
    and batches (2 images of 16^2 each).  Bar: every loss within rtol 2e-4."""
    import numpy as np
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.ops import channel_attention as ca
    small = {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 64, 'seed': 3}
    report = {}
    with tf32(False, False):
        for name, model, internal in (('rcan', 'rcan', RCAN_TRAIN),
                                      ('qrcan', 'qrcan', QRCAN_TRAIN)):
            card = define_model(model, device='cuda', **small, **internal)
            host = define_model(model, device='cpu', **small, **internal)
            for handler in (card, host):
                handler.set_metadata_keys(['blur_kernel'] * META_COLS)
            batches = train_batches(10, np.random.RandomState(4), meta=model == 'qrcan')
            before = ca.fused_channel_attention.launches
            card_losses = [float(card.run_train(**b)[0]) for b in batches]
            launched = ca.fused_channel_attention.launches - before
            host_losses = [float(host.run_train(**b)[0]) for b in batches]
            rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, host_losses))
            delta = max((a.detach().cpu() - b.detach()).abs().max().item()
                        for a, b in zip(card.module.parameters(), host.module.parameters()))
            report[name] = {'card_losses': card_losses, 'cpu_losses': host_losses,
                            'max_rel_loss_diff': rel, 'max_abs_param_diff': delta,
                            'ca_launches': launched}
            if launched != 10 * 4 or not np.all(np.isfinite(card_losses)) or rel > 2e-4:
                raise AssertionError('%s training on the card: %d CA launches, losses %s '
                                     'against the CPU\'s %s' % (name, launched, card_losses,
                                                                host_losses))
    emit({'phase': 'train_reference', **report, 'nvidia_smi': nvidia_smi_line()})


def write_train_config(dirs, save_loc):
    """configs/div2k/qrcan.toml pointed at the seeded pairs: the same [model] at half
    depth (RECIPE_TRAIN_DEPTH: 5 x 10) and [training] (epoch_cutoff left out: it
    overrides --num_epochs), fused validation on, the pairs as both the training and
    the validation set."""
    from sisr_tpu_torch.utils import toml_io
    data_set = {'lr': dirs['lr_dir'], 'hr': dirs['hr_dir'], 'degradation_metadata': 'on_site',
                'metadata': ['blur_kernel']}
    path = os.path.join(os.path.dirname(save_loc), 'qrcan_train.toml')
    toml_io.dump({
        'experiment': 'qrcan_train', 'experiment_save_loc': save_loc,
        'data': {'batch_size': BATCH, 'dataloader_threads': 8,
                 'training_sets': {'data_1': {**data_set, 'crop': TRAIN_CROP,
                                              'random_augment': True}},
                 'eval_sets': {'data_1': data_set}},
        'model': {'name': 'qrcan', 'internal_params': {**QRCAN_TRAIN,
                                                       **RECIPE_TRAIN_DEPTH}},
        'training': {'gpu': 'single', 'seed': 8, 'metrics': ['PSNR', 'SSIM'],
                     'logging': 'visual', 'fused_val': True}}, path)
    return path


def run_train_cli(config, *args):
    """``train_sisr`` through the CLI entry point: the launch counts of exactly this
    run (set to 0 just before, read just after) and its seconds."""
    from sisr_tpu_torch import net_train
    reset_launches()
    tic = time.perf_counter()
    net_train.experiment_setup.main(args=['--parameters', config, *args],
                                    standalone_mode=False)
    return read_launches(), time.perf_counter() - tic


def timed_steps(handler, batch, steps):
    """``steps`` train steps: per step the wall ms (host clock to a synchronise) and
    the forward+loss / backward / optimizer ms (CUDA events)."""
    import torch
    walls, phases = [], []
    for _ in range(steps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        tic = time.perf_counter()
        events[0].record()
        loss = handler.forward_loss(batch)
        events[1].record()
        handler.backward(loss)
        events[2].record()
        handler.update()
        events[3].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tic) * 1e3)
        phases.append([events[i].elapsed_time(events[i + 1]) for i in range(3)])
    return walls, phases


@contextlib.contextmanager
def plain_channel_attention():
    """CALayer and QCALayer call the CA's plain version (plain autograd, no kernel)
    for a block: the yardstick of the step with the op's kernel and Function."""
    from sisr_tpu_torch.models import blocks, q_layers
    from sisr_tpu_torch.ops import channel_attention as ca
    saved = blocks.fused_channel_attention, q_layers.fused_channel_attention
    blocks.fused_channel_attention = q_layers.fused_channel_attention = \
        ca.reference_channel_attention
    try:
        yield
    finally:
        blocks.fused_channel_attention, q_layers.fused_channel_attention = saved


def train_step_breakdown(model, internal, steps=10, turns=True):
    """10 warm train steps of the full-width model (seed 8, f32, PyTorch's default TF32
    flags; HAN's gammas, SAN's gamma and W set) through the handler on seeded uint8
    batches of 8 LR crops of 64^2 (a pre-upscaled family's: HR-size crops of 256^2, the
    Y channel for VDSR): per step the wall ms (host clock to a synchronise) and the forward+loss /
    backward / optimizer ms (CUDA events), medians; with ``turns``, then 10 with the
    CA's plain version in its place (plain autograd) and 10 more with the kernel, in
    turns; the profiler over 3 steps: device-busy ms, the CA kernel's device ms, the
    idle share; the launches of one step; conv FLOPs; peak memory."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    handler = define_model(model, device='cuda', seed=8, **{**FULL_DEPTH, **internal})
    handler.set_metadata_keys(['blur_kernel'] * META_COLS)
    set_gammas(handler.module)
    rng = np.random.RandomState(6)
    hr = TRAIN_CROP * SCALE
    # a pre-upscaled family's LR crop is HR-size (one channel for a Y family)
    lr = hr if handler.im_input == 'interp' else TRAIN_CROP
    channels = handler.in_channels
    batch = {'lr': torch.from_numpy(rng.randint(0, 256, (BATCH, lr, lr, channels))
                                    .astype(np.uint8)).cuda(),
             'hr': torch.from_numpy(rng.randint(0, 256, (BATCH, hr, hr, channels))
                                    .astype(np.uint8)).cuda()}
    if handler.uses_metadata:
        batch['metadata'] = torch.from_numpy(rng.dirichlet(np.ones(META_COLS) * 5, BATCH)
                                             .astype(np.float32)).cuda()
    for _ in range(3):
        handler.run_train(**batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, phases = timed_steps(handler, batch, steps)
    report = {}
    if turns:
        with plain_channel_attention():
            plain_walls = timed_steps(handler, batch, steps)[0]
        report = {'plain_ca_median_step_wall_ms': statistics.median(plain_walls),
                  'kernel_turn_median_step_wall_ms': statistics.median(
                      timed_steps(handler, batch, steps)[0])}
    peak = torch.cuda.max_memory_allocated()
    reset_launches()
    handler.run_train(**batch)
    torch.cuda.synchronize()
    step_launches = read_launches()
    step_by_map = read_onchip_shapes()
    busy_ms, per_kernel = device_kernel_ms(lambda: handler.run_train(**batch), reps=3)
    ca_ms = sum(v for k, v in per_kernel.items() if any(n in k for n in CA_KERNELS)) / 3
    conv_ms = sum(v for k, v in per_kernel.items() if not any(n in k for n in CA_KERNELS)
                  and any(t in k.lower() for t in CONV_KERNEL_HINTS)) / 3
    x = batch['lr'].float() / 255.0
    fwd_flops = count_conv_flops(handler, *module_input(handler, x, batch.get('metadata')))
    head = next(m for m in handler.module.modules() if isinstance(m, torch.nn.Conv2d))
    head_flops = 2 * BATCH * lr ** 2 * head.out_channels * head.in_channels \
        * head.kernel_size[0] * head.kernel_size[1]
    # backward: the data grad and the weight grad of every conv, each the forward's
    # FLOPs, but no data grad for the head (its input needs none)
    step_flops = 3 * fwd_flops - head_flops
    wall = statistics.median(walls)
    med = [statistics.median(p[i] for p in phases) for i in range(3)]
    return {'median_step_wall_ms': wall, 'step_wall_ms': walls, **report,
            'forward_loss_ms': med[0], 'backward_ms': med[1], 'optimizer_ms': med[2],
            'device_busy_ms': busy_ms, 'device_idle_share':
                (1 - busy_ms / wall) if busy_ms else None,
            'ca_kernel_device_ms': ca_ms, 'conv_device_ms': conv_ms,
            'launches_per_step': step_launches, 'onchip_by_map_per_step': step_by_map,
            'conv_tflop_per_step': step_flops / 1e12,
            'tf32_bound_ms': step_flops / TF32_TENSOR_FLOPS * 1e3,
            'f32_bound_ms': step_flops / F32_CUDA_CORE_FLOPS * 1e3,
            'max_memory_allocated_gb': peak / 1e9, 'crops_per_s': BATCH / wall * 1e3,
            'top_kernels_ms': sorted(((k, v / 3) for k, v in per_kernel.items()),
                                     key=lambda kv: -kv[1])[:8]}


def phase_train_main_path(dirs, root):
    """``train_sisr`` on the Q-RCAN recipe at 5 x 10 for 2 epochs, then a resume for a
    third: finite losses, summary.csv, the checkpoints (the resumed one at step 6),
    every CA call on chip; 50 launches per train step.  ``eval_sisr --fused_eval`` of
    the best epoch.  Then the timed steps of Q-RCAN, RCAN, HAN and Q-HAN (5 x 10), SAN
    and Q-SAN (10 x 5), SRMD, SFTMD, SPARNet and VDSR.  cuDNN TF32 on,
    matmul TF32 off (PyTorch's defaults) throughout the phase."""
    import numpy as np
    import pandas as pd
    import torch
    save_loc = os.path.join(root, 'Results_train')
    config = write_train_config(dirs, save_loc)
    n_train = N_IMAGES // BATCH  # steps per epoch
    # train, validation, samples
    per_epoch = RECIPE_CA_PER_FORWARD * (n_train + N_IMAGES + 1)
    report = {'tf32': {'cudnn': True, 'matmul': False}}
    with tf32(True, False):
        for label, args, epochs in (('first', ('--num_epochs', '2'), 2),
                                    ('resume', ('--num_epochs', '1',
                                                '--continue_from_epoch', '1'), 1)):
            launches, seconds = run_train_cli(config, *args)
            expect_launches(launches, {**NO_LAUNCHES,
                                       'fused_channel_attention': per_epoch * epochs,
                                       'fused_channel_attention_onchip': per_epoch * epochs},
                            'train_sisr (%s)' % label)
            report[label] = {'launches': launches, 'cli_seconds': seconds}
        base = os.path.join(save_loc, 'qrcan_train')
        summary = pd.read_csv(os.path.join(base, 'result_outputs', 'summary.csv'))
        values = summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']].to_numpy()
        saved = torch.load(os.path.join(base, 'saved_models', 'train_model_2'),
                           weights_only=True, map_location='cpu')
        if list(summary['epoch']) != [0, 1, 2] or not np.isfinite(values).all() \
                or saved['step'] != 3 * n_train or not saved['optimizer']['state']:
            raise AssertionError('train_sisr: summary %s, checkpoint step %s'
                                 % (summary.to_dict('list'), saved['step']))
        for epoch in range(3):
            if not os.path.isfile(os.path.join(base, 'saved_models', 'train_model_%d' % epoch)):
                raise AssertionError('train_sisr: no checkpoint of epoch %d' % epoch)
        report['summary'] = summary.to_dict('list')
        eval_dirs = {**dirs, 'model_loc': save_loc}
        eval_launches, eval_seconds, frame = run_eval_cli(eval_dirs, 'train_best',
                                                          experiment='qrcan_train',
                                                          epoch='best')
        # the eval runs in f32 (the experiment's dtype): the batch's 128^2 maps take
        # the route ca_plan gives them on this card (with the q_node's gate, no meta:
        # the standard style), in rounds on an H100
        n_batches = -(-N_IMAGES // BATCH)
        route = planned_ca_route((BATCH, LR_SIZE, LR_SIZE, 64), 4, 4)[0]
        if route != 'rounds':
            raise AssertionError('the f32 eval\'s maps take the %s route' % route)
        expect_launches(eval_launches, {
            **NO_LAUNCHES, 'fused_channel_attention': RECIPE_CA_PER_FORWARD * n_batches,
            'fused_channel_attention_rounds': RECIPE_CA_PER_FORWARD * n_batches},
            'eval of the best epoch')
        best = summary.loc[summary['val-PSNR'].idxmax()]
        report['eval_best'] = {'launches': eval_launches, 'cli_seconds': eval_seconds,
                               'epoch': int(best['epoch']),
                               'mean_psnr': float(frame[('qrcan_train', 'PSNR')].mean()),
                               'val_psnr': float(best['val-PSNR'])}
        emit({'phase': 'train_main_path', 'model': 'qrcan 5x10 64f 4x f32, standard + '
              'q_node, 10 blur-kernel values, batch 8, LR crop 64', **report,
              'nvidia_smi': nvidia_smi_line()})
        breakdowns = {}
        # HAN's and Q-HAN's CA calls are RCAN's and Q-RCAN's: their steps skip the
        # turns against the CA's plain version; SAN and Q-SAN make no CA call
        cut, calls_cut = RECIPE_TRAIN_DEPTH, RECIPE_CA_PER_FORWARD
        san_cut = {'n_resgroups': 10, 'n_resblocks': 5}
        for name, model, internal, turns, calls in (
                ('qrcan_5x10', 'qrcan', {**QRCAN_TRAIN, **cut}, True, calls_cut),
                ('rcan_5x10', 'rcan', {**RCAN_TRAIN, **cut}, True, calls_cut),
                ('han_5x10', 'han', {**HAN_TRAIN, **cut}, False, calls_cut),
                ('qhan_5x10', 'qhan', {**QHAN_TRAIN, **cut}, False, calls_cut),
                ('san_10x5', 'san', {**SAN_TRAIN, **san_cut}, False, 0),
                ('qsan_10x5', 'qsan', {**QSAN_TRAIN, **san_cut}, False, 0),
                ('srmd_12', 'srmd', SRMD_TRAIN, False, 0),
                ('sftmd_16b', 'sftmd', SFTMD_TRAIN, False, 0),
                ('sparnet_128', 'sparnet', SPARNET_TRAIN, False, 0),
                ('vdsr_20', 'vdsr', VDSR_TRAIN, False, 0)):
            breakdowns[name] = train_step_breakdown(model, internal, turns=turns)
            per_step = breakdowns[name]['launches_per_step']
            expect_launches(per_step, {**NO_LAUNCHES, 'fused_channel_attention': calls,
                                       'fused_channel_attention_onchip': calls},
                            '%s train step' % name)
            interp = name in PRE_UPSCALED_PATHS
            emit({'phase': 'train_breakdown', 'model': name, 'batch': BATCH,
                  'lr_crop': TRAIN_CROP * SCALE if interp else TRAIN_CROP,
                  'lr_pre_upscaled': interp, 'tf32': report['tf32'], **breakdowns[name],
                  'nvidia_smi': nvidia_smi_line()})
    launches = {k: report['first']['launches'][k] + report['resume']['launches'][k]
                + report['eval_best']['launches'][k] for k in report['first']['launches']}
    return {'launches': launches, 'breakdowns': breakdowns}


# --- online degradation, the dynamic int8 conv, CelebA attributes, bf16 training ----------
# the online-degradation path: configs/div2k/qrcan.toml's model trained in bf16 with
# directory checkpoints and bf16 moments on the 16 HR images in device-mode online
# degradation
QRCAN_ONLINE = {**QRCAN_TRAIN, **RECIPE_TRAIN_DEPTH, 'dtype': 'bf16',
                'checkpoint_backend': 'orbax', 'checkpoint_dtype': 'bf16_moments'}
# host-mode online degradation with noise: the kernel's code and the noise level
QRCAN_NOISE = {**QRCAN_TRAIN, 'dtype': 'bf16', 'metadata': ['blur_kernel', 'noise']}
# Q-RCAN (sisr_tpu's e2e configuration) taking the blur kernel and two CelebA attributes
# by CelebA's own column names (eval_sisr --data_attributes reads every column as named)
QRCAN_CELEBA = {**QRCAN, 'metadata': ['blur_kernel', 'Male', 'Young']}
# the recipe's model on the blur kernel and the attributes a data table renames
QRCAN_SAMPLER = {**QRCAN_TRAIN, 'dtype': 'bf16', 'metadata': ['blur_kernel', 'gender', 'age']}
EDSR_F32 = {**EDSR, 'dtype': 'f32'}


def map_key(shape, dtype='bfloat16'):
    return '%s %s' % ('x'.join(map(str, shape)), dtype)


def phase_degradation():
    """degrade_batch_on_device (the train step's online degradation: the batched blur as
    one grouped conv, the ToPILImage truncation, the matmul-form bicubic) on the card
    against the CPU at the train step's HR crops, 8 x 256^2, with 8 random kernels of
    21^2 (numpy seed 5) and a PCA of 2000 kernels for the codes.  Bars: blurred HR and
    codes 1e-5 abs; LR 1e-5 abs but where a blurred value sits within 1e-4 of a uint8
    step (the truncation may fall either side), and there at most one step.  Times:
    the card's call (CUDA events), and the host chain it replaces (per image: scipy
    blur, ToPILImage, Pillow-exact bicubic down) over the batch."""
    import numpy as np
    import torch
    from sisr_tpu_torch.ops import degradations as deg
    from sisr_tpu_torch.ops.transforms import downsample, float_to_pil
    np.random.seed(5)
    kernels = deg.random_batch_kernel(BATCH).astype(np.float32)
    pca = deg.pca_matrix(deg.random_batch_kernel(2000).reshape(2000, -1), 10)
    rng = np.random.RandomState(5)
    side = TRAIN_CROP * SCALE
    hr = torch.from_numpy(rng.randint(0, 256, (BATCH, side, side, 3)).astype(np.uint8))
    hr_f = hr.float() / 255.0
    host = deg.degrade_batch_on_device(hr_f, torch.from_numpy(kernels), pca, SCALE)
    card_args = (hr_f.cuda(), torch.from_numpy(kernels).cuda(), pca, SCALE)
    card = [t.cpu() for t in deg.degrade_batch_on_device(*card_args)]
    blurred_err = (card[2] - host[2]).abs().max().item()
    code_err = (card[1] - host[1]).abs().max().item()
    lr_delta = (card[0] - host[0]).abs()
    on_edge = (host[2] * 255 - torch.round(host[2] * 255)).abs() < 1e-4
    off = lr_delta > 1e-5
    if blurred_err > 1e-5 or code_err > 1e-5 or lr_delta.max().item() > 1 / 255 \
            or off.float().mean().item() > on_edge.float().mean().item() + 1e-3:
        raise AssertionError('degrade_batch_on_device on the card: blurred %.3g, codes '
                             '%.3g, LR %.3g (%d values past 1e-5)'
                             % (blurred_err, code_err, lr_delta.max().item(),
                                int(off.sum())))
    card_ms = cuda_ms(lambda: deg.degrade_batch_on_device(*card_args), reps=10, rounds=3)
    tic = time.perf_counter()
    for i in range(BATCH):
        blurred = deg.blur_image(hr_f[i].numpy(), kernels[i])
        downsample(float_to_pil(blurred), SCALE)
    host_chain_ms = (time.perf_counter() - tic) * 1e3
    emit({'phase': 'degradation', 'hr_shape': [BATCH, side, side, 3], 'kernel': 21,
          'blurred_max_abs_err': blurred_err, 'codes_max_abs_err': code_err,
          'lr_max_abs_err': lr_delta.max().item(),
          'lr_values_past_1e-5': int(off.sum()), 'blurred_on_a_uint8_step': int(on_edge.sum()),
          'card_ms': card_ms, 'host_chain_ms_per_batch': host_chain_ms,
          'nvidia_smi': nvidia_smi_line()})


def phase_int8_dynamic():
    """The dynamic-scale int8 conv (conv_int8 without x_scale: each input quantised on
    its own absmax) on the card against the CPU: the quantised map, its scale and the
    int32 sums of one 3 x 3 conv of 64 -> 64 at the eval's map (8, 128, 128, 64), equal;
    then the dynamic EDSR program (edsr_int8_forward, 64 features, 16 blocks, 4x) on a
    2 x 32^2 batch, card against CPU within 1e-5 abs; and the time of the dynamic and
    the static program at the eval batch (8 x 128^2), in turns."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.handlers import _tree_to, define_model
    from sisr_tpu_torch.ops import quantization as qz
    from sisr_tpu_torch.tools.convert_weights import params_from_state_dict
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(BATCH, LR_SIZE, LR_SIZE, 64, generator=gen)
    kernel = torch.randn(3, 3, 64, 64, generator=gen) * 0.05
    q_kernel, w_scale = qz.quantize_kernel_int8(kernel)
    host_q, host_scale = qz.quantize_activations(x)
    card_q, card_scale = qz.quantize_activations(x.cuda())
    if not torch.equal(card_q.cpu(), host_q) or card_scale.item() != host_scale.item():
        raise AssertionError('dynamic quantisation differs on the card')
    sums_host = qz.conv_int8_accumulate(host_q, q_kernel)
    sums_card = qz.conv_int8_accumulate(card_q, q_kernel.cuda()).cpu()
    if sums_card.dtype != torch.int32 or not torch.equal(sums_card, sums_host):
        raise AssertionError('dynamic int8 conv: int32 sums differ on the card')
    out_err = (qz.conv_int8(x.cuda(), q_kernel.cuda(), w_scale.cuda()).cpu()
               - qz.conv_int8(x, q_kernel, w_scale)).abs().max().item()
    handler = define_model('edsr', device='cpu', seed=3, **EDSR_F32)
    params = params_from_state_dict('edsr', handler.module.state_dict())
    qp = qz.quantize_edsr_params(params)
    qp_card = _tree_to(qp, 'cuda')
    rng = np.random.RandomState(9)
    small = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
    with torch.inference_mode():
        host_out = qz.edsr_int8_forward(qp, small, EDSR['num_blocks'], SCALE, 0.1)
        card_out = qz.edsr_int8_forward(qp_card, small.cuda(), EDSR['num_blocks'], SCALE,
                                        0.1).cpu()
    forward_err = (card_out - host_out).abs().max().item()
    if out_err > 1e-5 or forward_err > 1e-5:
        raise AssertionError('dynamic int8 on the card: conv %.3g, EDSR %.3g'
                             % (out_err, forward_err))
    batch = torch.from_numpy(rng.rand(BATCH, LR_SIZE, LR_SIZE, 3).astype(np.float32)).cuda()
    with tf32(False, False):
        scales = qz.scales_on(qz.calibrate_edsr_scales(
            _tree_to(params, 'cuda'), [batch], EDSR['num_blocks'], SCALE, 0.1,
            margin=1.1), 'cuda')
    with torch.inference_mode():
        dynamic = lambda: qz.edsr_int8_forward(qp_card, batch, EDSR['num_blocks'], SCALE, 0.1)
        static = lambda: qz.edsr_int8_forward_static(qp_card, scales, batch,
                                                     EDSR['num_blocks'], SCALE, 0.1,
                                                     residual_dtype='float32')
        timing = {}
        for name, fn in (('static_ms', static), ('dynamic_ms', dynamic),
                         ('dynamic_ms', dynamic), ('static_ms', static)):
            timing[name] = cuda_ms(fn, reps=3, rounds=3, warm=1)
    emit({'phase': 'int8_dynamic', 'conv_map': [BATCH, LR_SIZE, LR_SIZE, 64],
          'scale': card_scale.item(), 'conv_max_abs_err': out_err,
          'edsr_forward_max_abs_err': forward_err, 'edsr': '64f 16 blocks 4x, batch 8 x '
          '128^2, f32 carry', **timing, 'nvidia_smi': nvidia_smi_line()})


def write_online_config(path, save_loc, experiment, internal, training_set, eval_set,
                        extra_data=None):
    """A train_sisr config of ``internal`` (configs/div2k/qrcan.toml's [training] keys:
    seed 8, PSNR and SSIM, fused validation) with one training and one eval table,
    batch 8 for both."""
    from sisr_tpu_torch.utils import toml_io
    toml_io.dump({
        'experiment': experiment, 'experiment_save_loc': save_loc,
        'data': {'batch_size': BATCH, 'eval_batch_size': BATCH, 'dataloader_threads': 8,
                 'training_sets': {'data_1': training_set},
                 'eval_sets': {'data_1': eval_set}, **(extra_data or {})},
        'model': {'name': 'qrcan', 'internal_params': internal},
        'training': {'gpu': 'single', 'seed': 8, 'metrics': ['PSNR', 'SSIM'],
                     'logging': 'visual', 'fused_val': True}}, path)
    return path


@contextlib.contextmanager
def module_inputs_seen(store):
    """Record, for each train step made with the device degradation on, the largest
    absolute value of the module's input (the LR made from the HR crops)."""
    from sisr_tpu_torch.models.handlers import BaseHandler
    prep = BaseHandler._prep_batch

    def spy(self, batch):
        out = prep(self, batch)
        if self.device_degrade and self.module.training:
            store.append(out[0].detach().abs().amax())
        return out

    BaseHandler._prep_batch = spy
    try:
        yield
    finally:
        BaseHandler._prep_batch = prep


def epoch_launches(calls, epochs, n_train, n_val):
    """CA launches of ``epochs`` train_sisr epochs, all on chip: the train steps, the
    validation batches and the first validation batch's samples."""
    n = calls * epochs * (n_train + n_val + 1)
    return {**NO_LAUNCHES, 'fused_channel_attention': n, 'fused_channel_attention_onchip': n}


def phase_online_train_main_path(dirs, root):
    """The bf16 online-degradation path: ``train_sisr`` of configs/div2k/qrcan.toml's
    model (cut to 5 x 10 QRCABs, 64 features, 4x, standard style with a q_node, its optimizer
    and schedule) in bf16, the training set the 16 HR images in device-mode online
    degradation (LR crops of 64: each step makes its LR on the card from the HR crops
    and their kernels; the metadata the kernels' 10 PCA codes, of 30000 kernels drawn
    at construction), no noise, flips; the eval set the 16 pairs with their blur-kernel
    CSV, validated fused in bf16 at batch 8; directory checkpoints (orbax backend) with
    bf16 moments; 2 epochs, then a resume for a third.  Every CA call on chip on a bf16
    map, counted by map: (8, 64, 64, 64) in the train steps, (8, 128, 128, 64) in the
    validation and samples.  Checks: finite losses, summary, the three checkpoints
    directories, the resumed one at step 6 with bf16 moments on disk, the module's
    input in every step the degraded HR (non-zero), not the zero placeholder.  Then
    ``eval_sisr --fused_eval`` of the best epoch from its directory (bf16, on chip).
    cuDNN TF32 on, matmul off (PyTorch's defaults; the blur turns TF32 off for itself)."""
    import numpy as np
    import pandas as pd
    import torch
    save_loc = os.path.join(root, 'Results_online')
    config = write_online_config(
        os.path.join(root, 'qrcan_online.toml'), save_loc, 'qrcan_online', QRCAN_ONLINE,
        {'hr': dirs['hr_dir'], 'crop': TRAIN_CROP, 'random_augment': True,
         'online_degradations': True,
         'online_degradation_params': {'device': True, 'noise': False}},
        {'lr': dirs['lr_dir'], 'hr': dirs['hr_dir'], 'degradation_metadata': 'on_site',
         'metadata': ['blur_kernel']})
    n_train = n_val = N_IMAGES // BATCH
    report = {'tf32': {'cudnn': True, 'matmul': False}}
    seen = []
    with tf32(True, False), module_inputs_seen(seen):
        for label, args, epochs in (('first', ('--num_epochs', '2'), 2),
                                    ('resume', ('--num_epochs', '1',
                                                '--continue_from_epoch', '1'), 1)):
            launches, seconds = run_train_cli(config, *args)
            by_map = read_onchip_shapes()
            expect_launches(launches, epoch_launches(RECIPE_CA_PER_FORWARD, epochs, n_train, n_val),
                            'train_sisr online (%s)' % label)
            want = {map_key(TRAIN_SHAPE): RECIPE_CA_PER_FORWARD * epochs * n_train,
                    map_key((BATCH, LR_SIZE, LR_SIZE, 64)):
                        RECIPE_CA_PER_FORWARD * epochs * (n_val + 1)}
            if by_map != want:
                raise AssertionError('train_sisr online (%s) launched %s, expected %s'
                                     % (label, by_map, want))
            report[label] = {'launches': launches, 'launches_by_map': by_map,
                             'cli_seconds': seconds}
    steps_seen = [float(v) for v in seen]
    if len(steps_seen) != 3 * n_train or min(steps_seen) < 0.05:
        raise AssertionError('device degradation: the module saw inputs of max %s'
                             % steps_seen)
    base = os.path.join(save_loc, 'qrcan_online')
    summary = pd.read_csv(os.path.join(base, 'result_outputs', 'summary.csv'))
    values = summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']].to_numpy()
    saved = os.path.join(base, 'saved_models')
    meta = json.load(open(os.path.join(saved, 'train_model_2', 'handler_meta.json')))
    optimizer = torch.load(os.path.join(saved, 'train_model_2', 'optimizer.pt'),
                           weights_only=True, map_location='cpu')
    moment_types = sorted({str(v.dtype) for s in optimizer['state'].values()
                           for k, v in s.items() if k in ('exp_avg', 'exp_avg_sq')})
    if list(summary['epoch']) != [0, 1, 2] or not np.isfinite(values).all() \
            or meta['step'] != 3 * n_train or moment_types != ['torch.bfloat16'] \
            or not all(os.path.isdir(os.path.join(saved, 'train_model_%d' % e))
                       for e in range(3)):
        raise AssertionError('train_sisr online: summary %s, step %s, moments %s, saved %s'
                             % (summary.to_dict('list'), meta['step'], moment_types,
                                sorted(os.listdir(saved))))
    report.update({'summary': summary.to_dict('list'), 'resumed_step': meta['step'],
                   'moments_on_disk': moment_types, 'module_input_max_per_step': steps_seen})
    eval_launches, eval_seconds, frame = run_eval_cli({**dirs, 'model_loc': save_loc},
                                                      'online_best',
                                                      experiment='qrcan_online',
                                                      epoch='best')
    eval_by_map = read_onchip_shapes()
    n_batches = -(-N_IMAGES // BATCH)
    expect_launches(eval_launches, {
        **NO_LAUNCHES, 'fused_channel_attention': RECIPE_CA_PER_FORWARD * n_batches,
        'fused_channel_attention_onchip': RECIPE_CA_PER_FORWARD * n_batches}, 'eval of the best '
        'online epoch')
    if eval_by_map != {map_key((BATCH, LR_SIZE, LR_SIZE, 64)): RECIPE_CA_PER_FORWARD * n_batches}:
        raise AssertionError('eval of the best online epoch launched %s' % eval_by_map)
    best = summary.loc[summary['val-PSNR'].idxmax()]
    report['eval_best'] = {'launches': eval_launches, 'launches_by_map': eval_by_map,
                           'cli_seconds': eval_seconds, 'epoch': int(best['epoch']),
                           'mean_psnr': float(frame[('qrcan_online', 'PSNR')].mean()),
                           'val_psnr': float(best['val-PSNR'])}
    emit({'phase': 'online_train_main_path', 'model': 'qrcan 5x10 64f 4x bf16, standard '
          '+ q_node, device-mode online degradation (kernel 21, 10 PCA codes), batch 8, '
          'LR crop 64, orbax-backend directories, bf16 moments', **report,
          'nvidia_smi': nvidia_smi_line()})
    launches = {k: report['first']['launches'][k] + report['resume']['launches'][k]
                + eval_launches[k] for k in eval_launches}
    return {'launches': launches}


def phase_host_degradation_train(dirs, root):
    """``train_sisr`` for one epoch of the recipe's model in bf16 on the 16 HR images in
    host-mode online degradation with noise (the defaults: noise level up to 0.08, no
    noise in 20% of the images): each item blurred, noised, truncated to uint8 and
    Pillow-bicubic downscaled on the host; the metadata 11 wide, the 10 PCA codes and
    the noise level x 10, and the model takes the 11.  The eval set the same images in
    the same mode, at batch 8.  Every CA call on chip; finite losses."""
    import numpy as np
    import pandas as pd
    save_loc = os.path.join(root, 'Results_noise')
    online = {'hr': dirs['hr_dir'], 'online_degradations': True,
              'online_degradation_params': {'noise': True}}
    config = write_online_config(
        os.path.join(root, 'qrcan_noise.toml'), save_loc, 'qrcan_noise', QRCAN_NOISE,
        {**online, 'crop': TRAIN_CROP, 'random_augment': True}, online)
    n_train = n_val = N_IMAGES // BATCH
    with tf32(True, False):
        launches, seconds = run_train_cli(config, '--num_epochs', '1')
    by_map = read_onchip_shapes()
    expect_launches(launches, epoch_launches(CA_PER_FORWARD, 1, n_train, n_val),
                    'train_sisr host-mode degradation')
    summary = pd.read_csv(os.path.join(save_loc, 'qrcan_noise', 'result_outputs',
                                       'summary.csv'))
    if list(summary['epoch']) != [0] or not np.isfinite(
            summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']].to_numpy()).all():
        raise AssertionError('train_sisr host-mode degradation: %s' % summary.to_dict('list'))
    emit({'phase': 'host_degradation_train', 'model': 'qrcan 10x20 64f 4x bf16, '
          'metadata blur_kernel (10) + noise', 'launches': launches,
          'launches_by_map': by_map, 'cli_seconds': seconds,
          'summary': summary.to_dict('list'), 'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches}


def write_celeba_workload(dirs, root):
    """The 16 pairs under CelebA's names (000001.png ..., hard links), their
    degradation_metadata.csv renamed alike, and a list_attr_celeba.txt of the 40
    attributes (-1 / 1, numpy seed 15) with a ``<stem>.jpg`` row for each."""
    import numpy as np
    import pandas as pd
    from sisr_tpu_torch.configuration.constants import celeba_attributes
    faces = {'lr_dir': os.path.join(root, 'celeba', 'lr'),
             'hr_dir': os.path.join(root, 'celeba', 'hr'),
             'model_loc': os.path.join(root, 'Results_celeba'),
             'out_loc': os.path.join(root, 'out_celeba'),
             'attributes': os.path.join(root, 'celeba', 'list_attr_celeba.txt')}
    names = sorted(n for n in os.listdir(dirs['lr_dir']) if n.endswith('.png'))
    renamed = {name: '%06d.png' % (i + 1) for i, name in enumerate(names)}
    for key in ('lr_dir', 'hr_dir'):
        os.makedirs(faces[key])
        for old, new in renamed.items():
            os.link(os.path.join(dirs[key], old), os.path.join(faces[key], new))
    meta = pd.read_csv(os.path.join(dirs['lr_dir'], 'degradation_metadata.csv'), index_col=0)
    meta.index = [renamed[n] for n in meta.index]
    meta.index.name = 'image'
    meta.to_csv(os.path.join(faces['lr_dir'], 'degradation_metadata.csv'))
    rng = np.random.RandomState(15)
    with open(faces['attributes'], 'w') as f:
        f.write('%d\n%s\n' % (len(renamed), ' '.join(celeba_attributes)))
        for name in sorted(renamed.values()):
            f.write('%s.jpg %s\n' % (name[:-4], ' '.join(
                '%2d' % v for v in rng.choice([-1, 1], len(celeba_attributes)))))
    return faces


def phase_attributes_eval(faces):
    """``eval_sisr --fused_eval --data_attributes`` of Q-RCAN (sisr_tpu's e2e
    configuration, bf16) taking the blur kernel and CelebA's Male and Young, 12 values,
    on the 16 renamed pairs: every attribute goes in front of the blur kernel, and the
    model selects its 12; every QRCAB tail one CA launch with the 12-value meta, on
    chip at (8, 128, 128, 64) bf16."""
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.utils import toml_io
    base = os.path.join(faces['model_loc'], 'qrcan_celeba')
    os.makedirs(os.path.join(base, 'saved_models'))
    toml_io.dump({'model': {'name': 'qrcan', 'internal_params': QRCAN_CELEBA}},
                 os.path.join(base, 'config.toml'))
    define_model('qrcan', device='cpu', seed=8, **QRCAN_CELEBA).save_model(
        'train_model', 0, os.path.join(base, 'saved_models'))
    launches, seconds, frame = run_eval_cli(
        faces, 'celeba_attributes', extra=('--data_attributes', faces['attributes']),
        experiment='qrcan_celeba')
    by_map = read_onchip_shapes()
    n = CA_PER_FORWARD * -(-N_IMAGES // BATCH)
    expect_launches(launches, {**NO_LAUNCHES, 'fused_channel_attention': n,
                               'fused_channel_attention_onchip': n}, 'attributes eval')
    if by_map != {map_key((BATCH, LR_SIZE, LR_SIZE, 64)): n}:
        raise AssertionError('attributes eval launched %s' % by_map)
    emit({'phase': 'attributes_eval', 'model': 'qrcan 10x20 64f 4x bf16 max_concat + '
          'q_node, metadata blur_kernel + Male + Young (12)', 'launches': launches,
          'launches_by_map': by_map, 'cli_seconds': seconds,
          'mean_psnr': float(frame[('qrcan_celeba', 'PSNR')].mean()),
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches}


def phase_sampler_train(faces, root):
    """``train_sisr`` for one epoch of the recipe's model in bf16 on the renamed pairs
    with CelebA attributes (the data tables' ``metadata = ["gender", "age"]``, amplified
    to +/-2, in front of the blur-kernel CSV's 10 values; the model takes all 12) and
    ``CelebaSplitSampler`` on gender ordering the epoch: the epoch's images with a
    positive gender first, then the rest, each image once.  Every CA call on chip."""
    import numpy as np
    import pandas as pd
    from sisr_tpu_torch.data import loader
    save_loc = os.path.join(root, 'Results_sampler')
    table = {'name': 'celeba_pairs', 'lr': faces['lr_dir'], 'hr': faces['hr_dir'],
             'cutoff': [0, N_IMAGES], 'degradation_metadata': 'on_site',
             'metadata': ['gender', 'age'], 'attribute_amplification': True}
    config = write_online_config(
        os.path.join(root, 'qrcan_sampler.toml'), save_loc, 'qrcan_sampler', QRCAN_SAMPLER,
        {**table, 'crop': TRAIN_CROP, 'random_augment': True}, table,
        {'attributes': {'celeba_pairs': faces['attributes']},
         'sampler_attributes': {'name': 'CelebaSplitSampler',
                                'selected_attribute': 'gender'}})
    orders = []
    batches = loader.DataLoader._batches

    def spy(self):
        out = batches(self)
        if self.sampler is not None:
            orders.append(([i for b in out for i in b], self.dataset))
        return out

    loader.DataLoader._batches = spy
    try:
        with tf32(True, False):
            launches, seconds = run_train_cli(config, '--num_epochs', '1')
    finally:
        loader.DataLoader._batches = batches
    n_train = n_val = N_IMAGES // BATCH
    expect_launches(launches, epoch_launches(CA_PER_FORWARD, 1, n_train, n_val),
                    'train_sisr with CelebaSplitSampler')
    if len(orders) != 1:
        raise AssertionError('the sampler ordered %d epochs' % len(orders))
    order, dataset = orders[0]
    gender = dataset.metadata_keys.index('gender')
    signs = [bool(dataset.metadata[i][gender] > 0) for i in order]
    split = sum(signs)
    if sorted(order) != list(range(N_IMAGES)) or not all(signs[:split]) \
            or any(signs[split:]) or dataset.metadata_keys[:2] != ['age', 'gender']:
        raise AssertionError('CelebaSplitSampler order %s, positive %s, keys %s'
                             % (order, signs, dataset.metadata_keys))
    summary = pd.read_csv(os.path.join(save_loc, 'qrcan_sampler', 'result_outputs',
                                       'summary.csv'))
    if not np.isfinite(summary[['train-loss', 'val-loss', 'val-PSNR']].to_numpy()).all():
        raise AssertionError('train_sisr with the sampler: %s' % summary.to_dict('list'))
    emit({'phase': 'sampler_train', 'order': order, 'positive_gender': split,
          'metadata_keys': dataset.metadata_keys, 'launches': launches,
          'cli_seconds': seconds, 'summary': summary.to_dict('list'),
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches}


def phase_bf16_train_steps(f32_breakdowns):
    """10 timed warm bf16 train steps (autocast around f32 parameters) of Q-RCAN and RCAN
    at 5 x 10 as configs/div2k/qrcan.toml trains them, through the handler (as
    train_step_breakdown: wall, forward / backward / optimizer, device busy, idle share,
    peak memory), beside this run's f32 steps of the same models.  Each step's CA
    launches (a block's each) on chip at (8, 64, 64, 64) bf16."""
    out = {}
    with tf32(True, False):
        for name, model, internal, calls in (
                ('qrcan_5x10', 'qrcan', {**QRCAN_TRAIN, **RECIPE_TRAIN_DEPTH},
                 RECIPE_CA_PER_FORWARD),
                ('rcan_5x10', 'rcan', {**RCAN_TRAIN, **RECIPE_TRAIN_DEPTH},
                 RECIPE_CA_PER_FORWARD)):
            bf16 = train_step_breakdown(model, {**internal, 'dtype': 'bf16'}, turns=False)
            expect_launches(bf16['launches_per_step'], {
                **NO_LAUNCHES, 'fused_channel_attention': calls,
                'fused_channel_attention_onchip': calls}, '%s bf16 step' % name)
            if bf16['onchip_by_map_per_step'] != {map_key(TRAIN_SHAPE): calls}:
                raise AssertionError('%s bf16 step launched %s'
                                     % (name, bf16['onchip_by_map_per_step']))
            f32 = f32_breakdowns[name]
            keys = ('median_step_wall_ms', 'forward_loss_ms', 'backward_ms', 'optimizer_ms',
                    'device_busy_ms', 'device_idle_share', 'ca_kernel_device_ms',
                    'max_memory_allocated_gb', 'crops_per_s')
            out[name] = {'bf16': {k: bf16[k] for k in keys + ('top_kernels_ms',)},
                         'f32': {k: f32[k] for k in keys},
                         'bf16_over_f32_wall': bf16['median_step_wall_ms']
                         / f32['median_step_wall_ms']}
    emit({'phase': 'train_breakdown_bf16', 'batch': BATCH, 'lr_crop': TRAIN_CROP,
          'tf32': {'cudnn': True, 'matmul': False}, **out, 'nvidia_smi': nvidia_smi_line()})
    return out


@contextlib.contextmanager
def host_time_split():
    """Seconds spent, while the block runs, in each part of the standard protocol:
    'protocol' (the whole protocol call), 'forward' (BaseHandler.run_eval: the
    forward on the card with its warm-up, and the copy back), 'colorspace' (the rest
    of ModelInterface.net_run_and_process: clipping and YCbCr on the host),
    'host_psnr' and 'host_ssim' (Metrics), 'resize' (the Pillow-exact LR bicubic),
    'image_writes' (safe_image_save) and 'collages' (interpret_sisr_images), and
    'other' (the protocol's remainder: decode, batching, the rest)."""
    from sisr_tpu_torch.evaluation import standard_eval
    from sisr_tpu_torch.models import handlers, interface
    from sisr_tpu_torch.ops import metrics
    split = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            tic = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                name = key(args) if callable(key) else key
                split[name] = split.get(name, 0.0) + time.perf_counter() - tic
        return wrapper

    patches = [(standard_eval, 'resize_uint8', 'resize'),
               (standard_eval, 'safe_image_save', 'image_writes'),
               (standard_eval, 'interpret_sisr_images', 'collages'),
               (metrics.Metrics, 'run_image_metric', lambda a: 'host_' + a[1].lower()),
               (handlers.BaseHandler, 'run_eval', 'forward'),
               (interface.ModelInterface, 'net_run_and_process', 'net_run_and_process'),
               (standard_eval.EvalHub, 'full_image_protocol', 'protocol'),
               (standard_eval.EvalHub, 'direct_model_protocol', 'protocol')]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, key in patches:
            setattr(obj, name, timed(key, getattr(obj, name)))
        yield split
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        split['colorspace'] = split.pop('net_run_and_process', 0.0) - split.get('forward', 0.0)
        split['other'] = split.get('protocol', 0.0) - sum(
            v for k, v in split.items() if k != 'protocol')


def lr_shapes(lr_dir):
    """(name, (h, w)) of each LR image, in the order the dataset reads them."""
    from PIL import Image
    shapes = []
    for name in sorted(n for n in os.listdir(lr_dir) if n.endswith('.png')):
        with Image.open(os.path.join(lr_dir, name)) as im:
            shapes.append((name, (im.height, im.width)))
    return shapes


def standard_launches(shapes, route_of, timed=True, residual=False,
                      per_forward=CA_PER_FORWARD):
    """The launch counts of a standard-protocol run at batch 1 (and the calls by
    route): ``per_forward`` kernel calls a forward, one forward an image and, when the
    run is timed, one more (the untimed first call) for the first image of each LR
    shape; each image's calls on the route ``route_of((h, w))`` gives ('onchip',
    'rounds', 'stream' or 'three_pass'), of the CA or, with ``residual``, of the CA +
    residual (whose rounds route its onchip_launches counts)."""
    by_route, seen = {}, set()
    for _, hw in shapes:
        route = route_of(hw)
        by_route[route] = by_route.get(route, 0) + per_forward * (
            1 + (timed and hw not in seen))
        seen.add(hw)
    total = sum(by_route.values())
    if residual:
        counts = {'fused_channel_attention_residual': total,
                  'fused_channel_attention_residual_onchip': by_route.get('rounds', 0),
                  'fused_channel_attention_residual_stream': by_route.get('stream', 0)}
    else:
        counts = {'fused_channel_attention': total,
                  'fused_channel_attention_onchip': by_route.get('onchip', 0),
                  'fused_channel_attention_rounds': by_route.get('rounds', 0),
                  'fused_channel_attention_stream': by_route.get('stream', 0)}
    return {**NO_LAUNCHES, **counts}, by_route


def run_standard_cli(mixed, results_name, experiment, extra=()):
    """``eval_sisr`` without --fused_eval at batch 1 through the CLI entry point
    (--time_models on, its default): the launch counts of exactly this run, its
    seconds, the host_time_split of it, its peak device memory (GB), its per-image
    CSV (None for --model_only) and its ca_onchip launches by map (read_onchip_shapes)."""
    import pandas as pd
    import torch
    from sisr_tpu_torch import net_eval
    args = ['--hr_dir', mixed['hr_dir'], '--lr_dir', mixed['lr_dir'], '-me', experiment,
            '0', '--model_loc', mixed['model_loc'], '--out_loc', mixed['out_loc'],
            '--results_name', results_name, '-m', 'PSNR', '-m', 'SSIM', '--scale',
            str(SCALE), '--batch_size', '1', '--full_directory', *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with host_time_split() as split:
        tic = time.perf_counter()
        net_eval.eval_run.main(args=args, standalone_mode=False)
        seconds = time.perf_counter() - tic
    launches, by_map = read_launches(), read_onchip_shapes()
    csv = os.path.join(mixed['out_loc'], results_name, 'standard_metrics',
                       'individual_metrics.csv')
    frame = pd.read_csv(csv, header=[0, 1], index_col=0) if os.path.isfile(csv) else None
    return launches, seconds, split, torch.cuda.max_memory_allocated() / 1e9, frame, by_map


def check_frame(frame, shapes, experiment, what):
    import numpy as np
    cols = [(experiment, 'PSNR'), (experiment, 'SSIM'), ('LR', 'PSNR'), ('LR', 'SSIM')]
    if list(frame.index) != [n for n, _ in shapes] or \
            not np.isfinite(frame[cols].to_numpy()).all():
        raise AssertionError('%s individual_metrics.csv: %s' % (what, frame))


def max_metric_diff(ours, theirs, sides):
    """The largest per-image |difference| of PSNR and SSIM on ``sides`` ((ours, theirs)
    column pairs), over the images of ``theirs``."""
    return {met: max(float((ours.loc[theirs.index, (a, met)] - theirs[(b, met)]).abs().max())
                     for a, b in sides) for met in ('PSNR', 'SSIM')}


def hold_bars(diff, what):
    for met, bar in (('PSNR', 0.01), ('SSIM', 1e-3)):
        if not diff[met] <= bar:
            raise AssertionError('%s: %s differs by %g' % (what, met, diff[met]))


def phase_standard_eval(mixed, experiment, fused_frame, images=True):
    """``eval_sisr`` on the standard protocol (batch 1, --time_models; with ``images``
    --save_im and comparisons on, else --no_image_comparison) over the mixed-size set
    in bf16: every CA call on the route its image's plan gives (Q-RCAN: with its 10
    meta values), 200 a forward; a finite row for every image and, with ``images``,
    an SR image and a collage (``image_comparison_<name>.pdf``, sisr_tpu's name); on
    the 16 shared pairs the metrics within 0.01 dB / 1e-3 of the fused protocol's on
    the same weights (``fused_frame``); img/s and the host time split."""
    shapes = lr_shapes(mixed['lr_dir'])
    m = META_COLS if experiment == 'qrcan_10x20' else 0
    expected, by_route = standard_launches(
        shapes, lambda hw: planned_ca_route((1,) + hw + (64,), 4, 2, m=m)[0],
        per_forward=BF16_PATHS[experiment][2])
    name = experiment.split('_')[0] + '_standard'
    launches, seconds, split, peak_gb, frame, by_map = run_standard_cli(
        mixed, name, experiment, ['--save_im'] if images else ['--no_image_comparison'])
    expect_launches(launches, expected, '%s standard protocol' % experiment)
    check_frame(frame, shapes, experiment, name)
    out = os.path.join(mixed['out_loc'], name)
    if images:
        written = sorted(os.listdir(os.path.join(out, experiment)))
        collages = sorted(os.listdir(os.path.join(out, 'model_comparisons')))
        expected_collages = sorted('image_comparison_%s.pdf' % os.path.splitext(n)[0]
                                   for n, _ in shapes)
        if written != [n for n, _ in shapes] or collages != expected_collages:
            raise AssertionError('%s: SR images %s, collages %s for %d images'
                                 % (name, written, collages, len(shapes)))
    diff = max_metric_diff(frame, fused_frame, ((experiment, experiment), ('LR', 'LR')))
    hold_bars(diff, '%s standard against fused on the shared pairs' % experiment)
    mean_psnr = float(frame[(experiment, 'PSNR')].mean())
    emit({'phase': name, 'images': len(shapes), 'lr_shapes': sorted({hw for _, hw in shapes}),
          'launches': launches, 'calls_by_route': by_route, 'onchip_by_map': by_map,
          'cli_seconds': seconds, 'img_per_s': len(shapes) / split['protocol'],
          'host_split_s': split, 'peak_memory_gb': peak_gb, 'mean_psnr': mean_psnr,
          'max_diff_to_fused_on_shared_pairs': diff, 'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'frame': frame, 'mean_psnr': mean_psnr,
            'onchip_by_map': by_map}


def bucket_of(hw, multiple=128):
    return tuple(-(-v // multiple) * multiple for v in hw)


def phase_bucketed_eval(mixed, unbucketed_frame, experiment='rcan_10x20'):
    """``--eval_buckets 128`` on ``experiment``'s standard protocol over the mixed-size
    set: every CA call given its image's valid extent (masked_launches equals the CA's
    launches) on the route of its bucket's plan (Q-HAN's LAM and CSAM exact on the
    zero-masked pad); every image's metrics within 0.01 dB / 1e-3 of the unbucketed
    run's."""
    shapes = lr_shapes(mixed['lr_dir'])
    expected, by_route = standard_launches(
        shapes, lambda hw: planned_ca_route((1,) + bucket_of(hw) + (64,), 4, 2)[0],
        per_forward=BF16_PATHS[experiment][2])
    expected['fused_channel_attention_masked'] = expected['fused_channel_attention']
    name = experiment.split('_')[0] + '_buckets'
    launches, seconds, split, peak_gb, frame, by_map = run_standard_cli(
        mixed, name, experiment, ['--eval_buckets', '128', '--no_image_comparison'])
    expect_launches(launches, expected, '%s --eval_buckets 128' % experiment)
    check_frame(frame, shapes, experiment, name)
    diff = max_metric_diff(frame, unbucketed_frame, ((experiment, experiment),))
    hold_bars(diff, '%s bucketed against unbucketed' % experiment)
    emit({'phase': name, 'images': len(shapes),
          'buckets': sorted({bucket_of(hw) for _, hw in shapes}), 'launches': launches,
          'calls_by_route': by_route, 'onchip_by_map': by_map, 'cli_seconds': seconds,
          'img_per_s': len(shapes) / split['protocol'], 'host_split_s': split,
          'peak_memory_gb': peak_gb, 'max_diff_to_unbucketed': diff,
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'onchip_by_map': by_map}


def tile_grid(hw, limit, shave=10):
    """The side of the tile grid BaseHandler._tiled_forward cuts an (h, w) LR map into
    at max_combined_im_size ``limit`` (1: none)."""
    h, w = hw
    level = 0
    while (h // 2 ** level + shave) * (w // 2 ** level + shave) >= limit:
        level += 1
    grid = 2 ** level
    while grid > 1 and (-(-h // grid) + 2 * shave > h or -(-w // grid) + 2 * shave > w):
        grid //= 2
    return grid


@contextlib.contextmanager
def tile_steps():
    """The tile-batch size of every BaseHandler._tile_step call while the block runs:
    {tiles in the batch: calls}."""
    from sisr_tpu_torch.models import handlers
    counts, step = {}, handlers.BaseHandler._tile_step

    def spy(self, batch):
        n = int(batch['lr'].shape[0])
        counts[n] = counts.get(n, 0) + 1
        return step(self, batch)

    handlers.BaseHandler._tile_step = spy
    try:
        yield counts
    finally:
        handlers.BaseHandler._tile_step = step


def phase_tiled_standard_eval(mixed, experiment, fused_frame):
    """``eval_sisr`` on the standard protocol (batch 1, --time_models,
    --no_image_comparison) over the mixed-size set for a tiled family (Q-SAN at
    max_combined_im_size 20000): each image on the tile grid its size gives (the 128^2
    maps none, the Set14 maps 2 x 2, the 510 x 339 map 4 x 4 tiles of 105 x 148), one
    tile batch a forward (and one more, untimed, for the first image of each shape),
    no CA call; a finite row for every image; on the 16 shared pairs the metrics
    within 0.01 dB / 1e-3 of the fused protocol's; img/s, the host time split (its
    resize part through the native resampler where it loaded) and peak memory."""
    from sisr_tpu_torch import native
    shapes = lr_shapes(mixed['lr_dir'])
    limit = MODELS[experiment][1]['max_combined_im_size']
    grids, expected_steps, seen = {}, {}, set()
    for _, hw in shapes:
        grid = tile_grid(hw, limit)
        grids[grid] = grids.get(grid, 0) + 1
        expected_steps[grid * grid] = expected_steps.get(grid * grid, 0) + 1 + (hw not in seen)
        seen.add(hw)
    name = experiment.split('_')[0] + '_standard'
    with tile_steps() as steps:
        launches, seconds, split, peak_gb, frame, _ = run_standard_cli(
            mixed, name, experiment, ['--no_image_comparison'])
    expect_launches(launches, NO_LAUNCHES, '%s standard protocol' % experiment)
    if steps != expected_steps:
        raise AssertionError('%s tile batches %s, expected %s' % (name, steps,
                                                                  expected_steps))
    check_frame(frame, shapes, experiment, name)
    diff = max_metric_diff(frame, fused_frame, ((experiment, experiment), ('LR', 'LR')))
    hold_bars(diff, '%s standard against fused on the shared pairs' % experiment)
    mean_psnr = float(frame[(experiment, 'PSNR')].mean())
    emit({'phase': name, 'images': len(shapes), 'max_combined_im_size': limit,
          'images_by_grid': grids, 'tile_batches': steps,
          'div2k_tiles': [tile_grid(DIV2K_LR, limit) ** 2] + [
              -(-v // tile_grid(DIV2K_LR, limit)) + 20 for v in DIV2K_LR],
          'launches': launches, 'cli_seconds': seconds,
          'img_per_s': len(shapes) / split['protocol'], 'host_split_s': split,
          'native': native.status(), 'peak_memory_gb': peak_gb, 'mean_psnr': mean_psnr,
          'max_diff_to_fused_on_shared_pairs': diff, 'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'frame': frame, 'mean_psnr': mean_psnr}


def hub_frame(dirs, results_name):
    import pandas as pd
    return pd.read_csv(os.path.join(dirs['out_loc'], results_name, 'standard_metrics',
                                    'individual_metrics.csv'), header=[0, 1], index_col=0)


def phase_qsan_grid(dirs, bf16_mean_psnr):
    """Q-SAN at 10 x 5 (QSAN_GRID) with max_combined_im_size 10000
    (experiment qsan_grid: a limit under which the 128^2 maps take a 2 x 2 grid of 84^2
    tiles) on the 16 pairs:
    the fused protocol (batch 8: one step a batch, the grid inside it, 32 tiles) and
    the standard protocol (batch 1, 4 tiles a forward), in bf16 and with --int8 (the
    standard run given the fused run's quantised weights and scales, calibrated on the
    fused batch's 100^2 centre crop, so both run one program); each pair's PSNR and
    SSIM within 0.01 dB / 1e-3 of the other protocol's; the int8 mean PSNR within 1 dB
    of bf16's; no CA call; the seconds of each run."""
    import torch
    experiment = 'qsan_grid'
    limit = MODELS[experiment][1]['max_combined_im_size']
    report = {'phase': 'qsan_grid', 'max_combined_im_size': limit,
              'grid': tile_grid((LR_SIZE, LR_SIZE), limit)}
    frames = {}
    n_batches = -(-N_IMAGES // BATCH)
    for int8 in (False, True):
        tag = 'int8' if int8 else 'bf16'
        runs = {}
        for fused, batch in ((True, BATCH), (False, 1)):
            name = 'qsan_grid_%s_%s' % ('fused' if fused else 'standard', tag)
            hub = eval_hub(dirs, experiment, name, fused, int8, batch)
            if int8 and not fused:  # the fused run's int8 state: one program
                hub.model_bundles[0].model.load_int8_state(*fused_handler._int8_ctx[1:])
            reset_launches()
            with tile_steps() as steps:
                tic = time.perf_counter()
                hub.full_image_protocol()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - tic
            expect_launches(read_launches(), NO_LAUNCHES, name)
            expected = {BATCH * 4: n_batches} if fused else {4: N_IMAGES}
            if steps != expected:
                raise AssertionError('%s tile batches %s, expected %s' % (name, steps,
                                                                          expected))
            frames[name] = hub_frame(dirs, name)
            check_frame(frames[name], lr_shapes(dirs['lr_dir']), experiment, name)
            runs['fused' if fused else 'standard'] = {
                'seconds': seconds, 'tile_batches': steps,
                'mean_psnr': float(frames[name][(experiment, 'PSNR')].mean())}
            if fused:
                fused_handler = hub.model_bundles[0].model
        diff = max_metric_diff(frames['qsan_grid_standard_' + tag],
                               frames['qsan_grid_fused_' + tag],
                               ((experiment, experiment), ('LR', 'LR')))
        hold_bars(diff, 'qsan grid %s: standard against fused' % tag)
        report[tag] = {**runs, 'max_diff_standard_to_fused': diff}
    if not abs(report['int8']['fused']['mean_psnr'] - report['bf16']['fused']['mean_psnr']) < 1:
        raise AssertionError('qsan grid int8 mean PSNR is not within 1 dB of bf16\'s')
    report['qsan_20x5_bf16_mean_psnr'] = bf16_mean_psnr
    report['nvidia_smi'] = nvidia_smi_line()
    emit(report)
    return {'launches': dict(NO_LAUNCHES), 'frame': frames['qsan_grid_standard_bf16']}


def write_interp_workload(dirs, root):
    """The 16 pairs with their LR upscaled to HR size on the host (Pillow bicubic: a
    pre-upscaled family's data folder, as configs/celebahq/qsparnet.toml's
    ``lr_interp_512``), their degradation_metadata.csv beside them."""
    from PIL import Image
    interp = {**dirs, 'lr_dir': os.path.join(root, 'interp', 'lr')}
    os.makedirs(interp['lr_dir'])
    for name in sorted(os.listdir(dirs['lr_dir'])):
        src = os.path.join(dirs['lr_dir'], name)
        if name.endswith('.png'):
            with Image.open(src) as im:
                im.resize((im.width * SCALE, im.height * SCALE), Image.BICUBIC).save(
                    os.path.join(interp['lr_dir'], name))
        else:
            shutil.copy(src, interp['lr_dir'])
    return interp


def write_multiple_subset(mixed, root, multiple=8):
    """The images of the mixed-size set whose HR sides are multiples of ``multiple``
    (hard links, their metadata rows): the sizes on which SPARNet at its default
    in_size (3 stride-2 steps) gives an output of its input's size, as in sisr_tpu.
    The others (500 x 480, 276^2, 500 x 360, 584 x 388, 2040 x 1356) would give a larger
    one, whose metrics fail in both packages."""
    import pandas as pd
    from PIL import Image
    sub = {**mixed, 'lr_dir': os.path.join(root, 'mixed8', 'lr'),
           'hr_dir': os.path.join(root, 'mixed8', 'hr'),
           'out_loc': os.path.join(root, 'out_mixed8')}
    for key in ('lr_dir', 'hr_dir'):
        os.makedirs(sub[key])
    names = []
    for name in sorted(n for n in os.listdir(mixed['hr_dir']) if n.endswith('.png')):
        with Image.open(os.path.join(mixed['hr_dir'], name)) as im:
            size = im.size
        if size[0] % multiple == 0 and size[1] % multiple == 0:
            names.append(name)
            for key in ('lr_dir', 'hr_dir'):
                os.link(os.path.join(mixed[key], name), os.path.join(sub[key], name))
    csv = os.path.join(mixed['lr_dir'], 'degradation_metadata.csv')
    rows = pd.read_csv(csv, index_col=0)
    rows.loc[names].to_csv(os.path.join(sub['lr_dir'], 'degradation_metadata.csv'))
    return sub


def phase_preupscaled_standard(mixed, dirs, root, experiment='qsparnet_128'):
    """``eval_sisr`` on the standard protocol (batch 1, --time_models,
    --no_image_comparison) of Q-SPARNet at SPARNet's default sizes, bf16, over the
    mixed-size set's images whose sides are multiples of 8 (write_multiple_subset): the
    host Pillow bicubic of each LR is the module's input; the hourglasses halve each map
    5 times, so the sides that are no multiple of 32 (720 x 576, 248 x 360, 528 x 656)
    take the nearest-exact resize.  No CA launch; a finite row for every image; on the 16
    shared pairs the model's PSNR within 0.3 dB of the fused protocol's (its input the
    device bicubic: sisr_tpu's bar for the family); then ``--eval_buckets 128`` is
    ignored with sisr_tpu's notice (every PSNR within 1e-3 dB of the unbucketed run's)."""
    import io
    import numpy as np
    sub = write_multiple_subset(mixed, root)
    shapes = lr_shapes(sub['lr_dir'])
    _, fused_seconds, fused = run_eval_cli(dirs, 'qsparnet_std_fused', experiment=experiment)
    launches, seconds, split, peak_gb, frame, _ = run_standard_cli(
        sub, 'qsparnet_standard', experiment, ['--no_image_comparison'])
    expect_launches(launches, NO_LAUNCHES, '%s standard protocol' % experiment)
    check_frame(frame, shapes, experiment, 'qsparnet_standard')
    shared = fused.index
    psnr_diff = float((frame.loc[shared, (experiment, 'PSNR')]
                       - fused[(experiment, 'PSNR')]).abs().max())
    ssim_diff = float((frame.loc[shared, (experiment, 'SSIM')]
                       - fused[(experiment, 'SSIM')]).abs().max())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        b_launches, b_seconds, _, _, bucketed, _ = run_standard_cli(
            sub, 'qsparnet_buckets', experiment, ['--eval_buckets', '128',
                                                  '--no_image_comparison'])
    notice = 'bucketed eval is not exact for this architecture' in out.getvalue()
    bucket_diff = float((bucketed[(experiment, 'PSNR')]
                         - frame[(experiment, 'PSNR')]).abs().max())
    odd = sorted({(h * SCALE, w * SCALE) for _, (h, w) in shapes
                  if (h * SCALE) % 32 or (w * SCALE) % 32})
    emit({'phase': 'qsparnet_standard', 'model': 'qsparnet defaults (in_size 128) bf16, '
          '10 blur-kernel values', 'images': len(shapes),
          'hr_shapes': sorted({(h * SCALE, w * SCALE) for _, (h, w) in shapes}),
          'hr_shapes_with_odd_hourglass_sides': odd, 'launches': launches,
          'cli_seconds': seconds, 'img_per_s': len(shapes) / split['protocol'],
          'host_split_s': split, 'peak_memory_gb': peak_gb,
          'mean_psnr': float(frame[(experiment, 'PSNR')].mean()),
          'max_psnr_diff_to_fused_on_shared_pairs': psnr_diff,
          'max_ssim_diff_to_fused_on_shared_pairs': ssim_diff,
          'fused_cli_seconds': fused_seconds, 'eval_buckets_notice': notice,
          'eval_buckets_max_psnr_diff': bucket_diff, 'eval_buckets_launches': b_launches,
          'eval_buckets_cli_seconds': b_seconds, 'nvidia_smi': nvidia_smi_line()})
    expect_launches(b_launches, NO_LAUNCHES, '%s --eval_buckets 128' % experiment)
    if not odd or not psnr_diff <= 0.3 or not notice or not bucket_diff <= 1e-3:
        raise AssertionError('%s standard protocol: odd sides %s, PSNR %g from the fused '
                             'protocol, buckets notice %s, %g from unbucketed'
                             % (experiment, odd, psnr_diff, notice, bucket_diff))
    return {'launches': launches, 'frame': frame}


def phase_int8_standard(mixed, bf16_mean_psnr):
    """``--int8`` on RCAN's standard protocol over the mixed-size set (calibrated on the
    first image): every RCAB tail one CA + residual call (x f32, r bf16) on the route
    ca_res_plan gives its image, in rounds or streaming (the DIV2K-size image, rows
    2b and 1b's stream route), none in three passes, and no CA launch; mean PSNR within
    1 dB of the bf16 run's; peak memory.  Beforehand, the stream tail timed at the
    DIV2K-size image's map in turns against its three passes, beside its plain
    version."""
    import torch
    from sisr_tpu_torch.ops import channel_attention as ca
    shapes = lr_shapes(mixed['lr_dir'])
    def route_of(hw):
        route = planned_res_route((1,) + hw + (64,), 4, 4, 2)[0]
        return 'rounds' if route == 'onchip' else route
    expected, by_route = standard_launches(shapes, route_of, residual=True)
    if set(by_route) != {'rounds', 'stream'}:
        raise AssertionError('int8 standard protocol routes %s' % by_route)
    # the tail at the DIV2K-size image's map: x f32 (the dequantised conv output), r the
    # bf16 carry; streaming on this card, timed in turns against its three passes
    (hw,) = {hw for _, hw in shapes if route_of(hw) == 'stream'}
    gen = torch.Generator().manual_seed(13)
    x, w1, b1, w2, b2 = ca_inputs((1,) + hw + (64,), torch.float32, 16, gen)
    r = torch.rand(x.shape, generator=gen).to(torch.bfloat16).cuda()
    with torch.inference_mode():
        tail = lambda: ca.fused_channel_attention_residual(x, r, w1, b1, w2, b2)
        three = lambda: ca._res_three_pass(x, r, w1, b1, w2, b2)
        plain = lambda: ca.reference_channel_attention_residual(x, r, w1, b1, w2, b2)
        err = (tail().float() - plain().float()).abs().max().item()
        torch.testing.assert_close(tail().float(), plain().float(), atol=1e-6, rtol=1.6e-2)
        div2k_tail = {'shape': list(x.shape), 'max_abs_err': err,
                      'plan': planned_res_route(x.shape, 4, 4, 2)[1]}
        for name, fn in (('three_pass_ms', three), ('ms', tail), ('ms', tail),
                         ('three_pass_ms', three)):
            div2k_tail[name] = graph_ms(fn)  # the second turn of each is kept
        div2k_tail['plain_ms'] = graph_ms(plain)
    bytes_moved, ops, div2k_tail['bound_ms'] = res_bound(x, r, w1)
    launches, seconds, split, peak_gb, frame, _ = run_standard_cli(
        mixed, 'rcan_int8_standard', 'rcan_10x20', ['--int8', '--no_image_comparison'])
    expect_launches(launches, expected, 'rcan --int8 standard protocol')
    check_frame(frame, shapes, 'rcan_10x20', 'rcan_int8_standard')
    mean_psnr = float(frame[('rcan_10x20', 'PSNR')].mean())
    if not abs(mean_psnr - bf16_mean_psnr) < 1.0:
        raise AssertionError('int8 standard mean PSNR %.4f is not within 1 dB of bf16\'s '
                             '%.4f' % (mean_psnr, bf16_mean_psnr))
    emit({'phase': 'rcan_int8_standard', 'images': len(shapes), 'launches': launches,
          'calls_by_route': by_route, 'cli_seconds': seconds,
          'img_per_s': len(shapes) / split['protocol'], 'host_split_s': split,
          'peak_memory_gb': peak_gb, 'mean_psnr': mean_psnr,
          'bf16_mean_psnr': bf16_mean_psnr, 'stream_tail': div2k_tail,
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'stream_tail': div2k_tail}


def phase_model_only(mixed):
    """``--model_only``: one SR image per LR image, one forward each (untimed)."""
    shapes = lr_shapes(mixed['lr_dir'])
    expected, by_route = standard_launches(
        shapes, lambda hw: planned_ca_route((1,) + hw + (64,), 4, 2)[0], timed=False)
    launches, seconds, split, _, _, by_map = run_standard_cli(
        mixed, 'rcan_model_only', 'rcan_10x20', ['--model_only', '--no_image_comparison'])
    expect_launches(launches, expected, 'rcan --model_only')
    out = os.path.join(mixed['out_loc'], 'rcan_model_only')
    written = sorted(os.listdir(os.path.join(out, 'rcan_10x20')))
    if written != [n for n, _ in shapes] or os.path.isdir(os.path.join(out,
                                                                      'standard_metrics')):
        raise AssertionError('--model_only wrote %s' % written)
    emit({'phase': 'rcan_model_only', 'images': len(written), 'launches': launches,
          'calls_by_route': by_route, 'onchip_by_map': by_map, 'cli_seconds': seconds,
          'img_per_s': len(shapes) / split['protocol'], 'host_split_s': split,
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'onchip_by_map': by_map}


def phase_qrcan_f32_model_only(mixed):
    """``eval_sisr --model_only`` of Q-RCAN as configs/div2k/qrcan.toml builds it (its
    [model] table as shipped: standard style, a q_node in every block, 10 blur-kernel
    values, no dtype, so f32; 10 x 20 at 64 features, the handler's defaults; seeded
    weights) over the mixed-size set, TF32 off: one forward an image, every CA call
    (with the q_node's gate) on the route its image's plan gives, the DIV2K-size
    image's 200 streaming and the rest on chip; img/s and the host split.  Then that
    image's SR output against the same forward with the CA's plain version, within
    the f32 forward bar of 5e-4 abs."""
    import numpy as np
    import pandas as pd
    import torch
    from PIL import Image
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.utils import toml_io
    here = os.path.dirname(os.path.abspath(__file__))
    model = toml_io.load(os.path.join(here, 'configs', 'div2k', 'qrcan.toml'))['model']
    name, params = model['name'], model['internal_params']
    if 'dtype' in params:
        raise AssertionError('configs/div2k/qrcan.toml sets a dtype')
    experiment = 'qrcan_recipe_f32'
    base = os.path.join(mixed['model_loc'], experiment)
    os.makedirs(os.path.join(base, 'saved_models'))
    toml_io.dump({'model': model}, os.path.join(base, 'config.toml'))
    define_model(name, device='cpu', seed=8, **params).save_model(
        'train_model', 0, os.path.join(base, 'saved_models'))
    shapes = lr_shapes(mixed['lr_dir'])
    route_of = lambda hw: planned_ca_route((1,) + hw + (64,), 4, 4)[0]
    expected, by_route = standard_launches(shapes, route_of, timed=False)
    if by_route.get('stream') != CA_PER_FORWARD or set(by_route) != {'onchip', 'stream'}:
        raise AssertionError('f32 Q-RCAN routes %s: the DIV2K-size image alone should '
                             'stream' % by_route)
    launches, seconds, split, peak_gb, _, by_map = run_standard_cli(
        mixed, 'qrcan_f32_model_only', experiment, ['--model_only', '--no_image_comparison'])
    expect_launches(launches, expected, 'f32 qrcan --model_only')
    written = sorted(os.listdir(os.path.join(mixed['out_loc'], 'qrcan_f32_model_only',
                                             experiment)))
    if written != [n for n, _ in shapes]:
        raise AssertionError('f32 qrcan --model_only wrote %s' % written)

    # the DIV2K-size image: the kernel's forward against the plain CA's
    image = 'div2k_0801.png'
    meta_csv = pd.read_csv(os.path.join(mixed['lr_dir'], 'degradation_metadata.csv'),
                           index_col=0)
    raw = np.asarray(json.loads(meta_csv.loc[image, 'blur_kernel']), np.float32)
    with Image.open(os.path.join(mixed['lr_dir'], image)) as im:
        lr = np.asarray(im.convert('RGB'), np.float32) / 255
    card = define_model(name, device='cuda', seed=8, **params)
    card.set_metadata_keys(['blur_kernel'] * META_COLS)
    x = torch.from_numpy(lr[None]).cuda()
    meta = card.prepare_metadata(x, torch.from_numpy(raw[None]).cuda())
    with torch.inference_mode():
        reset_launches()
        out = card.forward(x, meta)
        torch.cuda.synchronize()
        forward_launches = read_launches()
        with plain_channel_attention():
            ref = card.forward(x, meta)
    expect_launches(forward_launches, {**NO_LAUNCHES, 'fused_channel_attention':
                                       CA_PER_FORWARD, 'fused_channel_attention_stream':
                                       CA_PER_FORWARD}, 'f32 qrcan forward at DIV2K size')
    err = (out - ref).abs().max().item()
    if tuple(out.shape) != (1, lr.shape[0] * SCALE, lr.shape[1] * SCALE, 3) or \
            not bool(torch.isfinite(out).all()) or not err <= 5e-4:
        raise AssertionError('f32 qrcan at DIV2K size: shape %s, max abs err %g against '
                             'the plain CA' % (tuple(out.shape), err))
    emit({'phase': 'qrcan_f32_model_only', 'config': 'configs/div2k/qrcan.toml',
          'images': len(shapes), 'launches': launches, 'calls_by_route': by_route,
          'onchip_by_map': by_map, 'cli_seconds': seconds,
          'img_per_s': len(shapes) / split['protocol'], 'host_split_s': split,
          'peak_memory_gb': peak_gb,
          'div2k_forward_max_abs_err_vs_plain_ca': err, 'div2k_lr_shape': list(lr.shape[:2]),
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches, 'div2k_max_abs_err': err, 'onchip_by_map': by_map}


def phase_train_standard_val(dirs, root, recipe='qrcan', source_dir='div2k'):
    """``train_sisr`` on configs/<source_dir>/<recipe>.toml as shipped (no fused_val key:
    the standard validation epoch), with only its data paths (every training set and
    the eval set on the 16 pairs; for configs/celebahq/qsparnet.toml their LR upscaled
    to HR size on the host, write_interp_workload), save location, num_epochs and
    epoch_cutoff (1) set, and the eval set's ``cutoff`` (div2k's ``name = "div2k"``
    selects DIV2K's validation images by index, 800-900, celebahq's cutoff CelebA-HQ's
    28000-30000, which the 16 pairs do not have): one epoch, 200 CA launches a forward on
    the planned routes (the train steps' (batch, 64, 64, 64) and the validation's (1,
    128, 128, 64) f32 maps; none for Q-SAN, SFTMD and Q-SPARNet); then a fused_val = true
    validation of the same checkpoint, its val-PSNR within 0.01 dB of the standard
    epoch's.  cuDNN TF32 on, matmul off (PyTorch's defaults)."""
    import numpy as np
    import pandas as pd
    from sisr_tpu_torch.training.handler import TrainingHandler
    from sisr_tpu_torch.utils import toml_io
    here = os.path.dirname(os.path.abspath(__file__))
    source = os.path.join('configs', source_dir, recipe + '.toml')
    config = toml_io.load(os.path.join(here, source))
    if 'fused_val' in config['training']:
        raise AssertionError('%s sets fused_val' % source)
    save_loc = os.path.join(root, 'Results_shipped_' + recipe)
    config['experiment_save_loc'] = save_loc
    training_sets = list(config['data']['training_sets'].values())
    for table in training_sets + [config['data']['eval_sets']['data_1']]:
        table['lr'], table['hr'] = dirs['lr_dir'], dirs['hr_dir']
    config['data']['eval_sets']['data_1']['cutoff'] = N_IMAGES
    config['training']['epoch_cutoff'] = 1
    path = os.path.join(root, recipe + '_shipped.toml')
    toml_io.dump(config, path)
    batch_size = config['data']['batch_size']
    n_train = len(training_sets) * N_IMAGES // batch_size
    routes = {'train': planned_ca_route((batch_size,) + TRAIN_SHAPE[1:], 4, 4)[0],
              'validation': planned_ca_route((1, LR_SIZE, LR_SIZE, 64), 4, 4)[0]}
    calls = 0 if config['model']['name'] in NO_CA_MODELS else CA_PER_FORWARD
    counts = {'train': calls * n_train, 'validation': calls * N_IMAGES}
    expected = dict(NO_LAUNCHES)
    for part, route in routes.items():
        expected['fused_channel_attention'] += counts[part]
        if route != 'three_pass':
            expected['fused_channel_attention_' + route] += counts[part]
    with tf32(True, False):
        launches, seconds = run_train_cli(path, '--num_epochs', '1')
        expect_launches(launches, expected, 'train_sisr %s (standard validation)' % source)
        base = os.path.join(save_loc, config['experiment'])
        summary = pd.read_csv(os.path.join(base, 'result_outputs', 'summary.csv'))
        if list(summary['epoch']) != [0] or not np.isfinite(
                summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']].to_numpy()).all():
            raise AssertionError('train_sisr (standard validation): %s'
                                 % summary.to_dict('list'))
        handler = TrainingHandler(
            experiment_name=config['experiment'], save_loc=save_loc,
            model_params=config['model'], data_params=config['data'], gpu='single',
            num_epochs=1, continue_from_epoch=0, metrics=config['training']['metrics'],
            save_samples=False, fused_val=True)
        if not handler._use_fused_val():
            raise AssertionError('the fused validation does not serve the recipe')
        fused = handler.eval(0)
    diff = {'PSNR': abs(float(np.mean(fused['val-PSNR'])) - float(summary['val-PSNR'][0])),
            'SSIM': abs(float(np.mean(fused['val-SSIM'])) - float(summary['val-SSIM'][0]))}
    hold_bars(diff, 'standard against fused validation')
    emit({'phase': ('' if recipe == 'qrcan' else recipe + '_') + 'train_standard_val',
          'config': source, 'launches': launches, 'routes': routes, 'cli_seconds': seconds,
          'summary': summary.to_dict('list'),
          'fused_val_psnr': float(np.mean(fused['val-PSNR'])),
          'fused_val_ssim': float(np.mean(fused['val-SSIM'])), 'diff': diff,
          'nvidia_smi': nvidia_smi_line()})
    return {'launches': launches}


# --- the perceptual loss, FACE_SIM, serving export and the host tools -------------------
# configs/div2k/qrcan.toml's model and optimizer (cut to 5 x 10) in f32 with the VGG54
# perceptual term (lambda 1.0) on a seeded torchvision-layout VGG19 trunk to conv5_4
QRCAN_PERCEPTUAL = {**QRCAN_TRAIN, **RECIPE_TRAIN_DEPTH, 'perceptual': 1.0}
# the perceptual loss card against the CPU: Q-RCAN cut to 2 x 2, batch 2, LR crops of
# 16 (the CPU runs the whole VGG19 trunk on 4 images of 64^2 a step)
PERCEPTUAL_CPU_DEPTH = {'n_resgroups': 2, 'n_resblocks': 2, 'n_feats': 64}
LIGHTCNN_CLASSES = 79077  # LightCNN-29's released checkpoint (its fc2 the loader drops)


def write_vgg19_weights(path, seed=5):
    """A torchvision-layout VGG19 state_dict (``features.N.*``, the trunk to conv5_4),
    torch's default init from ``seed``."""
    import torch
    from sisr_tpu_torch.models.feature_extractors import VGG19Features
    torch.manual_seed(seed)
    torch.save(VGG19Features().state_dict(), path)
    return path


def write_face_weights(root, seed=9):
    """Seeded full-width face checkpoints in the reference layouts: LightCNN-29's
    ``{'state_dict': {'module.…'}}`` with its 79077-class fc2, and ``vgg_face_dag``'s
    names; {name: path}."""
    import torch
    from sisr_tpu_torch.models.feature_extractors import LightCNN29, VggFace
    torch.manual_seed(seed)
    light = {'module.' + k: v for k, v in LightCNN29(LIGHTCNN_CLASSES).state_dict().items()}
    paths = {'lightcnn': os.path.join(root, 'LightCNN_29Layers_checkpoint.pth.tar'),
             'vggface': os.path.join(root, 'vgg_face_dag.pth')}
    torch.save({'epoch': 0, 'arch': 'LightCNN-29', 'state_dict': light}, paths['lightcnn'])
    torch.save(VggFace().state_dict(), paths['vggface'])
    return paths


def write_perceptual_config(dirs, root, vgg_path):
    """configs/div2k/qrcan.toml's [model] at 5 x 10 with ``perceptual = 1.0`` and
    ``vgg_weights``, in f32, on the 16 pairs (LR crops of 64, HR 256^2), fused
    validation, tracked (``aim_track``, ``aim_home``) and cleaned every epoch
    (``model_cleanup_frequency = 1``): (config path, save location, aim_home)."""
    from sisr_tpu_torch.utils import toml_io
    save_loc = os.path.join(root, 'Results_perceptual')
    aim_home = os.path.join(root, 'tracking')
    data_set = {'lr': dirs['lr_dir'], 'hr': dirs['hr_dir'], 'degradation_metadata': 'on_site',
                'metadata': ['blur_kernel']}
    path = os.path.join(root, 'qrcan_perceptual.toml')
    toml_io.dump({
        'experiment': 'qrcan_perceptual', 'experiment_save_loc': save_loc,
        'data': {'batch_size': BATCH, 'dataloader_threads': 8,
                 'training_sets': {'data_1': {**data_set, 'crop': TRAIN_CROP,
                                              'random_augment': True}},
                 'eval_sets': {'data_1': data_set}},
        'model': {'name': 'qrcan', 'internal_params': {**QRCAN_PERCEPTUAL,
                                                       'vgg_weights': vgg_path}},
        'training': {'gpu': 'single', 'seed': 8, 'metrics': ['PSNR', 'SSIM'],
                     'logging': 'visual', 'fused_val': True, 'aim_track': True,
                     'aim_home': aim_home, 'model_cleanup_frequency': 1}}, path)
    return path, save_loc, aim_home


def train_batch_on(device, batch, lr=TRAIN_CROP, seed=6):
    """A seeded uint8 train batch of ``batch`` LR crops of ``lr``^2, their HR crops and
    10 blur-kernel values each, on ``device``."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    hr = lr * SCALE
    return {'lr': torch.from_numpy(rng.randint(0, 256, (batch, lr, lr, 3)).astype(np.uint8)
                                   ).to(device),
            'hr': torch.from_numpy(rng.randint(0, 256, (batch, hr, hr, 3)).astype(np.uint8)
                                   ).to(device),
            'metadata': torch.from_numpy(rng.dirichlet(np.ones(META_COLS) * 5, batch)
                                         .astype(np.float32)).to(device)}


def perceptual_step_breakdown(vgg_path, steps=10):
    """10 warm f32 train steps of Q-RCAN 5 x 10 (configs/div2k/qrcan.toml's model) with
    and without the perceptual term, in turns (without, with, with, without: 5 steps a
    turn), on one seeded batch of 8 LR crops of 64^2 (HR 256^2): each one's median step
    wall ms, device-busy ms (profiler, 3 steps), idle share, peak memory of a step (both
    handlers live throughout), and the 50 ca_onchip launches of a step; the VGG term
    alone (its forward on the SR and the HR and its backward to the SR, as a step runs
    it) in device ms and its share of the step's device time.  Returns the report and
    the handler without the term, with the batch (for the profiling tools)."""
    import torch
    from sisr_tpu_torch.models.feature_extractors import load_vgg_extractor
    from sisr_tpu_torch.models.handlers import define_model
    from sisr_tpu_torch.training.losses import l1_loss
    handlers = {label: define_model('qrcan', device='cuda', seed=8,
                                    **{**FULL_DEPTH, **QRCAN_TRAIN, **RECIPE_TRAIN_DEPTH,
                                       **extra})
                for label, extra in (('without', {}), ('with', {'perceptual': 1.0,
                                                                'vgg_weights': vgg_path}))}
    batch = train_batch_on('cuda', BATCH)
    for handler in handlers.values():
        handler.set_metadata_keys(['blur_kernel'] * META_COLS)
        for _ in range(3):
            handler.run_train(**batch)
    torch.cuda.synchronize()
    walls = {'without': [], 'with': []}
    for label in ('without', 'with', 'with', 'without'):
        walls[label] += timed_steps(handlers[label], batch, steps // 2)[0]
    report = {}
    for label, handler in handlers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        handler.run_train(**batch)
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, {**NO_LAUNCHES,
                                   'fused_channel_attention': RECIPE_CA_PER_FORWARD,
                                   'fused_channel_attention_onchip': RECIPE_CA_PER_FORWARD},
                        'Q-RCAN train step %s the perceptual term' % label)
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy_ms, _ = device_kernel_ms(lambda h=handler: h.run_train(**batch), reps=3)
        wall = statistics.median(walls[label])
        report[label] = {'median_step_wall_ms': wall, 'step_wall_ms': walls[label],
                         'device_busy_ms': busy_ms, 'device_idle_share':
                             (1 - busy_ms / wall) if busy_ms else None,
                         'step_peak_memory_gb': peak, 'launches_per_step': launches}
    vgg = load_vgg_extractor(vgg_path, device='cuda')
    h = handlers['with']
    lr, hr, meta = h._prep_batch({'lr': batch['lr'], 'hr': batch['hr'],
                                  'metadata': batch['metadata']})
    with torch.no_grad():
        sr = h.forward(lr, meta).float()
    sr.requires_grad_(True)

    def term():
        gen = vgg(sr)
        with torch.no_grad():
            real = vgg(hr)
        l1_loss(gen, real).backward()
    term_ms, per_kernel = device_kernel_ms(term, reps=3)
    with_, without = report['with'], report['without']
    report.update({
        'vgg_term_device_ms': term_ms,
        'vgg_term_share_of_step_device': term_ms / with_['device_busy_ms']
        if term_ms and with_['device_busy_ms'] else None,
        'vgg_term_top_kernels_ms': sorted(((k, v / 3) for k, v in per_kernel.items()),
                                          key=lambda kv: -kv[1])[:6],
        'with_over_without_wall': with_['median_step_wall_ms']
        / without['median_step_wall_ms'],
        'with_over_without_device_busy': with_['device_busy_ms'] / without['device_busy_ms']
        if with_['device_busy_ms'] and without['device_busy_ms'] else None,
        'peak_memory_delta_gb': with_['step_peak_memory_gb'] - without['step_peak_memory_gb'],
        'vgg_gflop_per_256_image': vgg_conv_flops(vgg, 256) / 1e9})
    del handlers['with']
    return report, handlers['without'], batch


def vgg_conv_flops(vgg, side):
    """Multiply-add FLOPs of the VGG trunk's convs on one side x side image."""
    import torch
    flops = 0
    for m in vgg.module.features:
        if isinstance(m, torch.nn.Conv2d):
            flops += 2 * side * side * m.out_channels * m.in_channels * 9
        elif isinstance(m, torch.nn.MaxPool2d):
            side //= 2
    return flops


def phase_perceptual_train(dirs, root, settle=None):
    """``train_sisr`` of configs/div2k/qrcan.toml's model and optimizer, Q-RCAN 5 x 10
    f32, with ``perceptual = 1.0`` on a seeded VGG19 trunk (write_vgg19_weights), on
    the 16 pairs at HR crops of 256^2, fused validation, tracked and cleaned every
    epoch: 2 epochs, then a resume for a third (finite losses, the checkpoints, the
    resumed one at step 6), every CA call on chip, 50 a forward.  Then the loss of 3
    steps on the card (TF32 off) against the CPU at 2 x 2 (batch 2, LR crops of 16),
    within rtol 2e-4, and perceptual_step_breakdown, after ``settle()`` (which ends the
    jobs that run beside this phase).  cuDNN TF32 on, matmul off (PyTorch's defaults)
    in the train runs and the timed steps."""
    import numpy as np
    import pandas as pd
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    vgg_path = write_vgg19_weights(os.path.join(root, 'vgg19_features.pth'))
    config, save_loc, aim_home = write_perceptual_config(dirs, root, vgg_path)
    n_train = N_IMAGES // BATCH
    per_epoch = RECIPE_CA_PER_FORWARD * (n_train + N_IMAGES + 1)  # train, val, samples
    report = {'tf32': {'cudnn': True, 'matmul': False}}
    total = dict(NO_LAUNCHES)
    with tf32(True, False):
        for label, args, epochs in (('first', ('--num_epochs', '2'), 2),
                                    ('resume', ('--num_epochs', '1',
                                                '--continue_from_epoch', '1'), 1)):
            launches, seconds = run_train_cli(config, *args)
            expect_launches(launches, {**NO_LAUNCHES,
                                       'fused_channel_attention': per_epoch * epochs,
                                       'fused_channel_attention_onchip': per_epoch * epochs},
                            'perceptual train_sisr (%s)' % label)
            report[label] = {'launches': launches, 'cli_seconds': seconds}
            total = {k: total[k] + launches[k] for k in total}
    base = os.path.join(save_loc, 'qrcan_perceptual')
    summary = pd.read_csv(os.path.join(base, 'result_outputs', 'summary.csv'))
    values = summary[['train-loss', 'val-loss', 'val-PSNR', 'val-SSIM']].to_numpy()
    saved = torch.load(os.path.join(base, 'saved_models', 'train_model_2'),
                       weights_only=True, map_location='cpu')
    if list(summary['epoch']) != [0, 1, 2] or not np.isfinite(values).all() \
            or saved['step'] != 3 * n_train:
        raise AssertionError('perceptual train_sisr: summary %s, checkpoint step %s'
                             % (summary.to_dict('list'), saved['step']))
    report['summary'] = summary.to_dict('list')

    # the loss of the first steps, card (TF32 off) against the CPU, at reduced depth
    losses = {}
    for device in ('cuda', 'cpu'):
        handler = define_model('qrcan', device=device, seed=8, **{
            **QRCAN_PERCEPTUAL, **PERCEPTUAL_CPU_DEPTH, 'vgg_weights': vgg_path})
        handler.set_metadata_keys(['blur_kernel'] * META_COLS)
        with tf32(False, False):
            losses[device] = [float(handler.run_train(**train_batch_on(device, 2, 16, seed))[0])
                              for seed in (21, 22, 23)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses['cuda'], losses['cpu']))
    report['card_vs_cpu'] = {'depth': PERCEPTUAL_CPU_DEPTH, 'batch': 2, 'lr_crop': 16,
                             'losses': losses, 'max_rel_diff': rel}
    if not rel <= 2e-4:
        raise AssertionError('perceptual loss card against CPU: %s' % losses)
    if settle is not None:
        settle()
    with tf32(True, False):
        steps, handler, batch = perceptual_step_breakdown(vgg_path)
    emit({'phase': 'perceptual_train', 'model': 'qrcan 5x10 64f 4x f32, standard + q_node, '
          '10 blur-kernel values, batch 8, LR crop 64, perceptual 1.0 on VGG19 to conv5_4',
          **report, 'steps': steps, 'nvidia_smi': nvidia_smi_line()})
    return {'launches': total, 'save_loc': save_loc, 'experiment': 'qrcan_perceptual',
            'aim_home': aim_home, 'handler': handler, 'batch': batch}


def read_images(folder, n):
    """The first ``n`` PNG images of ``folder`` as one (n, H, W, 3) float32 array."""
    import numpy as np
    from PIL import Image
    names = sorted(f for f in os.listdir(folder) if f.endswith('.png'))[:n]
    return np.stack([np.asarray(Image.open(os.path.join(folder, f)).convert('RGB'),
                                np.float32) / 255.0 for f in names])


def phase_face_sim_eval(dirs, root):
    """``eval_sisr`` on the standard protocol (batch 1, --time_models,
    --no_image_comparison) of Q-SPARNet as configs/celebahq/qsparnet.toml builds it
    (qsparnet_512, bf16) over the 16 pairs with ``-m PSNR -m SSIM -m FACE_SIM`` and
    ``--face_model lightcnn`` on a seeded full-width checkpoint in the reference layout
    (write_face_weights): sisr_tpu's columns, every FACE_SIM in [-1, 1], no CA launch.
    Then each extractor's embeddings (LightCNN29 and VggFace) of 4 HR images, card
    (TF32 off) against the CPU, within 1e-4 of the embedding's norm, and its ms a
    batch."""
    import numpy as np
    import torch
    from sisr_tpu_torch.models.feature_extractors import load_face_extractor
    weights = write_face_weights(root)
    experiment = 'qsparnet_512'
    shapes = lr_shapes(dirs['lr_dir'])
    columns = [('LR', 'runtime'), ('LR', 'PSNR'), ('LR', 'SSIM'), ('LR', 'FACE_SIM'),
               (experiment, 'runtime'), (experiment, 'PSNR'), (experiment, 'SSIM'),
               (experiment, 'FACE_SIM')]
    report, total = {}, dict(NO_LAUNCHES)
    x = torch.from_numpy(read_images(dirs['hr_dir'], 4))
    name = 'lightcnn'  # the CLI's run; both extractors are held card against CPU below
    launches, seconds, split, peak_gb, frame, _ = run_standard_cli(
        dirs, 'face_sim_' + name, experiment,
        ['-m', 'FACE_SIM', '--face_model', name, '--face_weights', weights[name],
         '--no_image_comparison'])
    expect_launches(launches, NO_LAUNCHES, 'FACE_SIM eval (%s)' % name)
    check_frame(frame, shapes, experiment, 'face_sim_' + name)
    sims = frame[[('LR', 'FACE_SIM'), (experiment, 'FACE_SIM')]].to_numpy()
    if list(frame.columns) != columns or not np.isfinite(sims).all() \
            or np.abs(sims).max() > 1 + 1e-6:
        raise AssertionError('FACE_SIM (%s): columns %s, values %s'
                             % (name, list(frame.columns), sims))
    report[name] = {'cli_seconds': seconds, 'img_per_s': N_IMAGES / split['protocol'],
                    'peak_memory_gb': peak_gb,
                    'mean_face_sim': {'LR': float(sims[:, 0].mean()),
                                      experiment: float(sims[:, 1].mean())},
                    'mean_psnr': float(frame[(experiment, 'PSNR')].mean())}
    total = {k: total[k] + launches[k] for k in total}
    for name, path in weights.items():
        card = load_face_extractor(name, path, device='cuda')
        cpu = load_face_extractor(name, path, device='cpu')
        with tf32(False, False), torch.inference_mode():
            e_card = card(x.cuda()).cpu()
            e_cpu = cpu(x)
            batch_ms = cuda_ms(lambda: card(x.cuda()), reps=3, rounds=3, warm=1)
        norms = e_cpu.norm(dim=1)
        rel = float(((e_card - e_cpu).abs().max(dim=1).values / norms).max())
        report.setdefault(name, {}).update({'embedding_dim': int(e_cpu.shape[1]),
                                            'embedding_max_rel_diff_card_vs_cpu': rel,
                                            'embedding_ms_per_batch_of_4_512': batch_ms})
        if not (norms > 0).all() or not rel <= 1e-4:
            raise AssertionError('%s embeddings card against CPU: %g of the norm (norms %s)'
                                 % (name, rel, norms.tolist()))
    emit({'phase': 'face_sim_eval', 'model': 'qsparnet in_size 512 '
          '(configs/celebahq/qsparnet.toml) bf16, 10 blur-kernel values', 'images': N_IMAGES,
          'columns': [list(c) for c in columns], **report, 'nvidia_smi': nvidia_smi_line()})
    return {'launches': total}


def eager_psnr(program, lr_dir, hr_dir, meta_rows=None):
    """Per-image Y PSNR of an eager serving ``program`` over the LR images of
    ``lr_dir`` in batches of BATCH (with their ``meta_rows``), by run_serving's own
    metric code: {name: PSNR}."""
    import numpy as np
    import torch
    from PIL import Image
    from sisr_tpu_torch.tools import run_serving
    names = sorted(f for f in os.listdir(lr_dir) if f.endswith('.png'))
    sr_images, results = {}, {}
    for start in range(0, len(names), BATCH):
        chunk = names[start:start + BATCH]
        x = np.stack([np.asarray(Image.open(os.path.join(lr_dir, n)).convert('RGB'),
                                 np.float32) / 255.0 for n in chunk])
        args = [torch.from_numpy(x).cuda()]
        if meta_rows is not None:
            args.append(torch.from_numpy(meta_rows[start:start + BATCH]).cuda())
        with torch.inference_mode():
            y = program(*args).float().cpu().numpy()
        for j, name in enumerate(chunk):
            sr_images[name] = np.clip(y[j], 0.0, 1.0)
            results[name] = {}
    run_serving._run_gt_metrics(sr_images, hr_dir, ['PSNR'], results, None)
    return {name: results[name]['PSNR'] for name in names}


def read_serving_csv(out_dir):
    import pandas as pd
    frame = pd.read_csv(os.path.join(out_dir, 'serving_metrics.csv'), index_col=0)
    return {name: float(v) for name, v in frame['PSNR'].items() if name != '[mean]'}


# the export phase's programs: label -> (experiment, int8); an int8 RCAN 10 x 20 program
# runs 415 int8 convs (head, 2 a block and one a group, body tail, 2 upsampler stages,
# tail), each one sisr::conv_int8_static node when exported
INT8_RCAN_CONVS = 1 + RCAN['n_resgroups'] * (2 * RCAN['n_resblocks'] + 1) + 1 + 2 + 1
SERVING_CASES = (('rcan_bf16', 'rcan_10x20', False),
                 ('rcan_int8', 'rcan_10x20', True),
                 ('qrcan_bf16', 'qrcan_5x20', False))


def start_exports(dirs, root):
    """``export_serving`` of each program of SERVING_CASES through its CLI, all at once,
    each in a process of its own (a rank job): {label: ((process, log file), artifact
    path)}."""
    from sisr_tpu_torch.tools import export_serving as es
    out = os.path.join(root, 'serving')
    os.makedirs(out)
    exports = {}
    for label, experiment, int8 in SERVING_CASES:
        path = os.path.join(out, label + es.FILE_SUFFIX)
        cli = ['--model_loc', dirs['model_loc'], '--experiment', experiment, '--epoch', '0',
               '--batch_size', str(BATCH), '--height', str(LR_SIZE), '--width',
               str(LR_SIZE), '--out', path]
        if int8:
            cli += ['--int8', '--calibration_images', dirs['lr_dir']]
        exports[label] = (start_rank_job('export', {'cli': cli}, root,
                                         name='export_' + label), path)
    return exports


def phase_export_serving(dirs, root, rcan_frame, exports):
    """``export_serving`` of rcan_10x20 in bf16 and ``--int8`` (calibrated on the LR
    images) and of Q-RCAN with its metadata (qrcan_5x20: the e2e configuration cut to
    5 x 20, its fused eval run here), at batch 8 x 128^2 on the card, the three
    ``exports`` of start_exports: each program's CA calls are the custom ops, one a
    block (in int8 also its 415 convs, one op each), as its manifest counts them.  Then
    the program loaded once and ``run_serving``'s
    ``serve_directory`` over the 16 LR images with a ground-truth folder: a launch a
    block and a forward on the planned route (ca_onchip in
    bf16, the CA + residual in rounds in int8), each image's PSNR within 0.01 dB of the
    fused eval's in bf16 and of an eager int8 forward on the same calibrated context in
    int8, whose mean is within 1 dB of bf16's; the largest difference of the served
    and the eager program's outputs.  Returns the function that times each served
    forward's ms a batch against the eager program's (CUDA events, in turns), emits the
    phase's line and returns its result, for the caller to call once the card is its
    alone (this part runs beside phase 17's ranks: its seconds include their load)."""
    import numpy as np
    import torch
    from sisr_tpu_torch.tools import export_serving as es, run_serving as rs
    out = os.path.join(root, 'serving')
    n_batches = -(-N_IMAGES // BATCH)
    report, total, timed = {}, dict(NO_LAUNCHES), {}
    fused = {'rcan_10x20': rcan_frame}
    launches, _, fused['qrcan_5x20'] = run_eval_cli(dirs, 'serving_qrcan_fused',
                                                    experiment='qrcan_5x20')
    total = {k: total[k] + launches[k] for k in total}
    finish_jobs([job for job, _ in exports.values()], time.monotonic())
    for label, experiment, int8 in SERVING_CASES:
        blocks = MODELS[experiment][1]['n_resgroups'] * MODELS[experiment][1]['n_resblocks']
        path = exports[label][1]
        export_s = rank_result(root, 'export_' + label, 0)['export_seconds']
        with open(path + '.json') as f:
            manifest = json.load(f)
        ops = manifest['custom_ops']['calls']
        expected_ops = {'sisr.ca_res.default': blocks,
                        'sisr.conv_int8_static.default': INT8_RCAN_CONVS} if int8 \
            else {'sisr.ca.default': blocks}
        if ops != expected_ops or manifest['platforms'] != ['cuda']:
            raise AssertionError('%s: custom ops %s, manifest %s' % (label, ops, manifest))
        sr_dir = os.path.join(out, label + '_sr')
        tic = time.perf_counter()
        program = es.load_exported(path)
        load_s = time.perf_counter() - tic
        reset_launches()
        tic = time.perf_counter()
        rs.serve_directory(path, dirs['lr_dir'], out_dir=sr_dir, gt_dir=dirs['hr_dir'],
                           device='cuda', program=program)
        serve_s = time.perf_counter() - tic
        launches = read_launches()
        calls = blocks * n_batches
        expected = int8_expected_launches(experiment, n_batches) if int8 else {
            **NO_LAUNCHES, 'fused_channel_attention': calls,
            'fused_channel_attention_onchip': calls}
        expect_launches(launches, expected, 'run_serving %s' % label)
        total = {k: total[k] + launches[k] for k in total}
        served = read_serving_csv(sr_dir)
        iface = es.load_for_export(dirs['model_loc'], experiment, 0, int8=int8,
                                   calibration_images=dirs['lr_dir'] if int8 else None)
        handler = iface.model
        eager = (es.Int8ServingProgram if int8 else es.ServingProgram)(handler).eval()
        meta_rows = None
        if handler.uses_metadata:
            names = sorted(f for f in os.listdir(dirs['lr_dir']) if f.endswith('.png'))
            meta_rows = rs._load_metadata(names, len(manifest['metadata_keys']),
                                          os.path.join(dirs['lr_dir'],
                                                       'degradation_metadata.csv'), manifest)
        if int8:
            reference = eager_psnr(eager, dirs['lr_dir'], dirs['hr_dir'], meta_rows)
        else:
            frame = fused[experiment]
            reference = {name: float(frame.loc[name, (experiment, 'PSNR')])
                         for name in served}
        diff = max(abs(served[n] - reference[n]) for n in served)
        x = torch.from_numpy(read_images(dirs['lr_dir'], BATCH)).cuda()
        call_args = (x,) if meta_rows is None else \
            (x, torch.from_numpy(meta_rows[:BATCH]).cuda())
        fn = program.module()
        with torch.inference_mode():
            out_diff = float((fn(*call_args) - eager(*call_args)).abs().max())
        timed[label] = (fn, eager, call_args)
        report[label] = {'experiment': experiment, 'export_seconds': export_s,
                         'load_seconds': load_s,
                         'artifact_mb': os.path.getsize(path) / 1e6, 'custom_ops': ops,
                         'serve_seconds': serve_s, 'launches': launches,
                         'mean_psnr': float(np.mean(list(served.values()))),
                         'max_psnr_diff_to_' + ('eager_int8' if int8 else 'fused_eval'): diff,
                         'max_abs_diff_served_vs_eager': out_diff}
        if not diff <= 0.01:
            raise AssertionError('run_serving %s: PSNR %g dB from its reference' % (label, diff))
    int8_gap = abs(report['rcan_int8']['mean_psnr'] - report['rcan_bf16']['mean_psnr'])
    report['rcan_int8']['mean_psnr_diff_to_bf16'] = int8_gap
    if not int8_gap < 1.0:
        raise AssertionError('served int8 RCAN %.4f dB from bf16' % int8_gap)

    def timings():
        for label, (fn, eager, call_args) in timed.items():
            times = {'served': [], 'eager': []}
            with torch.inference_mode():
                for turn, call in (('eager', eager), ('served', fn), ('served', fn),
                                   ('eager', eager)):  # in turns: the host's speed drifts
                    times[turn].append(cuda_ms(lambda: call(*call_args), reps=2, rounds=3,
                                               warm=1))
            served_ms, eager_ms = (statistics.median(times[k]) for k in ('served', 'eager'))
            report[label].update({'served_ms_per_batch': served_ms,
                                  'eager_ms_per_batch': eager_ms,
                                  'served_over_eager': served_ms / eager_ms})
        emit({'phase': 'export_serving', 'batch': BATCH, 'lr': LR_SIZE, **report,
              'nvidia_smi': nvidia_smi_line()})
        return {'launches': total}
    return timings


def write_reference_checkpoint(path):
    """A Q-RCAN checkpoint in the reference's whole save layout, named ``qpircan`` at
    epoch 5: ``network`` (the weights of the qrcan_10x20 experiment: seed 8),
    torch's own Adam ``optimizer`` state after one update (zero grads, so the weights
    stay) and a MultiStepLR ``scheduler_G`` state."""
    import torch
    from sisr_tpu_torch.models.handlers import define_model
    _, internal = MODELS['qrcan_10x20']
    handler = define_model('qrcan', device='cpu', seed=8, **internal)
    set_gammas(handler.module)
    params = list(handler.module.parameters())
    optimizer = torch.optim.Adam(params, lr=1e-4)
    for p in params:
        p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler = torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones=[100, 200])
    scheduler.step()
    torch.save({'network': handler.module.state_dict(), 'optimizer': optimizer.state_dict(),
                'scheduler_G': scheduler.state_dict(), 'model_name': 'qpircan',
                'model_epoch': 5}, path)
    return path


def phase_tools_path(dirs, root, perceptual, qrcan_frame):
    """The host tools on the card's machine, with no model forward beyond one eval:
    ``image_manipulate`` blur-downscale of the 16 HR images (seed 8, the unmodified
    kernels saved), its LR and its degradation_metadata.csv held against
    degrade_batch_on_device of the same HR images and kernels on the card (LR within
    one uint8 step, or two where a blurred value lies on a uint8 step; codes 1e-5);
    ``import_reference_model`` of a reference-layout Q-RCAN checkpoint
    (write_reference_checkpoint) and ``eval_sisr --fused_eval`` of the imported
    experiment, its PSNR the live model's (qrcan_10x20's fused run) within 1e-4 dB;
    ``model_report`` of the perceptual experiment; its tracker's JSONL records; and
    ``profiling.trace`` around one train step (a Chrome trace with kernel events) and
    ``device_timer`` around another against CUDA events recorded inside it."""
    import io
    import numpy as np
    import pandas as pd
    import torch
    from sisr_tpu_torch.ops.degradations import degrade_batch_on_device
    from sisr_tpu_torch.tools import data_converter, helper_cli, profiling
    from sisr_tpu_torch.tools.convert_weights import import_reference_experiment
    report = {}
    # image_manipulate on the host, against the card's degradation of the same inputs
    out = os.path.join(root, 'manipulated')
    tic = time.perf_counter()
    data_converter.manipulation_hub.main(args=[
        '--source_dir', dirs['hr_dir'], '--output_dir', out, '--pipeline', 'blur-downscale',
        '--seed', '8', '--scale', str(SCALE), '--save_original_kernel'], standalone_mode=False)
    seconds = time.perf_counter() - tic
    table = pd.read_csv(os.path.join(out, 'degradation_metadata.csv'), index_col=0)
    kernels = np.stack([json.loads(v) for v in table['unmodified_blur_kernel']])
    kernels = torch.from_numpy(kernels.reshape(-1, 21, 21).astype(np.float32)).cuda()
    codes = np.stack([json.loads(v) for v in table['blur_kernel']]).astype(np.float32)
    pca = torch.load(os.path.join(out, 'pca_matrix.pth'), weights_only=True).numpy()
    hr = torch.from_numpy(read_images(dirs['hr_dir'], N_IMAGES)).cuda()
    with tf32(False, False):
        lr_card, codes_card, blurred = (t.cpu() for t in degrade_batch_on_device(
            hr, kernels, pca, SCALE))
    lr_tool = torch.from_numpy(read_images(out, N_IMAGES))
    lr_steps = ((lr_card - lr_tool).abs() * 255).max().item()
    on_step = int(((blurred * 255 - torch.round(blurred * 255)).abs() < 1e-4).sum())
    code_err = float(np.abs(codes_card.numpy() - codes).max())
    report['image_manipulate'] = {
        'pipeline': 'blur-downscale', 'images': len(table), 'cli_seconds': seconds,
        'lr_shape': list(lr_tool.shape), 'lr_max_diff_uint8_steps': lr_steps,
        'lr_mean_diff_uint8_steps': float(((lr_card - lr_tool).abs() * 255).mean()),
        'blurred_values_on_a_uint8_step': on_step, 'codes_max_abs_err': code_err,
        'csv_columns': list(table.columns)}
    if not (lr_steps <= 1 + 1e-3 or (on_step and lr_steps <= 2 + 1e-3)) or code_err > 1e-5:
        raise AssertionError('image_manipulate against the card: %s'
                             % report['image_manipulate'])

    # the reference import, evaluated on the fused path
    ref_path = write_reference_checkpoint(os.path.join(root, 'qpircan_reference.pth'))
    import_loc = os.path.join(root, 'Results_imported')
    _, internal = MODELS['qrcan_10x20']
    import_reference_experiment(ref_path, import_loc, experiment='qrcan_imported',
                                scale=SCALE, **{k: v for k, v in internal.items()
                                                if k != 'scale'})
    launches, seconds, frame = run_eval_cli({**dirs, 'model_loc': import_loc},
                                            'imported_fused', experiment='qrcan_imported',
                                            epoch='5')
    n_batches = -(-N_IMAGES // BATCH)
    calls = CA_PER_FORWARD * n_batches
    expect_launches(launches, {**NO_LAUNCHES, 'fused_channel_attention': calls,
                               'fused_channel_attention_onchip': calls}, 'imported eval')
    diff = float((frame[('qrcan_imported', 'PSNR')]
                  - qrcan_frame[('qrcan_10x20', 'PSNR')]).abs().max())
    report['import_reference_model'] = {'cli_seconds': seconds, 'launches': launches,
                                        'max_psnr_diff_to_live_model': diff}
    if not diff <= 1e-4:
        raise AssertionError('imported Q-RCAN: PSNR %g dB from the live model' % diff)

    # model_report of the perceptual experiment, and its tracker's records
    base = os.path.join(perceptual['save_loc'], perceptual['experiment'])
    files, best, last = helper_cli.model_report(base)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        helper_cli.model_compare.main(args=['--main_dir', perceptual['save_loc']],
                                      standalone_mode=False)
    runs = sorted(os.listdir(os.path.join(perceptual['aim_home'], perceptual['experiment'])))
    records = [json.loads(line) for run in runs for line in open(os.path.join(
        perceptual['aim_home'], perceptual['experiment'], run))]
    metrics = [r for r in records if r['event'] == 'metric']
    report['model_report'] = {'checkpoints': sorted(files), 'best': best, 'last': last,
                              'output': text.getvalue().strip()}
    report['tracker'] = {'runs': runs, 'records': len(records),
                         'events': sorted({r['event'] for r in records}),
                         'metric_names': sorted({r['name'] for r in metrics}),
                         'epochs': sorted({r['epoch'] for r in metrics})}
    if last != 2 or 'train_model_2' not in files or len(runs) != 2 \
            or report['tracker']['epochs'] != [0, 1, 2] \
            or not all(isinstance(r['value'], (int, float)) and np.isfinite(r['value'])
                       for r in metrics):
        raise AssertionError('model_report / tracker: %s %s' % (report['model_report'],
                                                                report['tracker']))

    # profiling: a trace of one train step, and the device timer of another
    handler, batch = perceptual['handler'], perceptual['batch']
    trace_dir = os.path.join(root, 'trace')
    with profiling.trace(trace_dir, name='train_step') as prof:
        handler.run_train(**batch)
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    kernel_events = sum(1 for e in events if e.get('cat') == 'kernel')
    with profiling.device_timer() as holder:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        handler.run_train(**batch)
        stop.record()
    own_ms = start.elapsed_time(stop)
    timer_ms = holder['seconds'] * 1e3
    report['profiling'] = {'trace_file_mb': os.path.getsize(prof.trace_path) / 1e6,
                           'trace_kernel_events': kernel_events,
                           'device_timer_ms': timer_ms, 'cuda_events_ms': own_ms}
    emit({'phase': 'tools_path', **report, 'nvidia_smi': nvidia_smi_line()})
    if not kernel_events or not own_ms <= timer_ms <= own_ms * 1.05 + 0.5:
        raise AssertionError('profiling: %s' % report['profiling'])
    return {'launches': launches}


# --- multi-GPU data parallelism: ranks of one process group on the card -----------------
# Two ranks share the one card (gloo: NCCL refuses two ranks on one device), each a
# process of its own started through sisr_tpu's launcher contract (SISR_TPU_*); a third
# process runs the CLI with no launcher, which starts one rank a card itself (NCCL).
DDP_WORLD = 2
DDP_EXPERIMENT = 'qrcan_ddp'
# configs/div2k/qrcan.toml's model, 64 features, cut to 5 x 10 to fit the script's time;
# each rank's map in a train step is (BATCH / DDP_WORLD, 64, 64, 64) f32, in a bf16 fused
# eval (4, 128, 128, 64)
DDP_TRAIN = {**QRCAN_TRAIN, **RECIPE_TRAIN_DEPTH}
DDP_TRAIN_MAP = (BATCH // DDP_WORLD, TRAIN_CROP, TRAIN_CROP, 64)
DDP_EVAL_MAP = (BATCH // DDP_WORLD, LR_SIZE, LR_SIZE, 64)
RANK_TIMEOUT_S = 600  # the parent reaps every rank within this, or kills it and fails


def write_crop_workload(dirs, root):
    """The 16 pairs' centre crops, LR 64^2 (the recipe's LR crop: a crop then has no
    freedom, so each rank's own crop draws cannot move the trajectory) and HR 256^2, with
    the pairs' degradation_metadata.csv."""
    from PIL import Image
    crops = {'lr_dir': os.path.join(root, 'ddp_crops', 'lr'),
             'hr_dir': os.path.join(root, 'ddp_crops', 'hr')}
    off = (LR_SIZE - TRAIN_CROP) // 2
    for key, scale in (('lr_dir', 1), ('hr_dir', SCALE)):
        os.makedirs(crops[key])
        for name in sorted(n for n in os.listdir(dirs[key]) if n.endswith('.png')):
            with Image.open(os.path.join(dirs[key], name)) as im:
                im.crop((off * scale, off * scale, (off + TRAIN_CROP) * scale,
                         (off + TRAIN_CROP) * scale)).save(os.path.join(crops[key], name))
    shutil.copy(os.path.join(dirs['lr_dir'], 'degradation_metadata.csv'), crops['lr_dir'])
    return crops


def write_ddp_config(crops, save_loc):
    """configs/div2k/qrcan.toml's [model] at 5 x 10 and its batch of 8 on the crops
    (no flips: each rank would draw its own), fused validation over the 16 crops in
    batches of 8 (under the mesh each rank runs 4 of them)."""
    from sisr_tpu_torch.utils import toml_io
    data_set = {'lr': crops['lr_dir'], 'hr': crops['hr_dir'],
                'degradation_metadata': 'on_site', 'metadata': ['blur_kernel']}
    path = save_loc + '.toml'
    toml_io.dump({
        'experiment': DDP_EXPERIMENT, 'experiment_save_loc': save_loc,
        'data': {'batch_size': BATCH, 'eval_batch_size': BATCH, 'dataloader_threads': 4,
                 'training_sets': {'data_1': {**data_set, 'crop': TRAIN_CROP}},
                 'eval_sets': {'data_1': data_set}},
        'model': {'name': 'qrcan', 'internal_params': DDP_TRAIN},
        'training': {'seed': 8, 'metrics': ['PSNR', 'SSIM'], 'logging': 'visual',
                     'fused_val': True}}, path)
    return path


DDP_RUNS = (('first', ('--num_epochs', '2')),
            ('resume', ('--num_epochs', '1', '--continue_from_epoch', '1')))


def start_rank_job(job, args, root, rank=0, launcher=None, name=None):
    """``chip_smoke.py --rank-job job`` as a process of its own, the leader of a session
    of its own (its output in ``<root>/<name>_rank<rank>.log``, ``name`` by default the
    job's), with the launcher environment ``launcher`` (the SISR_TPU_* variables) or
    none: (process, log file)."""
    name = name or job
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SISR_TPU_') and k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK')}
    log = open(os.path.join(root, '%s_rank%d.log' % (name, rank)), 'w')
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--rank-job', job,
         json.dumps({**args, 'out': os.path.join(root, '%s_rank%%d.json' % name)})],
        stdout=log, stderr=subprocess.STDOUT, env={**env, **(launcher or {})},
        start_new_session=True)
    return proc, log


def reap(jobs):
    """Each job ((process, log file) pairs, each process the leader of a session of its
    own) killed with every process of its session, and waited for, if still running."""
    import signal
    for proc, log in jobs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()


@contextlib.contextmanager
def reaped(jobs):
    """The block's jobs, reaped (reap) when the block ends."""
    try:
        yield jobs
    finally:
        reap(jobs)


def finish_jobs(jobs, started):
    """Wait for every job ((process, log file) pairs) until RANK_TIMEOUT_S after
    ``started`` (time.monotonic) and return their logs; a job that fails, or outlives
    the deadline (reaped() kills it), fails the phase."""
    for proc, _ in jobs:
        proc.wait(timeout=max(1.0, started + RANK_TIMEOUT_S - time.monotonic()))
    texts = []
    for proc, log in jobs:
        log.flush()
        with open(log.name) as f:
            texts.append(f.read())
        if proc.returncode != 0:
            raise AssertionError('%s exited %s:\n%s' % (os.path.basename(log.name),
                                                        proc.returncode, texts[-1][-6000:]))
    return texts


def rank_result(root, job, rank):
    with open(os.path.join(root, '%s_rank%d.json' % (job, rank))) as f:
        return json.load(f)


def mesh_eval_cli(dirs, results_name, experiment, extra):
    """``eval_sisr --mesh`` on this rank, through the CLI entry point: the launch counts
    of exactly this run (set to 0 just before, read just after), its ca_onchip launches
    by map, its seconds."""
    from sisr_tpu_torch import net_eval
    args = ['--hr_dir', dirs['hr_dir'], '--lr_dir', dirs['lr_dir'], '-me', experiment, '0',
            '--model_loc', dirs['model_loc'], '--out_loc', dirs['out_loc'],
            '--results_name', results_name, '-m', 'PSNR', '-m', 'SSIM', '--scale',
            str(SCALE), '--full_directory', '--no_image_comparison', '--no-time_models',
            '--mesh', *extra]
    reset_launches()
    tic = time.perf_counter()
    net_eval.eval_run.main(args=args, standalone_mode=False)
    seconds = time.perf_counter() - tic
    return {'launches': read_launches(), 'onchip_by_map': read_onchip_shapes(),
            'seconds': seconds}


def step_profile(handler, batch, steps=5):
    """``steps`` timed train steps of ``handler`` on ``batch`` after 3 warm ones: the
    median wall ms and forward / backward / optimizer ms (timed_steps), and this
    process's device-busy ms of a step (profiler, 3 steps) with its idle share."""
    import torch
    for _ in range(3):
        handler.run_train(**batch)
    torch.cuda.synchronize()
    walls, phases = timed_steps(handler, batch, steps)
    busy_ms, _ = device_kernel_ms(lambda: handler.run_train(**batch), reps=3)
    wall = statistics.median(walls)
    return {'median_step_wall_ms': wall, 'step_wall_ms': walls,
            'median_forward_backward_optimizer_ms': [statistics.median(p[i] for p in phases)
                                                     for i in range(3)],
            'step_device_ms': busy_ms, 'idle_share': 1 - busy_ms / wall if busy_ms else None}


def ddp_train_handler(device):
    from sisr_tpu_torch.models.handlers import define_model
    handler = define_model('qrcan', device=device, seed=8, **DDP_TRAIN)
    handler.set_metadata_keys(['blur_kernel'] * META_COLS)
    return handler


def ddp_step_times(device, steps=5):
    """step_profile of DDP_TRAIN's model on this rank's half of a seeded batch of 8 LR
    crops of 64^2, through DistributedDataParallel (the gradient all-reduce inside the
    backward), and the ms of one all-reduce of a flat f32 tensor of the model's
    parameter count, as the backward's buckets add up to."""
    import torch
    from sisr_tpu_torch.parallel import MeshContext
    handler = ddp_train_handler(device)
    mesh = MeshContext()
    handler.set_mesh(mesh)
    report = {'rank_batch': BATCH // mesh.n_devices,
              **step_profile(handler, mesh.shard_batch(train_batch_on(device, BATCH)),
                             steps)}
    flat = torch.zeros(handler.print_parameters(), device=device)
    torch.distributed.all_reduce(flat)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(steps):
        torch.distributed.all_reduce(flat)
    torch.cuda.synchronize()
    return {**report, 'gradient_all_reduce_ms': (time.perf_counter() - tic) * 1e3 / steps,
            'parameters': handler.print_parameters()}


def wait_for_file(path, timeout, jobs=()):
    """Wait until ``path`` exists; fail after ``timeout`` seconds, or as soon as one of
    ``jobs`` ((process, log file) pairs) has exited."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError('%s did not appear within %d s' % (path, timeout))
        for proc, log in jobs:
            if proc.poll() is not None:
                log.flush()
                with open(log.name) as f:
                    raise AssertionError('%s exited %s before %s:\n%s'
                                         % (os.path.basename(log.name), proc.returncode,
                                            os.path.basename(path), f.read()[-6000:]))
        time.sleep(0.2)


def rank_job(job, args):
    """A process of the multi-GPU phases (started by start_rank_job), which writes its
    result JSON to ``args['out'] % rank``:

    * ``ddp``, one rank of a launcher's group (TF32 off for matmuls and cuDNN):
      ``train_sisr --gpu multi`` on the crops, 2 epochs then a resume, each run's
      launches, ca_onchip launches by map and items this process decoded; ``eval_sisr
      --fused_eval --mesh`` of RCAN 10 x 20 in bf16 and with ``--int8``, and Q-SAN's
      standard protocol on its tile grid with ``--mesh``, with the tile batch sizes
      this rank ran; then (rank 0 writes ``args['ready']``) once the parent has written
      ``args['go']`` (every other job on the card ended), ddp_step_times;
    * ``nccl``, no launcher environment: ``train_sisr --gpu multi`` for 1 epoch, so the
      CLI starts a rank for each card itself (PyTorch's TF32 defaults there);
    * ``export``: ``export_serving`` with the arguments ``args['cli']`` (TF32 off),
      and its seconds;
    * ``bench_tools``: phase_bench_tools in the folder ``args['root']`` (TF32 off)."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from sisr_tpu_torch.data import loader
    from sisr_tpu_torch.parallel import distributed
    result = {'job': job}
    if job == 'bench_tools':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.makedirs(args['root'])
        result.update(phase_bench_tools(args['root']))
        with open(args['out'] % 0, 'w') as f:
            json.dump(result, f)
        return 0
    if job in ('nccl', 'export'):
        if job == 'nccl':
            _, result['cli_seconds'] = run_train_cli(args['config'], '--gpu', 'multi',
                                                     '--num_epochs', '1')
        else:
            from sisr_tpu_torch.tools import export_serving as es
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            tic = time.perf_counter()
            es.export_serving_cli.main(args=args['cli'], standalone_mode=False)
            result['export_seconds'] = time.perf_counter() - tic
        with open(args['out'] % 0, 'w') as f:
            json.dump(result, f)
        return 0
    if job != 'ddp':
        raise ValueError('unknown rank job %r' % job)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_init_distributed()
    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    result.update({'rank': distributed.rank(), 'world': distributed.world_size(),
                   'backend': torch.distributed.get_backend(), 'device': index,
                   'sm_count': props.multi_processor_count,
                   'smem_optin': props.shared_memory_per_block_optin,
                   'train_plan': planned_ca_route(DDP_TRAIN_MAP, 4, 4, device=index)[0],
                   'eval_plan': planned_ca_route(DDP_EVAL_MAP, 4, 2, device=index)[0],
                   'int8_plan': planned_res_route(DDP_EVAL_MAP, 4, 4, 2, device=index)[0]})
    for label, extra in DDP_RUNS:
        items = loader.ITEMS_LOADED
        launches, seconds = run_train_cli(args['config'], '--gpu', 'multi', *extra)
        result[label] = {'launches': launches, 'onchip_by_map': read_onchip_shapes(),
                         'cli_seconds': seconds, 'items_loaded': loader.ITEMS_LOADED - items}
    dirs = args['dirs']
    result['eval_bf16'] = mesh_eval_cli(dirs, 'mesh_bf16', 'rcan_10x20',
                                        ['--fused_eval', '--batch_size', str(BATCH)])
    result['eval_int8'] = mesh_eval_cli(dirs, 'mesh_int8', 'rcan_10x20',
                                        ['--fused_eval', '--batch_size', str(BATCH), '--int8'])
    with tile_steps() as steps:
        result['tiles'] = mesh_eval_cli(dirs, 'mesh_qsan_grid', 'qsan_grid',
                                        ['--batch_size', '1'])
    result['tiles']['tile_batches'] = steps
    # the step timings, with the card the ranks' alone: rank 0 says both are ready,
    # and the parent says go once every other job on the card has ended
    distributed.barrier()
    if distributed.rank() == 0:
        with open(args['ready'], 'w'):
            pass
    wait_for_file(args['go'], RANK_TIMEOUT_S)
    distributed.barrier()
    result['steps'] = ddp_step_times(torch.device('cuda', index))
    with open(args['out'] % distributed.rank(), 'w') as f:
        json.dump(result, f)
    distributed.barrier()
    return 0


def summary_of(save_loc):
    import pandas as pd
    return pd.read_csv(os.path.join(save_loc, DDP_EXPERIMENT, 'result_outputs',
                                    'summary.csv'))


def max_rel(ours, theirs):
    import numpy as np
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.max(np.abs(ours - theirs) / np.abs(theirs)))


def final_weights_diff(save_loc, ref_loc, epoch):
    import torch
    a, b = (torch.load(os.path.join(loc, DDP_EXPERIMENT, 'saved_models',
                                    'train_model_%d' % epoch),
                       weights_only=True, map_location='cpu')['network']
            for loc in (save_loc, ref_loc))
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


def half_batches(batch):
    """A fused-protocol batch cut as the 2-rank mesh cuts it: each rank's contiguous
    half of every per-image entry."""
    n = len(batch['lr'])
    per = n // DDP_WORLD
    return [{k: v[r * per:(r + 1) * per] if not k.startswith('_') and hasattr(v, '__len__')
             and not isinstance(v, str) and len(v) == n else v for k, v in batch.items()}
            for r in range(DDP_WORLD)]


def split_equal(fn, *args):
    """``fn`` on a batch against ``fn`` on its two halves, concatenated: bit equal, and
    the largest |difference|."""
    import torch
    half = len(args[0]) // 2
    with torch.inference_mode():
        whole = fn(*args)
        parts = torch.cat([fn(*(a[r * half:(r + 1) * half] for a in args))
                           for r in range(2)])
    return {'bit_equal': bool(torch.equal(whole, parts)),
            'max_abs_diff': float((whole.float() - parts.float()).abs().max())}


def int8_at_rank_batch(dirs):
    """The one-process int8 fused eval of rcan_10x20 with each batch of 8 run as its
    two halves of 4 (each rank's slice under the 2-rank mesh), calibrated on the whole
    first batch as one process and the mesh are: its per-image frame; and where a batch
    of 8 and its halves part (split_equal): the calibrated int8 program's SR of one
    seeded batch, its head's static int8 conv, the CA + residual kernel on seeded maps
    (8, 128, 128, 64) with the first block's weights, the device bicubic and the
    PSNR and SSIM of the fused step."""
    import torch
    from sisr_tpu_torch.ops.channel_attention import fused_channel_attention_residual
    from sisr_tpu_torch.ops.metrics import psnr_nhw, ssim_nhw
    from sisr_tpu_torch.ops.quantization import conv_int8_static
    from sisr_tpu_torch.ops.resize import resize_bicubic
    hub = eval_hub(dirs, 'rcan_10x20', 'int8_rank_batch', True, True, BATCH)
    handler = hub.model_bundles[0].model
    whole = handler.run_eval_fused

    def halves(batch, **kwargs):
        if handler._int8_ctx is None:
            whole(batch, **kwargs)  # calibrate on the whole first batch
        parts = [whole(half, **kwargs) for half in half_batches(batch)]
        return (parts[0][0][0], torch.cat([p[0][1] for p in parts], dim=1)), parts[0][1]

    handler.run_eval_fused = halves
    hub.full_image_protocol()
    frame = hub_frame(dirs, 'int8_rank_batch')
    program, qparams, scales = handler._int8_ctx
    _, x, meta = breakdown_batch(handler)
    head, ca = qparams['head'], qparams['group_0']['rcab_0']['ca']
    gen = torch.Generator(device='cuda').manual_seed(3)
    y = torch.randn((BATCH, LR_SIZE, LR_SIZE, 64), device='cuda', generator=gen)
    r = torch.randn(y.shape, device='cuda', generator=gen).to(torch.bfloat16)
    sr = torch.rand((BATCH, LR_SIZE * SCALE, LR_SIZE * SCALE), device='cuda',
                    generator=gen)
    hr = torch.rand(sr.shape, device='cuda', generator=gen)
    report = {
        'program_sr': split_equal(lambda v: program(v, meta), x),
        'head_conv_int8_static': split_equal(
            lambda v: conv_int8_static(v, head['kernel'], head['scale'], scales['head'],
                                       head['bias'], head.get('matrix')), x),
        'ca_residual_kernel': split_equal(
            lambda a, b: fused_channel_attention_residual(
                a, b, ca['du_0']['kernel'], ca['du_0']['bias'], ca['du_1']['kernel'],
                ca['du_1']['bias']), y, r),
        'device_bicubic': split_equal(lambda v: resize_bicubic(v, LR_SIZE * SCALE,
                                                                 LR_SIZE * SCALE), x),
        'psnr': split_equal(lambda a, b: psnr_nhw(a, b, 1.0), sr, hr),
        'ssim': split_equal(lambda a, b: ssim_nhw(a, b, 1.0), sr, hr)}
    return frame, report


def qsan_tile_batch_dependence(dirs):
    """Q-SAN's (qsan_grid) bf16 forward on 4 tiles of 94^2 (the 2 x 2 grid's 84^2 tiles
    with their halo) of one seeded batch at once, as one process runs a forward's
    tiles, against 2 and 2, as each rank of the mesh runs them (split_equal)."""
    hub = eval_hub(dirs, 'qsan_grid', 'qsan_tile_probe', False, False, 1)
    handler = hub.model_bundles[0].model
    _, x, meta = breakdown_batch(handler)
    side = 94
    tiles = x[:4, :side, :side].contiguous()
    return split_equal(lambda v, m: handler.forward(v, m), tiles, meta[:4])


def frame_equal_f32(ours, theirs):
    """Every per-image metric of ``ours`` equal to ``theirs`` in float32 (each CSV holds
    the shortest text that reads back as its float32 value), and the images where not."""
    import numpy as np
    a = ours.loc[theirs.index, theirs.columns].to_numpy(np.float32)
    b = theirs.to_numpy(np.float32)
    rows = sorted(set(theirs.index[np.nonzero((a != b).any(axis=1))[0]]))
    return not rows, rows


def phase_multi_gpu(dirs, root, rcan_frames, qsan_grid_frame, meanwhile=None):
    """The multi-GPU paths (phase 17), two ranks sharing the card over gloo:

    * ``multi_gpu_train``: ``train_sisr --gpu multi`` of configs/div2k/qrcan.toml's
      model (cut to 5 x 10, 64 features, f32, TF32 off) on the 16 pairs' crops,
      global batch 8, 2 epochs and a resume, against the same run in one process (this
      one, ``--gpu single``): every epoch's losses within rtol 2e-4, the final weights
      within 5e-4 (the f32 card-vs-CPU bar); one summary.csv row and one checkpoint an
      epoch (rank 0's); each rank decoded 4 of each 8 training crops and the 16
      validation crops; each rank's ca_onchip launches on the route planned on its own
      card for its map (4, 64, 64, 64) f32, 50 a forward of a train step or of its
      half of a validation batch of 8.  Then, with the card the ranks' alone, each
      rank's DDP step (its 4 crops) and gradient all-reduce, beside one process's step
      on the 8 (both TF32 off), each with its device-busy ms and idle share;
    * ``multi_gpu_nccl``: the same command, 1 epoch, with no launcher environment: the
      CLI starts one rank for the one card, over NCCL, with PyTorch's TF32 defaults; its
      losses against ``--gpu single`` under the same flags within rtol 2e-4;
    * ``mesh_eval``: ``eval_sisr --fused_eval --mesh`` of RCAN 10 x 20 in bf16 and
      ``--int8``: each pair's PSNR within 0.01 dB and SSIM within 1e-3 of the
      one-process runs of the main paths (batches of 8); int8 equal in float32, image
      by image, to one process that runs each batch as the ranks' halves of 4
      (int8_at_rank_batch, which also shows what differs between a batch of 8 and its
      halves); each rank 200 launches a forward of row 1a (bf16) or 2a (int8) on the
      route planned for (4, 128, 128, 64);
    * ``mesh_tiles``: Q-SAN's standard protocol (10 x 5, max_combined_im_size 10000:
      a 2 x 2 grid on the 128^2 maps) with ``--mesh``: each rank 2 of the 4 tiles a
      forward, each pair's metrics within 0.01 dB / 1e-3 of the one-process run; the
      forward on 4 tiles against 2 and 2 (qsan_tile_batch_dependence).

    The ranks and the launcher-free CLI start at once, while this process runs the
    one-process references and then ``meanwhile()`` (the serving checks): their seconds
    include that load.  The step timings and everything after them wait until every
    other job on the card has ended.
    """
    import socket
    crops = write_crop_workload(dirs, root)
    two, one = os.path.join(root, 'ddp_two'), os.path.join(root, 'ddp_one')
    nccl, nccl_ref = os.path.join(root, 'ddp_nccl'), os.path.join(root, 'ddp_nccl_ref')
    configs = {loc: write_ddp_config(crops, loc) for loc in (two, one, nccl, nccl_ref)}
    ready, go = os.path.join(root, 'ddp_steps.ready'), os.path.join(root, 'ddp_steps.go')
    n_train = N_IMAGES // BATCH
    report = {'world': DDP_WORLD, 'model': 'qrcan 5x10 64f 4x f32 (configs/div2k/'
              'qrcan.toml cut to a quarter of its blocks), batch 8, LR crops 64^2 of the '
              '16 pairs'}
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    started = time.monotonic()
    jobs = [start_rank_job('ddp', {'config': configs[two], 'dirs': dirs, 'ready': ready,
                                   'go': go}, root,
                           rank, {'SISR_TPU_COORDINATOR': 'localhost:%d' % port,
                                  'SISR_TPU_NUM_PROCESSES': str(DDP_WORLD),
                                  'SISR_TPU_PROCESS_ID': str(rank), 'LOCAL_RANK': '0'})
            for rank in range(DDP_WORLD)]
    jobs.append(start_rank_job('nccl', {'config': configs[nccl]}, root))
    with reaped(jobs):
        with tf32(False, False):
            one_process = {label: run_train_cli(configs[one], '--gpu', 'single', *extra)
                           for label, extra in DDP_RUNS}
        with tf32(True, False):  # PyTorch's defaults, as the spawned rank has them
            _, ref_seconds = run_train_cli(configs[nccl_ref], '--gpu', 'single',
                                           '--num_epochs', '1')
        if meanwhile is not None:
            meanwhile()
        finish_jobs(jobs[-1:], started)
        wait_for_file(ready, max(1.0, started + RANK_TIMEOUT_S - time.monotonic()),
                      jobs[:DDP_WORLD])
        with tf32(False, False):  # the ranks' flags; they wait meanwhile
            one_step = step_profile(ddp_train_handler('cuda'),
                                    train_batch_on('cuda', BATCH))
        with open(go, 'w'):
            pass
        logs = finish_jobs(jobs, started)
    report['one_process_cli_seconds'] = {k: v[1] for k, v in one_process.items()}
    report['all_jobs_seconds'] = time.monotonic() - started
    ranks = [rank_result(root, 'ddp', rank) for rank in range(DDP_WORLD)]
    rank_fields = ('rank', 'world', 'backend', 'device', 'sm_count', 'smem_optin',
                   'train_plan', 'eval_plan', 'int8_plan')
    report['ranks'] = [{k: r[k] for k in rank_fields} for r in ranks]
    if [r['rank'] for r in ranks] != [0, 1] or {r['backend'] for r in ranks} != {'gloo'}:
        raise AssertionError('multi_gpu ranks %s' % report['ranks'])

    # multi_gpu_train: one process's trajectory, rank 0's files, each rank's slices
    ours, theirs = summary_of(two), summary_of(one)
    if list(ours['epoch']) != [0, 1, 2] or list(theirs['epoch']) != [0, 1, 2]:
        raise AssertionError('summary.csv epochs %s / %s' % (list(ours['epoch']),
                                                             list(theirs['epoch'])))
    rel = {col: max_rel(ours[col], theirs[col]) for col in ('train-loss', 'val-loss')}
    weights = final_weights_diff(two, one, 2)
    models = sorted(os.listdir(os.path.join(two, DDP_EXPERIMENT, 'saved_models')))
    if max(rel.values()) > 2e-4 or not weights <= 5e-4 \
            or models != ['train_model_%d' % e for e in range(3)]:
        raise AssertionError('multi_gpu_train: losses %s, weights %g, checkpoints %s'
                             % (rel, weights, models))
    key = '%s float32' % 'x'.join(map(str, DDP_TRAIN_MAP))
    train = {}
    for r in ranks:
        for label, (_, extra) in zip(('first', 'resume'), DDP_RUNS):
            epochs = int(extra[1])
            got = r[label]
            # each epoch: 4 of each batch of 8 crops, and the 16 validation crops whole
            if got['items_loaded'] != epochs * (N_IMAGES // DDP_WORLD + N_IMAGES):
                raise AssertionError('rank %d %s decoded %d items' % (r['rank'], label,
                                                                       got['items_loaded']))
            # the train steps' forwards and the validation's (its batches of 8 split)
            expected = RECIPE_CA_PER_FORWARD * (n_train + N_IMAGES // BATCH) * epochs
            if r['train_plan'] != 'onchip' or got['onchip_by_map'].get(key) != expected:
                raise AssertionError('rank %d %s: %s launches at %s (plan %s), expected %d'
                                     % (r['rank'], label, got['onchip_by_map'], key,
                                        r['train_plan'], expected))
            train['rank%d_%s' % (r['rank'], label)] = got
    steps = {'ranks': [r['steps'] for r in ranks], 'one_process': one_step,
             # the card's busy share while both ranks step: their device ms over the
             # slower rank's wall
             'two_rank_card_idle_share':
                 1 - sum(r['steps']['step_device_ms'] for r in ranks)
                 / max(r['steps']['median_step_wall_ms'] for r in ranks)
                 if all(r['steps']['step_device_ms'] for r in ranks) else None}
    emit({'phase': 'multi_gpu_train', **report, 'max_rel_loss_diff': rel,
          'max_abs_weight_diff': weights, 'steps': steps, 'summary': ours.to_dict('list'),
          'one_process_summary': theirs.to_dict('list'), 'runs': train,
          'nvidia_smi': nvidia_smi_line()})

    # multi_gpu_nccl: the CLI with no launcher environment started a rank for the card
    # itself (NCCL); its output is in the job's log
    if 'backend nccl (a card per rank)' not in logs[-1]:
        raise AssertionError('multi_gpu_nccl: no NCCL group in\n%s' % logs[-1][-4000:])
    nccl_seconds = rank_result(root, 'nccl', 0)['cli_seconds']
    ours, theirs = summary_of(nccl), summary_of(nccl_ref)
    rel_nccl = {col: max_rel(ours[col], theirs[col]) for col in ('train-loss', 'val-loss')}
    if max(rel_nccl.values()) > 2e-4 or list(ours['epoch']) != [0]:
        raise AssertionError('multi_gpu_nccl: losses %s' % rel_nccl)
    emit({'phase': 'multi_gpu_nccl', 'cards': 1, 'seconds': nccl_seconds,
          'single_cli_seconds': ref_seconds, 'max_rel_loss_diff': rel_nccl,
          'summary': ours.to_dict('list'), 'nvidia_smi': nvidia_smi_line()})

    # mesh_eval: the main paths' fused evals over the ranks
    eval_report = {}
    for tag, route_key, counter in (('bf16', 'eval_plan', 'fused_channel_attention'),
                                    ('int8', 'int8_plan',
                                     'fused_channel_attention_residual')):
        frame = hub_frame(dirs, 'mesh_' + tag)
        sides = (('rcan_10x20', 'rcan_10x20'), ('LR', 'LR'))
        diff = max_metric_diff(frame, rcan_frames[tag], sides)
        hold_bars(diff, 'mesh eval %s against one process' % tag)
        eval_report[tag] = {'max_diff_to_one_process': diff}
        if tag == 'int8':
            # the int32 sums are exact, and each rank runs one process's program on its
            # half: the same half in one process gives the same metrics
            halves_frame, batch_dependence = int8_at_rank_batch(dirs)
            equal, rows = frame_equal_f32(frame, halves_frame)
            if not equal:
                raise AssertionError('mesh int8 eval differs from one process at the '
                                     'ranks\' batch of 4 on %s' % rows)
            eval_report[tag].update({
                'equal_to_one_process_at_rank_batch': equal,
                'max_diff_one_process_batch4_to_batch8': max_metric_diff(
                    halves_frame, rcan_frames[tag], sides),
                'batch8_against_halves': batch_dependence})
        per_rank = []
        for r in ranks:
            got = r['eval_' + tag]
            expected = CA_PER_FORWARD * (N_IMAGES // BATCH)  # 2 forwards of 4 images
            routes = {route: got['launches'].get(counter + '_' + route, 0)
                      for route in ('onchip', 'rounds', 'stream')}
            routes['three_pass'] = got['launches'][counter] - sum(routes.values())
            if got['launches'][counter] != expected or routes[r[route_key]] != expected:
                raise AssertionError('mesh %s rank %d: launches %s (plan %s), expected %d'
                                     % (tag, r['rank'], got['launches'], r[route_key],
                                        expected))
            per_rank.append(got)
        eval_report[tag].update({'ranks': per_rank,
                                 'mean_psnr': float(frame[('rcan_10x20', 'PSNR')].mean())})
    emit({'phase': 'mesh_eval', **eval_report, 'nvidia_smi': nvidia_smi_line()})

    # mesh_tiles: Q-SAN's tile grid shared out over the ranks
    frame = hub_frame(dirs, 'mesh_qsan_grid')
    check_frame(frame, lr_shapes(dirs['lr_dir']), 'qsan_grid', 'mesh_qsan_grid')
    diff = max_metric_diff(frame, qsan_grid_frame, (('qsan_grid', 'qsan_grid'),
                                                    ('LR', 'LR')))
    hold_bars(diff, 'mesh tile grid against one process')
    for r in ranks:
        expect_launches(r['tiles']['launches'], NO_LAUNCHES, 'mesh_qsan_grid')
        if r['tiles']['tile_batches'] != {str(4 // DDP_WORLD): N_IMAGES}:
            raise AssertionError('mesh tiles rank %d: tile batches %s'
                                 % (r['rank'], r['tiles']['tile_batches']))
    emit({'phase': 'mesh_tiles', 'max_diff_to_one_process': diff,
          'tiles_4_against_2_and_2': qsan_tile_batch_dependence(dirs),
          'tile_batches_per_rank': ranks[0]['tiles']['tile_batches'],
          'seconds': [r['tiles']['seconds'] for r in ranks], 'nvidia_smi': nvidia_smi_line()})

    def summed(*runs):
        return {k: sum(run[k] for run in runs) for k in NO_LAUNCHES}
    return {'multi_gpu_train': {'launches': summed(*(r[label]['launches'] for r in ranks
                                                     for label in ('first', 'resume')))},
            'mesh_eval_bf16': {'launches': summed(*(r['eval_bf16']['launches']
                                                    for r in ranks))},
            'mesh_eval_int8': {'launches': summed(*(r['eval_int8']['launches']
                                                    for r in ranks))}}


# --- the benchmark tools (sisr_tpu_torch/tools) ----------------------------------------------
FLOP_CASES = (('edsr_64f_16b', 'edsr', {}, None, {}),
              ('edsr_256f_32b', 'edsr', {'num_features': 256, 'num_blocks': 32}, None,
               {'feats': 256, 'blocks': 32}),
              ('rcan_10x20', 'rcan', {}, None, {}),
              ('qrcan_modulate_1', 'qrcan', {'style': 'modulate', 'include_q_layer': True},
               1, {}))
NO_CA_CONFIGS = ('edsr', 'edsr_int8', 'san', 'srcnn', 'sparnet')
SOAK_ARGS = ('--steps', '32', '--images', '64', '--batch', '8')


@contextlib.contextmanager
def module_values(module, **values):
    """Module attributes set for a block (a tool's passes and sizes), restored after."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def phase_bench_tools(root):
    """Each benchmark tool's entry once on the card at full width with few passes,
    held to its checks: flops.py's counts within 0.1% of the port's own modules' conv
    FLOPs (count_conv_flops at 128^2); every E2E_CONFIGS key through run_config (16
    images, batch 8, one timed pass: finite per-image PSNR, edsr_int8 within 1 dB of
    edsr, qrcan's 200 ca_onchip launches a forward, san on its tile grid, no CA on
    edsr, edsr_int8, san, srcnn, sparnet); the family table and --paper (no FAILED
    row, every MFU in (0, 100%], the int8 RCAN row's 200 CA + residual launches a
    forward on its planned route); --train and --val (one timed epoch each, on 32 and
    16 images); every bench_quantization section (batch 8); bench_ca_epilogue (each
    standalone shape on its planned route, 1e-5 abs with the f32 carry, 2 bf16 ULPs
    with the bf16 one; the raw int8 RCAN outputs of both epilogues at least min(40 dB, the rounding
    witnesses' PSNRs) apart); bench_bucketed (its shape counts); bench_decode_cache
    --passes 1 (the sidecar arm's per-image PSNR equal to the png arm's, each CSV read
    as the tool writes it); train_soak at 256f/32b for 32 steps into a temporary
    --out (finite steps, img/s and dB over bicubic).  The launches of
    bench_ca_epilogue (a kernel against its plain version) are kept apart.  Runs as
    the rank job ``bench_tools`` (its own process, beside the recipes' runs): returns
    {'line': the phase's figures, 'launches': the phase's launches}."""
    import numpy as np
    import pandas as pd
    import torch
    from sisr_tpu_torch.tools import (bench_bucketed, bench_ca_epilogue, bench_decode_cache,
                                      bench_models, bench_quantization, e2e_bench, flops,
                                      train_soak)
    tic = time.perf_counter()
    total = dict(NO_LAUNCHES)
    seconds = {}

    def run(name, fn, count=True):
        """(fn(), the launch counts of read_launches made during the call), its
        seconds added to ``seconds[name]`` and, with ``count``, its launches to the
        phase's."""
        before, started = read_launches(), time.perf_counter()
        result = fn()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - started
        delta = {k: v - before[k] for k, v in read_launches().items()}
        if count:
            for k, v in delta.items():
                total[k] += v
        return result, delta

    # analytic FLOPs against the forward hooks' count of the port's modules
    flop_counts = {}
    for name, model, internal, meta_cols, kwargs in FLOP_CASES:
        with module_values(bench_models, BATCH=1):
            handler = bench_models.family_forward(model, {'scale': SCALE, **internal},
                                                  LR_SIZE, meta_cols, 'cuda')[0]
        x = torch.rand(1, LR_SIZE, LR_SIZE, 3, device='cuda')
        meta = None if meta_cols is None else torch.zeros(1, meta_cols, device='cuda')
        inp, _, meta = handler._prep_batch({'lr': x, 'metadata': meta})
        hooks = count_conv_flops(handler, inp, meta)
        analytic = getattr(flops, '%s_flops_per_image' % model)(lr=LR_SIZE, **kwargs)
        rel = abs(analytic - hooks) / hooks
        flop_counts[name] = {'analytic': analytic, 'hooks': hooks, 'rel_diff': rel}
        if rel > 1e-3:
            raise AssertionError('flops.py %s: %.6g against %.6g counted (%.2e)'
                                 % (name, analytic, hooks, rel))
        del handler

    def csv_of(out_dir):
        return pd.read_csv(os.path.join(out_dir, 'standard_metrics',
                                        'individual_metrics.csv'), header=[0, 1], index_col=0)

    # every e2e config through run_config: one warm-up and one timed pass of 16 images,
    # each per-image CSV read as measure_e2e returns (run_config then removes it)
    e2e, forwards, frames = {}, 2 * -(-N_IMAGES // BATCH), []
    measure_e2e = e2e_bench.measure_e2e

    def measure_and_read(lr_dir, hr_dir, model_loc, out_root, *args, **kwargs):
        rate = measure_e2e(lr_dir, hr_dir, model_loc, out_root, *args, **kwargs)
        frames.append(csv_of(os.path.join(out_root, 'bench_eval')))
        return rate
    saved_passes = os.environ.get('BENCH_PASSES')
    os.environ['BENCH_PASSES'] = '1'
    try:
        for key in e2e_bench.E2E_CONFIGS:
            with tile_steps() as tiles, module_values(e2e_bench,
                                                      measure_e2e=measure_and_read):
                rate, delta = run('e2e_' + key, lambda: e2e_bench.run_config(
                    key, N_IMAGES, BATCH))
            frame = frames.pop()
            vals = frame[[('bench_%s' % key, 'PSNR'), ('LR', 'PSNR')]].to_numpy()
            if len(frame) != N_IMAGES or not np.isfinite(vals).all():
                raise AssertionError('e2e %s: %d rows, finite=%s'
                                     % (key, len(frame), np.isfinite(vals).all()))
            e2e[key] = {'img_per_s': rate, 'mean_psnr': float(vals[:, 0].mean()),
                        'launches': delta, 'tile_batches': dict(tiles)}
    finally:
        if saved_passes is None:
            os.environ.pop('BENCH_PASSES')
        else:
            os.environ['BENCH_PASSES'] = saved_passes
    if abs(e2e['edsr_int8']['mean_psnr'] - e2e['edsr']['mean_psnr']) > 1.0:
        raise AssertionError('e2e edsr_int8 mean PSNR %.4f, edsr %.4f' % (
            e2e['edsr_int8']['mean_psnr'], e2e['edsr']['mean_psnr']))
    expect_launches(e2e['qrcan']['launches'], {
        **NO_LAUNCHES, 'fused_channel_attention': CA_PER_FORWARD * forwards,
        'fused_channel_attention_onchip': CA_PER_FORWARD * forwards}, 'e2e qrcan')
    for key in NO_CA_CONFIGS:
        expect_launches(e2e[key]['launches'], NO_LAUNCHES, 'e2e ' + key)
    grid = tile_grid((LR_SIZE, LR_SIZE), e2e_bench.E2E_CONFIGS['san']['internal'][
        'max_combined_im_size'])
    if grid < 2 or e2e['san']['tile_batches'] != {grid * grid * BATCH: forwards}:
        raise AssertionError('e2e san tile batches %s (grid %d)'
                             % (e2e['san']['tile_batches'], grid))

    # the family table and --paper
    with module_values(bench_models, ITERS=2, WARM=1, PAPER_ITERS=2):
        table, table_launches = run('table', lambda: bench_models.main_table(set(), 'cuda'))
        paper, _ = run('paper', lambda: bench_models.main_paper(set(), 'cuda'))
    failed = sorted(k for k, v in table.items() if v is None)
    if failed or len(table) != len(bench_models._families()):
        raise AssertionError('family table: FAILED rows %s' % failed)
    for row in paper:
        if row['mfu'] is not None and not 0 < row['mfu'] <= 1:
            raise AssertionError('--paper %s MFU %s' % (row['name'], row['mfu']))
    int8_rcan = next(r for r in paper if r['name'] == 'rcan 10x20x64 int8')
    route, plan = planned_res_route((bench_models.BATCH, LR_SIZE, LR_SIZE, 64),
                                    64 // RCAN['reduction'], 4, 2)
    want = CA_PER_FORWARD * int8_rcan['calls']
    got = int8_rcan['launches']
    on_route = got['ca_res_rounds' if route == 'onchip' else 'ca_res_stream'
                   if route == 'stream' else 'ca_res']
    if got['ca_res'] != want or on_route != want or got['ca']:
        raise AssertionError('--paper int8 RCAN launches %s, expected %d on %s'
                             % (got, want, route))

    # --train and --val, one timed epoch each, on 32 and 16 images
    with module_values(e2e_bench, TIMED_EPOCHS=1,
                       run_train_bench=functools.partial(e2e_bench.run_train_bench,
                                                         n_images=32),
                       run_val_bench=functools.partial(e2e_bench.run_val_bench,
                                                       n_images=16)):
        train, _ = run('train', lambda: bench_models.main_train({'--train', '--vs-torch'},
                                                                'cuda'))
        val, _ = run('val', lambda: bench_models.main_val('cuda'))
    if not all(np.isfinite(v) and v > 0 for v in (*train.values(), *val)):
        raise AssertionError('--train %s, --val %s' % (train, val))

    # every bench_quantization section, at batch 8 (the tool's 16) to keep the phase short
    with module_values(bench_quantization, ITERS=1, BATCH=8), \
            module_values(bench_models, WARM=1):
        quant, _ = run('quantization', lambda: bench_quantization.main(['--all']))
    for section in quant:
        for carry, v in section['int8'].items():
            if not (v['img_s'] > 0 and np.isfinite(v['db_vs_f32'])):
                raise AssertionError('bench_quantization %s %s: %s'
                                     % (section['family'], carry, v))

    # bench_ca_epilogue: the standalone shapes on their planned routes, then end to end
    epilogue, epilogue_launches = [], dict(NO_LAUNCHES)
    with module_values(bench_ca_epilogue, ITERS=5, E2E_ITERS=1, ROUNDS=1, WARM=1):
        for shape in bench_ca_epilogue.SHAPES:
            for r_dtype in ('bfloat16', 'float32'):
                result, delta = run('ca_epilogue', lambda: bench_ca_epilogue.bench_standalone(
                    *shape, device='cuda', r_dtype=r_dtype), count=False)
                key = {'rounds': 'fused_channel_attention_residual_onchip',
                       'stream': 'fused_channel_attention_residual_stream'}.get(
                    result['route'])
                n = delta['fused_channel_attention_residual']
                if not n or (key and delta[key] != n) or (not key and (
                        delta['fused_channel_attention_residual_onchip']
                        or delta['fused_channel_attention_residual_stream'])):
                    raise AssertionError('ca_epilogue %s %s on %s: launches %s'
                                         % (shape, r_dtype, result['route'], delta))
                bad = result['max_abs_err'] > 1e-5 if r_dtype == 'float32' \
                    else result['max_ulps'] > 2
                if bad:
                    raise AssertionError('ca_epilogue %s %s: %s' % (shape, r_dtype, result))
                epilogue.append(result)
                epilogue_launches = {k: epilogue_launches[k] + delta[k] for k in delta}
        result, delta = run('ca_epilogue_e2e', lambda: bench_ca_epilogue.bench_e2e_int8_rcan(
            device='cuda'), count=False)
    epilogue_launches = {k: epilogue_launches[k] + delta[k] for k in delta}
    # the raw outputs at least 40 dB apart, or as close as a rounding-only change of the
    # plain tail leaves them (its pool summed other ways), whichever is lower
    limit = min([40.0, *result['witness_psnr_db_unclipped'].values()])
    result['limit_db'] = limit
    if not result['psnr_db_unclipped'] >= limit:
        raise AssertionError('ca_epilogue e2e: kernel and plain outputs %.2f dB apart, '
                             'limit %.2f (rounding witnesses %s)'
                             % (result['psnr_db_unclipped'], limit,
                                result['witness_psnr_db_unclipped']))
    epilogue.append(result)

    # bench_bucketed, bench_decode_cache --passes 1, train_soak for 32 steps
    bucketed, _ = run('bucketed', lambda: bench_bucketed.main([]))
    per_shape, buckets = (r[2] for r in bucketed.values())
    want_buckets = len({(-(-h // 32) * 32, -(-w // 32) * 32)
                        for h, w in bench_bucketed.SHAPES})
    if (per_shape, buckets) != (len(set(bench_bucketed.SHAPES)), want_buckets):
        raise AssertionError('bench_bucketed shapes %s' % bucketed)
    # each arm's per-image CSV read after its passes (the tool then removes it)
    timed_passes = bench_decode_cache._timed_passes

    def passes_and_read(hub, *args, **kwargs):
        result = timed_passes(hub, *args, **kwargs)
        frames.append(csv_of(hub.out_dir))
        return result
    with module_values(bench_decode_cache, _timed_passes=passes_and_read):
        decode, _ = run('decode_cache', lambda: bench_decode_cache.main(['--passes', '1']))
    arms, frames[:] = frames[:], []
    psnr = [arm[('bench_edsr', 'PSNR')] for arm in arms]
    if len(psnr) != 2 or not psnr[0].equals(psnr[1]):
        raise AssertionError('bench_decode_cache: the sidecar arm\'s PSNR differs')
    soak_out = os.path.join(root, 'soak_out')
    soak, _ = run('soak', lambda: train_soak.main([*SOAK_ARGS, '--out', soak_out]))
    with open(os.path.join(soak_out, 'soak_result.json')) as f:
        written = json.load(f)
    if written != soak or not all(
            isinstance(soak[k], (int, float)) and np.isfinite(soak[k])
            for k in ('steps', 'train_img_per_sec_per_chip', 'db_over_bicubic')):
        raise AssertionError('train_soak result %s' % written)
    torch.cuda.empty_cache()
    line = {'seconds': time.perf_counter() - tic,
          'tool_seconds': seconds, 'flops': flop_counts,
          'e2e': {k: {kk: v[kk] for kk in ('img_per_s', 'mean_psnr', 'tile_batches')}
                  for k, v in e2e.items()},
          'table_img_per_s': table, 'table_launches': table_launches,
          'paper': paper, 'int8_rcan_route': route, 'train': train,
          'val_img_per_s': {'standard': val[0], 'fused': val[1]},
          'quantization': quant, 'ca_epilogue': epilogue,
          'ca_epilogue_launches': epilogue_launches,
          'bucketed': {k: {'cold_s': v[0], 'warm_s': v[1], 'forward_shapes': v[2]}
                       for k, v in bucketed.items()},
          'decode_cache': decode, 'soak': soak, 'launches': total,
          'nvidia_smi': nvidia_smi_line()}
    return {'line': line, 'launches': total}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: nothing to run.',
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, 'sisr_tpu_torch')):
        print('chip_smoke: the sisr_tpu_torch package is not beside this script.',
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    root = tempfile.mkdtemp(prefix='sisr_chip_smoke_')
    # the workload's PNGs and seeded experiments are written on the host while nvcc
    # builds the kernels
    from concurrent.futures import ThreadPoolExecutor
    writer = ThreadPoolExecutor(max_workers=1)
    workload = writer.submit(prepare_workload, root)
    side_jobs = []  # processes started beside the phases (rank jobs), reaped at the end
    try:
        phase_environment()
        ca_main = phase_kernel()
        ca_res_main = phase_kernel_residual()
        meta_gate = phase_kernel_meta()
        extent = phase_kernel_extent()
        stream = phase_kernel_stream()
        batch1 = phase_kernel_batch1()
        training_shapes = phase_kernel_backward()
        training_shape = training_shapes['float32']
        for name in ('rcan_10x20', 'qrcan_10x20', 'edsr_16b', 'han_10x10', 'qhan_10x10',
                     'san_20x5', 'qsan_20x5', 'srmd_12', 'sftmd_16b', 'sftmd_q16b',
                     'sparnet_128', 'qsparnet_512', 'srcnn_955', 'vdsr_20'):
            phase_reference(name)
        phase_holistic_attention()
        phase_san_attention()
        phase_int8_reference()
        for name in INT8_REFERENCE:
            phase_int8_family_reference(name)
        phase_train_reference()
        phase_degradation()
        phase_int8_dynamic()
        dirs = workload.result()
        paths = {'rcan_bf16': phase_main_path(dirs)}
        paths['rcan_int8'] = phase_int8_main_path(dirs, paths['rcan_bf16']['mean_psnr'])
        for name, model in (('qrcan', 'qrcan_10x20'), ('edsr', 'edsr_16b'),
                            ('qedsr', 'qedsr_32b'), ('han', 'han_10x10'),
                            ('qhan', 'qhan_10x10'), ('san', 'san_20x5'),
                            ('qsan', 'qsan_20x5'), ('srmd', 'srmd_12'),
                            ('sftmd', 'sftmd_16b'), ('vdsr', 'vdsr_20')):
            paths[name + '_bf16'] = phase_main_path(dirs, model)
            paths[name + '_int8'] = phase_int8_main_path(
                dirs, paths[name + '_bf16']['mean_psnr'], model)
        for name, model in (('sparnet', 'sparnet_128'), ('qsparnet', 'qsparnet_512'),
                            ('srcnn', 'srcnn_955')):
            paths[name + '_bf16'] = phase_main_path(dirs, model)
        for name, model in (('sparnet', 'sparnet_128'), ('srcnn', 'srcnn_955')):
            paths[name + '_int8_ignored'] = phase_int8_ignored(
                dirs, paths[name + '_bf16']['frame'], model)
        paths['qrcan_train'] = phase_train_main_path(dirs, root)
        bf16_steps = phase_bf16_train_steps(paths['qrcan_train']['breakdowns'])
        mixed = write_mixed_workload(dirs, root)
        for name, model in (('rcan', 'rcan_10x20'), ('qrcan', 'qrcan_10x20')):
            paths[name + '_standard'] = phase_standard_eval(mixed, model,
                                                            paths[name + '_bf16']['frame'])
        paths['rcan_buckets'] = phase_bucketed_eval(mixed, paths['rcan_standard']['frame'])
        paths['rcan_int8_standard'] = phase_int8_standard(
            mixed, paths['rcan_standard']['mean_psnr'])
        div2k_tail = paths['rcan_int8_standard']['stream_tail']
        paths['rcan_model_only'] = phase_model_only(mixed)
        paths['qrcan_f32_model_only'] = phase_qrcan_f32_model_only(mixed)
        paths['qhan_standard'] = phase_standard_eval(mixed, 'qhan_10x10',
                                                     paths['qhan_bf16']['frame'], images=False)
        paths['qhan_buckets'] = phase_bucketed_eval(mixed, paths['qhan_standard']['frame'],
                                                    'qhan_10x10')
        paths['qsan_standard'] = phase_tiled_standard_eval(mixed, 'qsan_20x5',
                                                           paths['qsan_bf16']['frame'])
        paths['qsan_grid'] = phase_qsan_grid(dirs, paths['qsan_bf16']['mean_psnr'])
        paths['sftmd_standard'] = phase_standard_eval(mixed, 'sftmd_16b',
                                                      paths['sftmd_bf16']['frame'],
                                                      images=False)
        paths['sftmd_buckets'] = phase_bucketed_eval(
            mixed, paths['sftmd_standard']['frame'], 'sftmd_16b')
        paths['qsparnet_standard'] = phase_preupscaled_standard(mixed, dirs, root)
        # the serving exports (host work) and the benchmark tools (phase 18, a process
        # of its own) run beside the recipes, phase 15's training runs and the
        # perceptual train runs, none of them timed, and end before its timed steps
        exports = start_exports(dirs, root)
        side_jobs.extend(job for job, _ in exports.values())
        side_jobs.append(start_rank_job('bench_tools',
                                        {'root': os.path.join(root, 'bench_tools')}, root))
        paths['qrcan_train_standard_val'] = phase_train_standard_val(dirs, root)
        paths['qhan_train_standard_val'] = phase_train_standard_val(dirs, root, 'qhan')
        paths['qsan_train_standard_val'] = phase_train_standard_val(dirs, root, 'qsan')
        paths['sftmd_train_standard_val'] = phase_train_standard_val(dirs, root, 'sftmd')
        paths['qsparnet_train_standard_val'] = phase_train_standard_val(
            write_interp_workload(dirs, root), root, 'qsparnet', 'celebahq')
        paths['qrcan_online_train'] = phase_online_train_main_path(dirs, root)
        paths['qrcan_host_degradation_train'] = phase_host_degradation_train(dirs, root)
        faces = write_celeba_workload(dirs, root)
        paths['qrcan_attributes_eval'] = phase_attributes_eval(faces)
        paths['qrcan_sampler_train'] = phase_sampler_train(faces, root)
        paths['qrcan_perceptual_train'] = phase_perceptual_train(
            dirs, root, settle=lambda: finish_jobs(side_jobs, time.monotonic()))
        bench = rank_result(root, 'bench_tools', 0)
        emit({'phase': 'bench_tools', 'ran_beside': 'the recipes, phase 15\'s training '
              'runs, the perceptual train runs and the serving exports', **bench['line']})
        paths['bench_tools'] = {'launches': bench['launches']}
        paths['qsparnet_face_sim_eval'] = phase_face_sim_eval(dirs, root)
        paths['tools_path'] = phase_tools_path(dirs, root, paths['qrcan_perceptual_train'],
                                               paths['qrcan_bf16']['frame'])
        # the serving checks run while phase 17's ranks work; their timings after it
        serving = []
        paths.update(phase_multi_gpu(
            dirs, root, {'bf16': paths['rcan_bf16']['frame'],
                         'int8': paths['rcan_int8']['frame']}, paths['qsan_grid']['frame'],
            meanwhile=lambda: serving.append(phase_export_serving(
                dirs, root, paths['rcan_bf16']['frame'], exports))))
        paths['export_serving'] = serving[0]()
    finally:
        reap(side_jobs)
        writer.shutdown(wait=True)
        shutil.rmtree(root, ignore_errors=True)

    def path_launches(count):
        """Each path's launches of one route, ``count`` of its read_launches."""
        out = {}
        for path, result in paths.items():
            n = count(result['launches'])
            if n:
                out[path] = n
        return out

    ca_key, res_key = 'fused_channel_attention', 'fused_channel_attention_residual'
    source = 'sisr_tpu_torch/ops/cuda/csrc/channel_attention.cu'
    pallas = 'sisr_tpu/ops/pallas/channel_attention.py:'
    # one row for each route of each TPU kernel; each row's times are those of its
    # main-path shape: 1a the bf16 eval map on chip; 1b (three passes, and the rounds
    # route that took its place) the f32 map of int8 Q-RCAN's tail with its meta and
    # gate; 1b's stream route the DIV2K-size f32 map with the f32 Q-RCAN's gate; 2a/2b
    # int8 RCAN's f32 map with its bf16 carry; 2b's stream route the same at DIV2K size
    meta_f32 = meta_gate[1]
    rows = [
        ('fused_channel_attention: ca_onchip', pallas + '112',
         lambda c: c[ca_key + '_onchip'], ca_main),
        ('fused_channel_attention: three-pass (sisr_ca_forward)', pallas + '135',
         lambda c: (c[ca_key] - c[ca_key + '_onchip'] - c[ca_key + '_rounds']
                    - c[ca_key + '_stream']),
         {**meta_f32, 'ms': meta_f32['three_pass_ms'],
          'max_abs_err': meta_f32['three_pass_max_abs_err']}),
        ('fused_channel_attention: ca_rounds without r (sisr_ca_rounds_forward)',
         pallas + '135', lambda c: c[ca_key + '_rounds'], meta_f32),
        ('fused_channel_attention: ca_stream without r (sisr_ca_stream_forward)',
         pallas + '135', lambda c: c[ca_key + '_stream'], stream['ca'][0]),
        ('fused_channel_attention_residual: ca_rounds with r (sisr_ca_rounds_forward)',
         pallas + '202', lambda c: c[res_key + '_onchip'], ca_res_main),
        ('fused_channel_attention_residual: three-pass (sisr_ca_res_forward)',
         pallas + '226',
         lambda c: c[res_key] - c[res_key + '_onchip'] - c[res_key + '_stream'],
         {**ca_res_main, 'ms': ca_res_main['three_pass_ms'],
          'max_abs_err': ca_res_main['three_pass_max_abs_err']}),
        ('fused_channel_attention_residual: ca_stream with r (sisr_ca_stream_forward)',
         pallas + '226', lambda c: c[res_key + '_stream'], stream['res'][0]),
    ]
    kernel_rows = []
    for name, replaces, count, timing in rows:
        by_path = path_launches(count)
        kernel_rows.append({
            'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces,
            'launches': sum(by_path.values()), 'max_abs_err': timing['max_abs_err'],
            'ms': timing['ms'], 'plain_ms': timing['plain_ms'],
            'bound_ms': timing['bound_ms'], 'bound_by': timing.get('bound_by', 'bytes'),
            'library_ms': None, 'launches_by_path': by_path})
    (ca_row, ca_three_row, ca_rounds_row, ca_stream_row, res_row, res_three_row,
     res_stream_row) = kernel_rows
    ca_row.update({'host_ms': ca_main['host_ms'], 'device_ms': ca_main['device_ms'],
                   'plain_device_ms': ca_main['plain_device_ms'], 'plan': ca_main['plan'],
                   'three_pass_ms_at_this_shape': ca_main['three_pass_ms']})
    # the meta and gate inputs of Q-RCAN's bf16 path, at its shape (on chip)
    ca_row.update({'meta_gate_' + key: meta_gate[0][key]
                   for key in ('ms', 'no_meta_ms', 'plain_ms', 'bound_ms', 'max_abs_err')})
    # the training path's shape, f32 (on chip), and in bf16 (the bf16 train step's map)
    ca_row.update({'training_shape_' + key: training_shape[key]
                   for key in ('ms', 'plain_ms', 'bound_ms', 'max_abs_err')})
    ca_row.update({'training_shape_bf16_' + key: training_shapes['bfloat16'][key]
                   for key in ('ms', 'plain_ms', 'bound_ms', 'max_ulps')})
    # the standard protocol's batch-1 bf16 maps, each with its ca_onchip launches as
    # each standard-protocol path's run counted them (batch 1 is that protocol's alone)
    for case in batch1:
        key = '%s bfloat16' % 'x'.join(map(str, case['shape']))
        case['launches_by_path'] = {path: result['onchip_by_map'][key]
                                    for path, result in paths.items()
                                    if key in result.get('onchip_by_map', {})}
        case['launches'] = sum(case['launches_by_path'].values())
        if not case['launches']:
            raise AssertionError('no main path launched ca_onchip at %s' % key)
    ca_row['batch1_shapes'] = batch1
    # int8 Q-RCAN's f32 map with meta and gate (and without), the two routes in turns
    ca_three_row.update({'shape': meta_f32['shape'],
                         'no_meta_ms': meta_f32['no_meta_three_pass_ms']})
    ca_rounds_row.update({'shape': meta_f32['shape'], 'plan': meta_f32['plan'],
                          'no_meta_ms': meta_f32['no_meta_ms'],
                          'no_meta_bound_ms': meta_f32['no_meta_bound_ms'],
                          'three_pass_ms_at_this_shape': meta_f32['three_pass_ms']})
    res_row.update({'host_ms': ca_res_main['host_ms'], 'device_ms': ca_res_main['device_ms'],
                    'plain_device_ms': ca_res_main['plain_device_ms'],
                    'plan': ca_res_main['plan']})
    # int8 Q-RCAN's QRCAB tail (meta, gate, cast first) against the sequence it replaced
    res_row.update({'qrcab_tail_' + key: ca_res_main['qrcab_tail'][key]
                    for key in ('ms', 'sequence_ms', 'plain_ms', 'bound_ms', 'max_abs_err',
                                'tail_over_sequence', 'plan')})
    res_three_row.update({'host_ms': ca_res_main['three_pass_host_ms'],
                          'device_ms': ca_res_main['three_pass_device_ms']})
    # the stream route at DIV2K size, in turns against the three passes; at the 512 x
    # 384 bucket too; the tail also as int8 RCAN's standard protocol timed it
    for row, key in ((ca_stream_row, 'ca'), (res_stream_row, 'res')):
        first, bucket = stream[key]
        row.update({k: first[k] for k in ('shape', 'plan', 'three_pass_ms',
                                          'three_pass_max_abs_err', 'share_of_bound')})
        row.update({'bucket_' + k: bucket[k] for k in ('shape', 'ms', 'three_pass_ms',
                                                       'plain_ms', 'bound_ms',
                                                       'share_of_bound')})
    res_stream_row.update({'int8_standard_' + k: v for k, v in div2k_tail.items()})
    # the valid-extent pool (bucketed eval) on each CA route, with and without meta
    # and gate, timed in turns against the same call without an extent
    for row, route in ((ca_row, 'onchip'), (ca_three_row, 'three_pass'),
                       (ca_rounds_row, 'rounds'), (ca_stream_row, 'stream')):
        for case in extent:
            if case['path'] == route:
                tag = 'masked_meta_gate_' if case['meta_gate'] else 'masked_'
                row.update({tag + key: case[key] for key in (
                    'shape', 'valid_hw', 'dtype', 'ms', 'unmasked_ms', 'plain_ms',
                    'bound_ms', 'max_abs_err')})
    # int8 img/s over bf16 img/s of each family's fused eval (the table of
    # sisr_tpu_torch.models.handlers.INT8_MEASURED_SLOWER)
    int8_over_bf16 = {family: paths[family + '_int8']['img_per_s']
                      / paths[family + '_bf16']['img_per_s']
                      for family in ('rcan', 'qrcan', 'edsr', 'qedsr', 'han', 'qhan',
                                     'san', 'qsan', 'srmd', 'sftmd', 'vdsr')}
    emit({'phase': 'total', 'seconds': time.perf_counter() - START,
          'int8_over_bf16_img_per_s': int8_over_bf16, 'nvidia_smi': nvidia_smi_line(),
          'bf16_over_f32_train_step_wall': {name: v['bf16_over_f32_wall']
                                            for name, v in bf16_steps.items()},
          'masked_launches_by_path': path_launches(lambda c: c[ca_key + '_masked'])})
    emit({'kernels': kernel_rows})
    print(nvidia_smi_line())
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    if len(sys.argv) == 4 and sys.argv[1] == '--rank-job':  # one rank of phase_multi_gpu
        sys.exit(rank_job(sys.argv[2], json.loads(sys.argv[3])))
    sys.exit(main())

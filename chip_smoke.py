#!/usr/bin/env python3
"""Drive yolo_tpu_torch's serving, evaluation and training paths on one
CUDA card and check them.

    python3 chip_smoke.py

Its paths, each with the mask config (2 classes) at 416², through
hand-written CUDA kernels, decode, softmax·sigmoid and greedy NMS (a
hand-written kernel too):
slim_yolo_v2 INT8 (int8 input in the padded space-to-depth layout, ten
fixed-point conv layers; phases 2-4), yolo_v3 INT8 (int8 NHWC input,
75 convs: 23 fused darknet53 residual blocks and 29 general int8 convs,
three scales, the entry pair through ``int8_entry_pair_s2d``; phases
2b-4b; on the s2d layout and as yolo_v3_spp in phase 6, served through
``cli.serve`` with native preprocessing in phase 6d) and slim_yolo_v2
INT8 with per-channel
weight scales (int8 NHWC input; phases 2c-4c), with its overflow-counting
forward ``int8_forward_diagnostics``; yolo_v3 INT8 with per-channel
weight scales (int8 NHWC input; phases 2d-4d), every conv on the
per-column form of its kernel; and tiny_yolo_v3 and yolo_v2 INT8 (phase
7; s2d and NHWC input; 7d with per-channel weight scales). Phases, each
printing JSON lines; any failure raises and the script exits nonzero:

0. header: versions, the card's name and power limit, and whether
   F.conv2d takes int8 / int32 CUDA tensors (information only);
1. build the kernels from ``yolo_tpu_torch/kernels/csrc`` with nvcc;
2. every kernel against its plain PyTorch version (torch.equal) at the
   ten slim layer shapes, batch 8, with asymmetric weights, nonzero
   biases, both roundings, an accumulator shift >= 32 and a negative
   output shift; plus K2 with assembly='stride2', K3 with pool=False and
   K1 at C_in 16 (their mma.sync routes), and K3 (the wgmma conv3x3's
   pooled form) at conv2's, conv3_2's and conv4_2's widths on images
   whose even tiles leave edge tiles, and K2's wgmma kernel on the s2d
   layout at odd pooled widths, C_in 4, C_out 32, 20 and 7, partial row
   tiles and width chunks, each from HWIO and from packed weights (phase
   4 checks them again at the serving batch);
3. the golden fixture (``yolo_tpu_torch/data/slim_int8_416_golden.npz``,
   made by the JAX package): the int8 head bit-exact, on the s2d input
   and on the same images' NHWC layout (conv1 then on the NHWC form of
   K2's wgmma kernel), classes and valid exact, boxes and scores allclose
   (atol = rtol = 1e-5);
4. serving: batch 256 through ``make_int8_detect_fn``, timed, with the
   launch counts of each kernel checked (per forward: K2 once, on its
   wgmma kernel, K3 3 times, all 3 on the wgmma conv3x3's pooled form, K1
   6 times, all 6 on the wgmma conv3x3) and the weights of those 10
   layers (and conv1's NHWC form) packed when the detect fn took the
   model, never in the loop; then the same on the images' NHWC layout,
   conv1 once on the NHWC form of K2's wgmma kernel;
   then each layer's kernel checked against its plain version
   (torch.equal) and both timed at batch 256, beside cuDNN's fp16 conv (a
   speed yardstick only), K1's, K2's and K3's layers also beside the
   mma.sync kernel they ran on before (same call) and with the wgmma
   kernel's layout (tile, blocks per SM; ring stages and the share of its
   64-row wgmma steps on pixels, or K2's row pitches, GB/s and share of
   HBM bandwidth);
2b. the yolo_v3 kernels against their plain versions (torch.equal):
   ``int8_res_block`` (K4) at the five darknet53 stage shapes, batch 4,
   slopes 0.1 and 0.125, both roundings, without the residual, with an
   accumulator shift of 33 and with a negative output shift (the kernel's
   general shift form), from HWIO weights (packed per call) and from
   the pre-packed K-major form; K4 also at three shapes whose tiles leave
   edge tiles (100², 50², 27²); ``int8_conv_requant`` at every distinct
   conv shape of the v3 program (the C_in = 3 entry conv, the stride-2
   convs, the two-part concat convs, the heads), both roundings, the
   stride-2 convs also with no activation and a negative output shift,
   the 1x1s (on the wgmma 1x1 kernel) also with a negative output shift,
   slopes 0.1 and none, and each 1x1 and concat 1x1 also on the mma.sync
   conv kernel it ran on before (``_launch_conv_requant``); the wgmma 1x1
   kernel at edge shapes (M not a multiple of its tile, C_out 21, 24, 35
   and 300, parts of C_in 16, 48 and 80, concats at equal and at distinct
   part shifts) with every slope and shift form, from HWIO and from packed
   weights; the entry conv kernel at odd widths, C_in 1 and 2, C_out 35 and 64,
   partial row tiles and width chunks, every slope and shift form;
   the wgmma conv3x3 through both wrappers at three shapes whose tiles
   leave edge tiles (27², 50², 100²), and its stride-2 form at five odd
   images (27², 53² twice, one over halo slabs, 101², 9² to C_out 35),
   from HWIO and from packed weights;
   ``int8_gemm`` (K5) at six GEMM shapes, M, N and K not multiples of its
   128 x 256 x 128 tile, three with K % 16 != 0 (padded on K), each with b
   as [K, N] and K-major;
3b. the yolo_v3 golden fixture (``yolo_tpu_torch/data/
   yolo_v3_int8_416_golden.npz``: tables and checksum; the weights are
   rebuilt from its seed): heads of 2 images bit-exact with the JAX
   package's, classes and valid exact, boxes and scores allclose
   (atol = rtol = 1e-5);
4b. yolo_v3 serving: batch 128 through ``make_int8_yolo_v3_detect_fn``,
   timed as phase 4, with the launch counts checked (per forward: K4 23,
   ``int8_conv_requant`` 29: the nine head 3x3s on the wgmma conv3x3, the
   five stride-2 3x3s on its stride-2 form, the C_in = 3 entry conv on the
   entry conv kernel, the fourteen 1x1s on the wgmma 1x1 kernel, none on
   the mma.sync conv) and the weights of K4, of the 14 wgmma 3x3s, of the
   entry conv and of the 14 1x1s packed once, when the detect fn took the
   model, never in the loop; then each distinct shape
   checked
   and timed (kernel, plain version, bound, and a library yardstick the
   port never calls: cuDNN fp16 convs for K4 and the 3x3 convs,
   ``torch._int_mm`` for the 1x1 convs and K5), with K4's layout at each
   stage and the wgmma conv3x3's at each head 3x3 and stride-2 conv as
   their CUDA sources pick them (tile, the share of the 64-row wgmma steps
   that carry pixels, blocks per SM, ring stages, halo channels; the
   entry conv's tile and row pitches; the 1x1 kernel's column tile, ring
   stages, blocks launched and resident weight bytes), those 3x3s, the
   entry conv and the 1x1s also beside the mma.sync conv kernel (same
   call; its timed 1x1s are the ``mma_sync`` line's, which has no serving
   launch), the stride-2 convs, the entry conv and the 1x1s with GB/s and
   the share of HBM bandwidth, and, at 13², K4's
   time at batch 128, at one block per SM and at two (what the 4 SMs that
   batch 128 leaves idle could give); K5 is timed with b K-major, the
   layout ``torch._int_mm`` reads, so both read the same bytes;
2c. the per-column forms against their plain versions (torch.equal): the
   wgmma conv3x3's stride-1 form at slim's six K1 widths (pred's 35
   columns included), its pooled form at the three K3 widths, and the
   NHWC form of K2's wgmma kernel at conv1 (C_in 3, pooled), NHWC, batch
   8, both roundings, per-channel sw with >= 3 distinct values and a
   negative shift, shifts of 31, 33 and -40 (outside the short form), all
   in [0, 30] (the short form); and the counting forms (per-channel and
   scalar sw), their counts equal to the plain versions' and nonzero;
   then the NHWC form of K2's kernel at edge shapes (rows of W * C_in
   bytes no 16-byte multiple, C_in 2-4, C_out 16-32, partial row tiles,
   width chunks) in its scalar form (every shift form, both roundings,
   leaky on and off, HWIO and packed weights), per-column and counting
   forms;
2d. per-channel yolo_v3 on the per-channel 416² fixture's model
   (``yolo_tpu_torch/data/yolo_v3_int8_pc_416_golden.npz``, weights
   rebuilt from its seed; this phase and 3d-4d run after phase 4c, so
   that the serving phases run as in a tree without them): every conv's
   sw holds >= 2 values; ``pack_res_blocks`` and ``pack_conv3x3s`` make
   the shift tables once (92 for K4: two per block; 62 for the others:
   one per input scale of a conv's parts; both roundings); then K4's
   per-column form at the five darknet53 stage shapes, batch 128, with
   each stage's first block (packed weights, tables, scales), with and
   without the residual, and the 29 convs outside the residual blocks at
   batch 128, 416², each on random int8 input through
   ``int8_res_block`` / ``int8_conv_requant`` with the packed weights and
   tables, as the forward calls them: K4, the entry conv, the five
   stride-2 convs, the nine head 3x3s and the fourteen 1x1s each one
   launch of its per-column C entry (none on the mma.sync conv, no table
   made in a call), torch.equal to its plain version in both roundings,
   each printing its share of saturated outputs (all saturated or all one
   value fails); the two concat 1x1s also with their parts' scales
   forced equal (one table) and forced different (a table per part);
3c. the per-channel golden fixture (``yolo_tpu_torch/data/
   slim_int8_pc_416_golden.npz``: tables, checksum and seeds; the weights
   rebuilt from the seed): the head of 4 NHWC images bit-exact from
   packed and from HWIO weights, classes and valid exact, boxes and scores
   allclose (atol = rtol = 1e-5), and the diagnostics forward's counts
   equal to the JAX package's for the calibrated model and two
   raised-retune variants;
4c. per-channel serving: batch 256 of NHWC int8 through
   ``make_int8_detect_fn``, timed as phase 4, per forward 6 launches on
   the per-column stride-1 form, 3 on the per-column pooled form, 1 on
   the per-column NHWC form of K2's wgmma kernel (conv1), none on the
   mma.sync conv, the 9 + 1 packs and 20 shift tables made when the
   detect fn took the model, none in the loop;
   ``int8_forward_diagnostics`` timed at batch 256 the same way (6 / 3 /
   1 on the counting forms); each layer's per-column, counting and scalar
   kernel checked and timed at batch 256 beside its plain version and
   cuDNN fp16, with the bound, conv1's also beside the mma.sync conv it
   ran on before;
2e. the wgmma conv3x3's two-part form (a 3x3 over a two-part concat:
   tiny_yolo_v3's conv_set_1, yolo_v2's convsets_2.0) against its plain
   version (torch.equal) at ``PARTS_SHAPES`` (26², odd 13² and 9², C_out
   35, 64, 256, 1,024), both roundings, equal part scales (one
   accumulator) and unequal ones (two), scalar sw in the short and the
   general shift forms (an accumulator shift >= 32, a negative output
   shift), per-column sw on one table or two (shifts of 31, 33, -1 and
   -40, or all in [0, 30]), slopes 0.1, 0.125 and none, from the parts'
   packed weights, each one launch of the two-part C entry; then the two
   served convs at their serving batch (256, 128), scalar and per
   column; then tiny's conv_2 with its pool as one pooled call at slope
   0.1 (the pooled form, scalar and per column) at 64², 100² and the
   served 208², batch 256;
3d. the per-channel v3 fixture on the card: the heads of its 2 images
   through the CUDA forward (packed weights and tables) bit-exact with
   the JAX package's, the detect fn's classes and valid exact, boxes and
   scores allclose (atol = rtol = 1e-5);
4d. per-channel v3 serving: batch 128 through
   ``make_int8_yolo_v3_detect_fn``, timed as phase 4b, per forward 23
   launches on K4's per-column C entry and 9 / 5 / 1 / 14 on the
   per-column stride-1, stride-2, entry and 1x1 entries, none on a scalar
   entry or the mma.sync conv, the 23 + 14 + 1 + 14 packs and 92 + 62
   shift tables made when the detect fn took the model, none in the
   loop; then K4's five stage shapes and each distinct conv shape timed
   beside its plain version and a library yardstick, with the bound.

5. the port's own PTQ toolchain on the card at 416², full width
   (``quant.int8_graph.quantize_pipeline``,
   ``quant.int8_yolo_v3.quantize_pipeline_yolo_v3``: float models in
   true float32, BN fold, pow2 fake-quant, tracker calibration, retune
   search), on the recipes of the JAX package's fixtures: 5a per-channel
   slim (``slim_int8_pc_416_golden.npz``), 5b yolo_v3 scalar and
   per-channel (both v3 fixtures), 5c slim from BN-form params with the
   fold (``slim_int8_bn_416_tables.npz``, whose weight.h sha256 it also
   holds). Every table equal to the fixture's and the int8 weights'
   sha256 equal; each built model served once through its detect fn,
   with the launch counts of that run checked (5a on the per-column
   kernels on NHWC input, 5b on K4 and the 29 general-conv launches, 5c
   on the s2d path: K2, K3 x3, K1 x6), its int8 head bit-exact with the
   fixture's, its detections as the fixture's where it holds them; the
   seconds per pipeline, calibration ms per batch, the float forward's
   ms per 416² image, and for 5c how far the card's float tracker scales
   and maxima lie from the JAX package's.

6. the serving entry point (phase 6): 6a the native
   preprocessing library (``native/``, built by ``make`` on first use) in
   use, its s2d layout byte-equal to ``s2d_input_np`` of its NHWC int8,
   within the JAX package's tolerances of the numpy path, its ms per
   batch of 128 camera frames; 6b yolo_v3 on the s2d serving layout
   (``input_s2d``; the fused entry pair on the entry conv and stride-2
   kernels after ``nhwc_from_entry_blocks``): the v3 fixture's heads
   bit-exact, detections equal to the NHWC detect fn's, per-forward
   launches phase 4b's, the relayout's device time and bound at batch
   128, s2d and NHWC serving alternated (NHWC, s2d, s2d, NHWC); 6c
   yolo_v3_spp on its fixture (``yolo_v3_spp_int8_416_golden.npz``):
   heads bit-exact on NHWC and s2d input, detections, served at batch 128
   (per forward v3's launches: K4 23, the fourteen 1x1s on the wgmma 1x1
   kernel, the 4096 -> 512 one included), ``int_spp`` equal to the CPU's,
   its pool kernels by
   name; 6d ``cli.serve.main`` for slim_yolo_v2 and yolo_v3 (``--input
   auto``: s2d), batch 64, 416²: end-to-end frames/sec sequential and
   overlapped, native preprocessing in use, ``detect_frames`` equal to
   the detect fn on the same batch and ``detect_stream`` to
   ``detect_frames``;
7. tiny_yolo_v3 (7a, batch 256) and yolo_v2 (7b, batch 128) INT8 on
   their 416² fixtures (``tiny_yolo_v3_int8_416_golden.npz``,
   ``yolo_v2_int8_416_golden.npz``, weights rebuilt from their seeds):
   heads bit-exact on NHWC and s2d input, detections the fixture's,
   served on both inputs with per-forward launches checked (tiny: the
   entry conv or K2 once, 7 one-part wgmma 3x3s, conv_set_1 on the
   two-part form, conv_2 with its pool on the pooled form, 3 wgmma 1x1s;
   yolo_v2: 1, 13, convsets_2.0 on the two-part form, 8; none on the
   mma.sync general conv), its weights packed when the detect fn took
   the model and never in the loop, images/sec, backbone and decode +
   NMS ms; every conv of one NHWC forward on its recorded input and the
   entry conv + pool on the s2d layout against its plain version and
   timed beside its plain version and cuDNN fp16 (``torch._int_mm`` for
   a 1x1), with its bound, the two-part and pooled convs also with their
   device time (``torch.profiler``); the port's PTQ of each from the
   fixture's seed and images, every table and the weights' sha256 the
   fixture's, served once; 7d both with per-channel weight scales on
   their per-channel 416² fixtures (``tiny_yolo_v3_int8_pc_416_golden.npz``,
   ``yolo_v2_int8_pc_416_golden.npz``, made by the JAX package, weights
   rebuilt from their seeds): heads bit-exact on NHWC input, detections
   the fixture's, served at batch 256 and 128 with every conv on the
   per-column form of its kernel (launches checked, packs and shift
   tables made when the detect fn took the model, none in the loop),
   images/sec, and every conv of one forward on its real input against
   its plain version and timed as 7a; 7c ``cli.serve.main`` for
   tiny_yolo_v3 at batch 64 and yolo_v2 at batch 64 (``--input auto``:
   s2d) and 128 (int8 NHWC).
8. the serving entry point's last slice: 8b every served configuration
   (slim on s2d, NHWC and per-channel; yolo_v3, per-channel, on s2d and
   yolo_v3_spp; tiny_yolo_v3 and yolo_v2 on s2d and NHWC and per-channel)
   through its detect fn captured in a CUDA graph (the makers' only
   form on the card) and eager (its ``captured.fn``): detections
   ``torch.equal``; each graph's kernel nodes, as the CUDA driver lists
   them, hold as many hand-written kernels as an eager call's wrappers
   launched, launches the graph recorded at its capture (so the
   launches derived for replays are launches the card made; every graph
   of the CLI and artifact runs of 6d, 7c, 8c and 8d is held so too); no
   wrapper launch in the captured loop; one NMS launch a forward; no
   host read in the eager call (``torch.cuda.set_sync_debug_mode``);
   images/sec both
   ways, decode + NMS ms with the NMS kernel and with the plain fixpoint
   the detect fns ran before, the device's idle share
   (``torch.profiler``) on slim s2d and tiny s2d; 8a the greedy NMS
   kernel (``csrc/nms_greedy.cu``) ``torch.equal`` to its plain version
   on those configurations' real candidates, on the chain of boxes that
   greedy thins to every other one (K = 128, 512, 1024) and on tied boxes
   at thresholds not exact in float32, each served shape timed (CUDA
   events and ``torch.profiler``) beside its plain version and bound,
   and K = 512 on slim s2d at the CLI's batch 64 and tiny s2d at 256; 8c
   ``serving.export.save_artifact`` -> ``load_artifact`` of slim s2d at
   batch 256 and yolo_v3 at 128, outputs ``torch.equal`` to the live
   detect fn's, images/sec of the loaded (captured) program, then
   ``cli.serve --artifact``; 8d ``cli.serve --fp32`` (the float
   Detector) for slim and yolo_v3, and ``--trained_model`` from a
   checkpoint the port's ``save_checkpoint`` wrote of the CLI's own
   seeded weights, detecting as the CLI does without it. The earlier
   phases drive their detect fns eagerly (``captured.fn``), so their
   counts are per eager forward.
9. the evaluation path: 9a slim_yolo_v2 INT8 as ``cli.eval -q`` builds
   it (the CLI's seeded weights, the port's PTQ on the card on the stack
   of the first 16 images), 256 synthetic images of the CLI's recipe
   (seed 1) at batch 64 on NHWC float32 input through
   ``eval.VOCEvaluator(cache_device=True)``: mAP and class APs,
   images/sec of the first pass (ms per batch of generation + transform,
   host-to-device copy, detect, bookkeeping) and of the cached second
   pass (the same mAP); per forward slim's NHWC serving launches and one
   NMS, the evaluation all replays of one captured graph, held to its
   recorded kernels; the first 16 images' detections (per class and
   image: as many, boxes and scores within 1e-5) and mAP (within 1e-9)
   equal to the same evaluator's on the CPU route; 9b slim ``--fp32`` (the
   float Detector) and tiny_yolo_v3, yolo_v2 and yolo_v3 INT8 on 64
   images each: mAP, images/sec, the INT8 ones' launches per forward their
   NHWC serving forward's (4b, 7); 9c ``cli.eval.evaluate`` with ``-q``
   on the CLI's default set (32 images) prints ``Mean AP``,
   ``cli.kmeans.main`` on the same set; where cv2 imports (a line says
   so otherwise) ``cli.test`` and ``cli.demo``, and 16 of the images as
   jpgs in a VOC-format tree through ``cli.eval -d mask --dataset_root``
   and in a COCO tree through ``eval.coco_eval.COCOEvaluator``. The
   weights are random: the mAPs show that the path runs and scores, not
   accuracy.
10. one training batch (no kernel of the port: cuDNN's float32 convs,
   TF32 off forward and backward): 10a ``SSDAugmentation`` on 64
   synthetic-hard 416² images on the native and the numpy backend, float
   and uint8 output (boxes and labels equal, pixels within the JAX
   package's tolerances for the pair), ms per image; ``BatchLoader`` at
   batch 32 in thread and in process mode, forked after the CUDA context
   exists (equal batches), images/sec; 10b slim_yolo_v2 and 10c yolo_v3
   at 416² on a loader batch (uint8, to the card): ``build_targets``,
   the train forward, ``loss_fn``, ``backward()``, held to the CPU route
   on 4 / 2 images (loss rtol 1e-4, BN running stats allclose, each
   gradient leaf's relative L2 error within 2e-2 / 1e-1, ~4x what
   float32 rounding alone gives, ``check_gradients``), then fwd +
   bwd timed at batch 32 / 16 with a ``torch.profiler`` breakdown and,
   as a yardstick, with cuDNN's TF32 in the conv backward.
11. the trainer (``train.trainer.make_train_step``: SGD with coupled
   weight decay over the whole tree, the BN running stats included; no
   kernel of the port inside the step): 11a one step of slim_yolo_v2 at
   416², batch 8, held to the same step in float64 on the CPU on the
   card's branches (every parameter, running stat and momentum-trace
   leaf within GRAD_BOUND of its largest value), and the step with bf16
   compute against it (reported); 11b ms a step, images/sec and peak
   memory at full width: slim at batch 32 in float32, bf16, remat and
   fast_pool_cin=32, yolo_v3 at 16 in float32 and remat; 11c the JAX
   package's mAP guard (``tests/test_map_guard.py``) on the port: slim
   at 64² trained from its seeded init by ``train_device_resident`` (64
   easy synthetic images, batch 16, 150 epochs) with torch's
   deterministic algorithms, twice (the two states must be equal), fp32
   and BN-folded mAP
   on 32 images (seed 99), the port's PTQ uncapped and with head_clip 16,
   each INT8 model scored through ``make_int8_detect_fn`` on the s2d
   input (K2, K3, K1: launches checked, replays held to their graphs),
   the guard's four assertions; 11d those INT8 models on the CPU route
   (the plain versions) on the same images: detections and mAP equal;
   11e ``cli.train`` on its default device: two multi-scale epochs with
   the mAP after each, a checkpoint, a third epoch resumed from it.
12. the rest of quantization (QAT, the clip search, the compression CLI;
   its INT8 engines run K2, K3, K1 and NMS): 12a one QAT step
   (``quant.qat.QATModule`` through ``make_train_step``) of BN-folded
   slim at 416², batch 8, lr 1e-3, held to the same step in float64 on
   the CPU on the card's branches (its leaky signs, pool argmaxes and
   each STE tap's clip mask and levels: every leaf within GRAD_BOUND of
   its largest value), the flips listed with their margins; the masters
   bit-identical after a step at lr 0; 12b ms a QAT step at 416², batch
   32, beside a plain float32 step of the same folded model; 12c 11c's
   trained slim, folded: ``autoclip.select_quant_config(greedy_rounds=
   1)`` on the guard's calibration batches through the kernels (a cap
   must bind) and on the CPU route (the same choices, every score within
   1e-3), then ``qat_finetune`` at the CLI's defaults on the guard's
   training set at the chosen cap's states, served with those states
   through ``build_int8_detector(states=...)`` on the s2d input: mAP
   within 0.06 of its fake-quant sim (``quantize_detector(states=...)``)
   and equal on the CPU route, launches checked, replays held to their
   graphs, beside the PTQ engine at QAT's starting states; 12d ``cli.quantize`` on the card as a user runs it (bnfold
   from 11c's checkpoint, ``ptq --head_clip auto``, ``qat``, ``export
   --header --artifact --artifact_input s2d``, ``cli.serve --artifact``):
   weight.h byte-equal to the export run with ``--device cpu``, the
   artifact's detections equal to the live detect fn's.

K4 (``csrc/int8_res_block.cu``), K5 (``csrc/int8_gemm.cu``) and the
3x3 conv (``csrc/int8_conv3x3_wgmma.cu``: all of K1 on the serving path
and the v3 head's nine 3x3s; its pooled form: all of K3 on the serving
path; its stride-2 form: v3's five downsampling convs) run on wgmma fed
by a TMA ring (``csrc/int8_wgmma.cuh``); K2 on the s2d input, its NHWC
form (slim's conv1 on NHWC input) and v3's C_in = 3 entry conv on
row-streaming wgmma kernels (``csrc/int8_entry_conv.cu``); v3's fourteen
1x1s on a wgmma GEMM with resident weights
(``csrc/int8_conv1x1_wgmma.cu``); the two-part 3x3s of tiny_yolo_v3 and
yolo_v2 on the wgmma conv3x3's two-part form, tiny's conv_2 with its
pool on its pooled form. The mma.sync conv of ``csrc/int8_conv.cuh``
serves no layer of any path; it is held to its plain version and timed
on v3's 1x1s and at conv1 on NHWC input (the general conv's route for
the shapes no wgmma route takes). The
``kernels`` line has one entry per kernel and route: ``int8_conv_requant``
five times; the per-column forms (of slim's and v3's per-channel serving)
and the counting forms (whose launches come from the diagnostics run)
and conv1's NHWC route each their own; ``launches`` also counts phase
6's, 7's, 8's, 9's, 11c's and 12's runs, their wrappers' own launches (the eager calls,
a captured fn's warm-up calls); ``replayed_launches`` is what the CUDA
graphs' replays ran, derived from each graph's capture and checked. The NMS kernel's entry times slim's candidates at
its serving shape (8a). The two-part form's entries time tiny's conv_set_1
plus yolo_v2's convsets_2.0 (scalar: 7a, 7b; per column: 7d); each entry
on tiny_yolo_v3's or yolo_v2's path has ``paths``: their launches per
forward and the times of their shapes (``.pc``: 7d's per-channel
models).

The second-to-last lines are the ``kernels`` JSON and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Exits nonzero without a result when
there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH_CHECK, BATCH_SERVE, SIZE = 8, 256, 416
V3_BATCH_CHECK, V3_BATCH_SERVE, V3_PRED_OUT = 4, 128, 21
SERVE_WARMUP, SERVE_ITERS = 3, 10
CSRC = "yolo_tpu_torch/kernels/csrc/"
WGMMA3 = "yolo_int8_conv3x3_wgmma"  # the wgmma conv3x3's C entry
POOL3 = "yolo_int8_conv3x3_pool_wgmma"  # and its pooled form's
S2_3 = "yolo_int8_conv3x3_s2_wgmma"  # and its stride-2 form's
ENTRY3 = "yolo_int8_entry_conv3x3_wgmma"  # the v3 entry conv kernel's
POOL_S2D = "yolo_int8_pool_s2d_wgmma"  # K2's on the s2d layout
NMS_K = "yolo_nms_greedy"  # the greedy NMS kernel's
CONV1X1 = "yolo_int8_conv1x1_wgmma"  # the v3 1x1 kernel's
# the wgmma conv3x3's per-column (per-channel sw) and counting forms
COLS3 = "yolo_int8_conv3x3_cols_wgmma"
POOL_COLS3 = "yolo_int8_conv3x3_pool_cols_wgmma"
COUNT3 = "yolo_int8_conv3x3_count_wgmma"
POOL_COUNT3 = "yolo_int8_conv3x3_pool_count_wgmma"
MMA3 = "yolo_int8_conv3x3_requant"  # the mma.sync conv3x3 (K1-K3)
# the NHWC form of K2's wgmma kernel (conv1 on NHWC input): its scalar,
# per-column and counting C entries
POOL_NHWC = "yolo_int8_pool_nhwc_wgmma"
POOL_NHWC_COLS = "yolo_int8_pool_nhwc_cols_wgmma"
POOL_NHWC_COUNT = "yolo_int8_pool_nhwc_count_wgmma"
# per-channel yolo_v3's per-column C entries (phase 2d): the wgmma
# conv3x3's stride-2 form, the entry conv and the 1x1 GEMM (the head 3x3s
# take COLS3)
S2_COLS3 = "yolo_int8_conv3x3_s2_cols_wgmma"
ENTRY_COLS3 = "yolo_int8_entry_conv3x3_cols_wgmma"
CONV1X1_COLS = "yolo_int8_conv1x1_cols_wgmma"
RES_COLS = "yolo_int8_res_block_cols_wgmma"  # K4's per-column form
# the wgmma conv3x3's two-part form (a 3x3 over a two-part concat: tiny's
# conv_set_1, yolo_v2's convsets_2.0), scalar and per column
PARTS3 = "yolo_int8_conv3x3_parts_wgmma"
PARTS_COLS3 = "yolo_int8_conv3x3_parts_cols_wgmma"
# The kernels line, one entry per kernel and route: name -> (wrapper, the
# C entry it launches there, source, the TPU kernel (Pallas body) it
# replaces; int8_conv_requant replaces XLA's integer conv in
# int_conv_requant, no Pallas kernel)
LINES = {
    "int8_conv3x3_requant": (
        "int8_conv3x3_requant", WGMMA3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/kernels/int8_conv.py:100"),
    "int8_conv3x3_pool_requant": (
        "int8_conv3x3_pool_requant", POOL_S2D, CSRC + "int8_entry_conv.cu",
        "yolo_tpu/kernels/int8_conv.py:306"),
    "int8_conv3x3_im2col": (
        "int8_conv3x3_im2col", POOL3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/kernels/int8_conv.py:145"),
    "int8_res_block": (
        "int8_res_block", "yolo_int8_res_block", CSRC + "int8_res_block.cu",
        "yolo_tpu/kernels/int8_conv.py:567"),
    "int8_conv_requant.conv3x3_wgmma": (
        "int8_conv_requant", WGMMA3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.conv3x3_s2_wgmma": (
        "int8_conv_requant", S2_3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.entry_conv3x3_wgmma": (
        "int8_conv_requant", ENTRY3, CSRC + "int8_entry_conv.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.conv1x1_wgmma": (
        "int8_conv_requant", CONV1X1, CSRC + "int8_conv1x1_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.mma_sync": (
        "int8_conv_requant", "yolo_int8_conv_requant",
        CSRC + "int8_conv_general.cu", "yolo_tpu/quant/fixed_point.py:725"),
    "int8_gemm": (
        "int8_gemm", "yolo_int8_gemm", CSRC + "int8_gemm.cu",
        "scripts/bench_int8_ceiling.py:68"),
    # slim on NHWC input: conv1 (K3 at C_in 3) on the NHWC form of K2's
    # wgmma kernel, scalar (phase 4's NHWC serving), per-column and
    # counting (phases 2c-4c)
    "int8_conv3x3_im2col.pool_nhwc": (
        "int8_conv3x3_im2col", POOL_NHWC, CSRC + "int8_entry_conv.cu",
        "yolo_tpu/kernels/int8_conv.py:145"),
    "int8_conv3x3_im2col.pool_nhwc_cols": (
        "int8_conv3x3_im2col", POOL_NHWC_COLS, CSRC + "int8_entry_conv.cu",
        "yolo_tpu/kernels/int8_conv.py:145"),
    "int8_conv3x3_im2col.pool_nhwc_count": (
        "int8_conv3x3_im2col", POOL_NHWC_COUNT, CSRC + "int8_entry_conv.cu",
        "yolo_tpu/kernels/int8_conv.py:145"),
    # slim with per-channel sw on NHWC input (phases 2c-4c): K1's six
    # layers and K3's conv2, conv3_2, conv4_2 on the per-column forms; the
    # counting forms in int8_forward_diagnostics
    "int8_conv3x3_requant.cols": (
        "int8_conv3x3_requant", COLS3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/kernels/int8_conv.py:100"),
    "int8_conv3x3_im2col.cols": (
        "int8_conv3x3_im2col", POOL_COLS3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/kernels/int8_conv.py:145"),
    "int8_conv3x3_requant.count": (
        "int8_conv3x3_requant", COUNT3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/kernels/int8_conv.py:100"),
    "int8_conv3x3_im2col.count": (
        "int8_conv3x3_im2col", POOL_COUNT3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/kernels/int8_conv.py:145"),
    # yolo_v3 with per-channel sw (phase 4d): K4's 23 blocks and the 29
    # convs outside them on the per-column forms
    "int8_res_block.cols": (
        "int8_res_block", RES_COLS, CSRC + "int8_res_block.cu",
        "yolo_tpu/kernels/int8_conv.py:567"),
    "int8_conv_requant.conv3x3_cols_wgmma": (
        "int8_conv_requant", COLS3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.conv3x3_s2_cols_wgmma": (
        "int8_conv_requant", S2_COLS3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.entry_conv3x3_cols_wgmma": (
        "int8_conv_requant", ENTRY_COLS3, CSRC + "int8_entry_conv.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.conv1x1_cols_wgmma": (
        "int8_conv_requant", CONV1X1_COLS, CSRC + "int8_conv1x1_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    # tiny_yolo_v3's conv_set_1 and yolo_v2's convsets_2.0 (phases 2e, 7):
    # the two-part form, scalar and (7d) per column
    "int8_conv_requant.conv3x3_parts_wgmma": (
        "int8_conv_requant", PARTS3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    "int8_conv_requant.conv3x3_parts_cols_wgmma": (
        "int8_conv_requant", PARTS_COLS3, CSRC + "int8_conv3x3_wgmma.cu",
        "yolo_tpu/quant/fixed_point.py:725"),
    # every detect fn's greedy NMS (phase 8a; the JAX package runs it as a
    # lax.while_loop of Jacobi sweeps, no Pallas kernel)
    "greedy_nms_keep": (
        "greedy_nms_keep", NMS_K, CSRC + "nms_greedy.cu",
        "yolo_tpu/ops/nms.py:165"),
}
# the kernels-line entries whose launches come from the diagnostics
# forward (phase 4c), not from serving
DIAGNOSTICS_LINES = ("int8_conv3x3_requant.count", "int8_conv3x3_im2col.count",
                     "int8_conv3x3_im2col.pool_nhwc_count")
# the wgmma conv3x3 at (B, H, C_in, C_out) whose tiles leave edge tiles
CONV3X3_EDGE_SHAPES = [(2, 27, 256, 256), (2, 50, 128, 256),
                       (2, 100, 32, 64)]
# its stride-2 form at (B, H, C_in, C_out), odd images whose tiles leave
# edge tiles (53² C_in 256: a halo of two 128-channel slabs; 9²: C_out 35)
S2_EDGE_SHAPES = [(2, 27, 256, 512), (2, 53, 256, 512), (2, 53, 64, 128),
                  (2, 101, 32, 64), (2, 9, 32, 35)]
# its pooled form (K3) at conv2's, conv3_2's and conv4_2's widths, whose
# even tiles leave edge tiles
POOL_EDGE_SHAPES = [(2, 100, 16, 32), (2, 30, 64, 64), (2, 54, 128, 128)]
# the entry conv kernel at (B, H, W, C_in, C_out): odd widths whose rows
# are no 16-byte multiple, C_in 1 and 2, C_out 35 and 64, row tiles that
# leave a partial tile, width chunks
ENTRY_EDGE_SHAPES = [(2, 17, 23, 3, 32), (1, 33, 40, 2, 35),
                     (3, 50, 30, 1, 64), (1, 3, 1501, 3, 64)]
# K2's wgmma kernel on the s2d layout of (B, H, W, C_in, C_out) images: odd
# pooled widths, C_in 4, C_out 32 (128 columns) and 7, partial row tiles,
# width chunks
POOL_S2D_EDGE_SHAPES = [(2, 14, 10, 3, 32), (1, 6, 18, 4, 20),
                        (3, 38, 26, 3, 16), (1, 4, 6002, 3, 7)]
# the NHWC form of K2's wgmma kernel at (B, H, W, C_in, C_out): NHWC rows of
# W * C_in bytes that are no 16-byte multiple (10 x 3, 22 x 3, 14 x 4, 26 x
# 2), C_out 20 and 32 (the 128-column form), row tiles that leave a partial
# tile, width chunks
POOL_NHWC_EDGE_SHAPES = [(2, 8, 10, 3, 16), (2, 12, 22, 3, 32),
                         (1, 10, 14, 4, 32), (3, 38, 26, 2, 20),
                         (1, 4, 6002, 3, 16)]
# the wgmma 1x1 kernel at (B, H, W, C_in parts, C_out): M not a multiple of
# its 64-row tile, C_out 21, 24, 35 and 300 (a ragged second column tile),
# parts of C_in 16, 48 and 80, two-part concats (each case runs at equal
# and at distinct part shifts), the served 26² concat at batch 3
CONV1X1_EDGE_SHAPES = [(1, 7, 9, (16,), 24), (2, 5, 5, (48,), 21),
                       (1, 11, 13, (80,), 35), (2, 9, 7, (48, 80), 64),
                       (1, 3, 3, (16, 16), 21), (1, 10, 10, (256,), 300),
                       (3, 13, 13, (512, 256), 256)]
GEMM_SHAPES = [(4096, 4096, 4096), (692224, 288, 64), (1000, 200, 100),
               (333, 72, 98), (7, 9, 33), (300, 1000, 520)]
# the two-part form at (B, H, parts' C_in, C_out) (phase 2e): conv_set_1's
# [256, 128] -> 256 at 26², convsets_2.0's [256, 1024] -> 1024 at 13²,
# C_out 35 and 64, odd images (13², 9²); then the two at the serving batch
PARTS_SHAPES = [(2, 26, (256, 128), 256), (2, 13, (256, 1024), 1024),
                (2, 13, (64, 32), 35), (3, 26, (128, 64), 64),
                (1, 9, (32, 96), 64)]
PARTS_SERVED = [(256, 26, (256, 128), 256), (128, 13, (256, 1024), 1024)]
# K4 shapes (B, H, C, C_mid) whose tiles leave edge tiles
RES_EDGE_SHAPES = [(2, 100, 128, 64), (2, 50, 256, 128), (2, 27, 512, 256)]
GEMM_PROBE = (8192, 8192, 8192)  # the TPU probe's headline shape
# The card the port targets, H100 SXM (torch names it "NVIDIA H100 80GB
# HBM3"), and its data-sheet peaks: dense int8 ops/s, HBM bytes/s.
CARD, PEAK_OPS, PEAK_BW = "H100 80GB HBM3", 1979e12, 3.35e12


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nms_launches(n: int) -> dict:
    """The greedy NMS kernel's launches by entry for ``n`` detect calls
    (one a call, every detect fn's postprocess)."""
    return {"greedy_nms_keep": {NMS_K: n}}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks(name: str):
    if CARD not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}; the "
                           f"bounds are for the {CARD} (H100 SXM)")
    return PEAK_OPS, PEAK_BW


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, n: int = 20) -> float:
    """Host time of one call (the wrapper's checks, set-up and launch),
    over ``n`` calls that the card runs behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / n


def conv2d_probe(dtype) -> str:
    x = torch.ones((1, 1, 4, 4), dtype=dtype, device="cuda")
    w = torch.ones((1, 1, 3, 3), dtype=dtype, device="cuda")
    try:
        torch.nn.functional.conv2d(x, w)
        torch.cuda.synchronize()
        return "accepted"
    except (RuntimeError, NotImplementedError) as e:
        return f"refused: {str(e).splitlines()[0][:120]}"


def slim_layers():
    """(name, H at the layer's input, c_in, c_out, pool, wrapper) on the
    main path with s2d input."""
    from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS

    out, h = [], SIZE
    for name, c_in, c_out, pool in CONV_LAYERS + (("pred", 256, 35, False),):
        if name == "conv1":
            kernel = "int8_conv3x3_pool_requant"
        else:
            kernel = "int8_conv3x3_im2col" if pool else "int8_conv3x3_requant"
        out.append((name, h, c_in, c_out, pool, kernel))
        h = h // 2 if pool else h
    return out


def make_case(gen, b, h, c_in, c_out, *, s2d):
    """Random int8 input (NHWC, or its padded s2d layout), asymmetric
    weights, nonzero biases, on the card."""
    def ri(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32
                             ).to(dtype).cuda()
    from yolo_tpu_torch.quant import fixed_point as fp

    x = ri((b, h, h, c_in), -128, 128, torch.int8)
    if s2d:
        x = fp.s2d_input(x).contiguous()
    w = ri((3, 3, c_in, c_out), -90, 120, torch.int8)
    bias = ri((c_out,), -100, 100, torch.int32)
    return x, w, bias


def shifts(c_in: int, case: str):
    """Shift tables that spread the int8 output: acc_shift brings the
    accumulator's spread to ~2^12, out_shift 6 to ~2^6."""
    acc_shift = max(0, round(math.log2(math.sqrt(9 * c_in) * 74 * 60
                                       / 4096)))
    kw = dict(sa_in=4, sa_out=4, retune=10, sb=8)
    if case == "acc_shift>=32":
        acc_shift = 33
    if case == "out_shift<0":
        kw["sa_out"] = 12
        acc_shift += 8
    kw["sw"] = acc_shift + kw["retune"] - kw["sa_in"]
    return kw


def call(form, x, w, bias, c_in, kw, packed=None):
    from yolo_tpu_torch.kernels import int8_conv as K

    if form == "s2d":
        return K.int8_conv3x3_pool_s2d(x, w, bias, c_in=c_in, packed=packed,
                                       **kw)
    if form == "stride2":
        return K.int8_conv3x3_pool_requant(x, w, bias, assembly="stride2",
                                           **kw)
    if form == "s2d_assembly":
        return K.int8_conv3x3_pool_requant(x, w, bias, assembly="s2d", **kw)
    if form in ("im2col_pool", "im2col"):
        return K.int8_conv3x3_im2col(x, w, bias, pool=form == "im2col_pool",
                                     packed=packed, **kw)
    return K.int8_conv3x3_requant(x, w, bias, packed=packed, **kw)


def plain(form, x, w, bias, c_in, kw):
    from yolo_tpu_torch.kernels import int8_conv as K

    if form == "s2d":
        return K.int8_conv3x3_pool_s2d_plain(x, w, bias, c_in=c_in, **kw)
    if form in ("stride2", "s2d_assembly"):
        return K.int8_conv3x3_pool_requant_plain(
            x, w, bias, assembly="s2d" if form == "s2d_assembly"
            else "stride2", **kw)
    if form in ("im2col_pool", "im2col"):
        return K.int8_conv3x3_im2col_plain(
            x, w, bias, pool=form == "im2col_pool", **kw)
    return K.int8_conv3x3_requant_plain(x, w, bias, **kw)


def ran_line() -> str:
    """The kernels-line name of the one launch since the counts were last
    reset (``wrapper (C entry)`` for a route off the serving paths)."""
    from yolo_tpu_torch.kernels import launch_counts_by_entry

    (wrapper, entries), = launch_counts_by_entry().items()
    (entry, n), = entries.items()
    assert n == 1, entries
    for name, (w, e, _, _) in LINES.items():
        if (w, e) == (wrapper, entry):
            return name
    return f"{wrapper} ({entry})"


def main_form(name, pool):
    if name == "conv1":
        return "s2d"
    return "im2col_pool" if pool else "requant"


# (rounding, shift case, weights form, slope) of the thin-input kernels'
# edge-shape checks (K2's NHWC form reads the slope as on / off; K2 on
# the s2d layout takes 0.1, the entry slope of tiny_yolo_v3 and yolo_v2)
THIN_CASES = (("nearest", "plain", "hwio", 0.1),
              ("floor", "out_shift<0", "packed", 0.1),
              ("nearest", "acc_shift>=32", "packed", True),
              ("floor", "plain", "hwio", False))


def rand_case(gen, b, h, w, c_in, c_out):
    """Random int8 NHWC input [b, h, w, c_in], asymmetric weights, nonzero
    biases, on the card."""
    def r(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                             device=gen.device).to(dtype).cuda()

    return (r((b, h, w, c_in), -128, 128, torch.int8),
            r((3, 3, c_in, c_out), -90, 120, torch.int8),
            r((c_out,), -100, 100, torch.int32))


def phase_kernels(max_err):
    """Every kernel == its plain version on the card (phase 2)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp

    gen = torch.Generator().manual_seed(0)
    cases = [(name, h, ci, co, pool, main_form(name, pool))
             for name, h, ci, co, pool, _ in slim_layers()]
    cases += [("conv1", SIZE, 3, 16, True, "stride2"),
              ("conv1", SIZE, 3, 16, True, "s2d_assembly"),
              ("conv2", SIZE // 2, 16, 32, False, "im2col"),
              ("conv2", SIZE // 2, 16, 32, False, "requant")]
    n = 0
    for name, h, c_in, c_out, pool, form in cases:
        x, w, bias = make_case(gen, BATCH_CHECK, h, c_in, c_out,
                               s2d=form == "s2d")
        for rounding in ("nearest", "floor"):
            for case in ("plain", "acc_shift>=32", "out_shift<0"):
                if case != "plain" and rounding == "floor":
                    continue
                kw = dict(shifts(c_in, case), leaky=name != "pred",
                          rounding=rounding)
                K.reset_launch_counts()
                got = call(form, x, w, bias, c_in, kw)
                torch.cuda.synchronize()
                k = ran_line()
                check_equal(k, got, plain(form, x, w, bias, c_in, kw),
                            max_err, f"{name} ({form}) {rounding} {case}")
                n += 1
        emit("kernels_vs_plain", layer=name, form=form, kernel=k,
             shape=[BATCH_CHECK, h, h, c_in, c_out], equal=True,
             out_std=round(float(got.float().std()), 3))
    for bsz, h, c_in, c_out in POOL_EDGE_SHAPES:
        x, w, bias = make_case(gen, bsz, h, c_in, c_out, s2d=False)
        packed = K.pack_conv3x3_weights(w)
        for rounding, case, form in (("nearest", "plain", "hwio"),
                                     ("floor", "out_shift<0", "packed"),
                                     ("nearest", "acc_shift>=32", "packed"),
                                     ("floor", "plain", "hwio")):
            kw = dict(shifts(c_in, case), leaky=True, rounding=rounding)
            K.reset_launch_counts()
            got = call("im2col_pool", x, w, bias, c_in, kw,
                       packed if form == "packed" else None)
            torch.cuda.synchronize()
            check_equal(ran_line(), got,
                        plain("im2col_pool", x, w, bias, c_in, kw), max_err,
                        f"K3 {h}x{h} {c_in}->{c_out} {rounding} {case} "
                        f"{form}")
            n += 1
        emit("kernels_vs_plain", kernel="conv3x3 pooled wgmma edge tiles",
             shape=[bsz, h, h, c_in, c_out],
             tile=list(K.conv3x3_pool_wgmma_layout(h, h, c_in, c_out)[:2]),
             equal=True)
    for bsz, h, w, c_in, c_out in POOL_S2D_EDGE_SHAPES:
        x, wt, bias = rand_case(gen, bsz, h, w, c_in, c_out)
        x2 = fp.s2d_input(x).contiguous()
        packed = K.pack_pool_s2d_weights(wt)
        for rounding, case, form, leaky in THIN_CASES:
            kw = dict(shifts(c_in, case), leaky=leaky, rounding=rounding)
            K.reset_launch_counts()
            got = (K.int8_conv3x3_pool_s2d(x2, None, bias, c_in=c_in,
                                           packed=packed, **kw)
                   if form == "packed" else
                   K.int8_conv3x3_pool_s2d(x2, wt, bias, c_in=c_in, **kw))
            torch.cuda.synchronize()
            check_equal(ran_line(), got,
                        K.int8_conv3x3_pool_s2d_plain(x2, wt, bias,
                                                      c_in=c_in, **kw),
                        max_err, f"K2 s2d {h}x{w} {c_in}->{c_out} "
                                 f"{rounding} {case} {form} {leaky}")
            n += 1
        lay = K.pool_s2d_wgmma_layout(h, w, c_in, c_out)
        emit("kernels_vs_plain", kernel="K2 s2d wgmma edge shapes",
             shape=[bsz, h, w, c_in, c_out], tile=[lay.tile_h, lay.tile_w],
             equal=True)
    emit("kernels_vs_plain_done", cases=n, max_abs_err=max_err)


def nhwc_from_s2d(x2, h, w):
    """The NHWC images [B, h, w, C] whose padded s2d layout
    (``fixed_point.s2d_input``) is ``x2``."""
    b, hb, wb, c4 = x2.shape
    c = c4 // 4
    x = x2.reshape(b, hb, wb, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * hb, 2 * wb, c)[:, 3:3 + h, 3:3 + w].contiguous()


def phase_golden():
    """Golden 416² fixture: head bit-exact on the s2d input and on the
    same images' NHWC layout (conv1 on the NHWC form of K2's kernel),
    detections (phase 3)."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.convert import int8_model_from_arrays
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    path = (Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
            / "slim_int8_416_golden.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    m = int8_model_from_arrays(g, device="cuda")
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    x2 = torch.as_tensor(g["images_s2d"]).cuda()
    head = fp.int8_forward(m, x2, "nearest", input_s2d=True)
    head_q = torch.round(head * 2.0 ** m.sa["pred"]).to(torch.int8).cpu()
    if not torch.equal(head_q, torch.as_tensor(g["head_q"])):
        diff = (head_q.int() - torch.as_tensor(g["head_q"]).int()).abs()
        raise AssertionError(f"golden head differs: max |diff| "
                             f"{int(diff.max())}, {int((diff > 0).sum())} "
                             f"values")
    # the same images on NHWC input: conv1 on the NHWC form of K2's kernel
    x = nhwc_from_s2d(x2, SIZE, SIZE)
    if not torch.equal(fp.s2d_input(x), x2):
        raise AssertionError("the golden images' NHWC layout is not the "
                             "inverse of their s2d layout")
    m_packed = m.to("cuda")
    m_packed.pack_conv3x3()
    K.reset_launch_counts()
    head_nhwc = fp.int8_forward(m_packed, x, "nearest")
    want_entries = {"int8_conv3x3_requant": {WGMMA3: 6},
                    "int8_conv3x3_im2col": {POOL3: 3, POOL_NHWC: 1}}
    if K.launch_counts_by_entry() != want_entries:
        raise AssertionError(f"the NHWC golden forward launched "
                             f"{K.launch_counts_by_entry()}, want "
                             f"{want_entries}")
    if not torch.equal(head_nhwc.cpu(), head.cpu()):
        raise AssertionError("the golden head on NHWC input differs from "
                             "the s2d input's")
    detect = eager(make_int8_detect_fn(m, cfg, input_s2d=True, device="cuda"))
    boxes, scores, classes, valid = (t.cpu().numpy() for t in detect(x2))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    emit("golden", images=int(x2.shape[0]), head_bit_exact=True,
         nhwc_head_bit_exact=True, nhwc_launches_by_entry=want_entries,
         classes_valid_exact=True,
         boxes_max_abs_diff=float(np.abs(boxes - g["boxes"]).max()),
         scores_max_abs_diff=float(np.abs(scores - g["scores"]).max()),
         valid_slots=int(valid.sum()))
    return m, cfg


def phase_serving(m, cfg, card, input_s2d=True):
    """Batch-256 serving through the detect fn, launch counts (phase 4):
    on the s2d input, then on the same images' NHWC layout (conv1 on the
    NHWC form of K2's wgmma kernel)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.rand((BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                        device="cuda")
    x = fp.quantize_input(images, m.sa["in"]).contiguous()
    if input_s2d:
        x = fp.s2d_input(x).contiguous()
    del images
    resets = (K.reset_conv3x3_pack_count, K.reset_pool_s2d_pack_count,
              K.reset_pool_nhwc_pack_count)

    def made():
        return (K.conv3x3_pack_count(), K.pool_s2d_pack_count(),
                K.pool_nhwc_pack_count())

    for reset in resets:
        reset()
    detect = eager(make_int8_detect_fn(m, cfg, input_s2d=input_s2d,
                                       device="cuda"))
    packs_at_setup = made()
    if packs_at_setup != (9, 1, 1):
        raise AssertionError(f"the detect fn packed {packs_at_setup[0]} K1 "
                             f"and K3 layers and conv1 {packs_at_setup[1]} "
                             f"times for K2, {packs_at_setup[2]} times for "
                             f"its NHWC form, want 9, 1 and 1")
    for _ in range(SERVE_WARMUP):
        detect(x)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for reset in resets:
        reset()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        out = detect(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    entries = K.launch_counts_by_entry()
    n = SERVE_ITERS
    if input_s2d:
        want = {"int8_conv3x3_pool_requant": {POOL_S2D: n},
                "int8_conv3x3_im2col": {POOL3: 3 * n}}
    else:
        want = {"int8_conv3x3_im2col": {POOL3: 3 * n, POOL_NHWC: n}}
    want["int8_conv3x3_requant"] = {WGMMA3: 6 * n}
    want.update(nms_launches(n))
    if entries != want:
        raise AssertionError(f"launches {counts} {entries}, want {want}")
    if made() != (0, 0, 0):
        raise AssertionError(f"serving packed weights in the loop: "
                             f"{made()}")
    boxes, scores, classes, valid = out
    if (tuple(boxes.shape) != (BATCH_SERVE, cfg.top_k, 4)
            or not torch.isfinite(boxes).all()
            or not torch.isfinite(scores).all()):
        raise AssertionError("serving output has the wrong shape or is "
                             "not finite")
    m_packed = m.to("cuda")
    m_packed.pack_conv3x3()  # the weights the detect fn serves
    head_ms = time_ms(lambda: fp.int8_forward(m_packed, x,
                                              input_s2d=input_s2d), 5)
    emit("serving" if input_s2d else "serving_nhwc", batch=BATCH_SERVE,
         iters=SERVE_ITERS, images_per_sec=BATCH_SERVE * SERVE_ITERS / dt,
         ms_per_batch=1e3 * dt / SERVE_ITERS, backbone_ms_per_batch=head_ms,
         postprocess_ms=postprocess_ms(m_packed, x, cfg, input_s2d=input_s2d),
         launches=counts, launches_by_entry=entries,
         packs_at_setup=list(packs_at_setup), packs_in_loop=0, card=card)
    return entries


def postprocess_ms(m, x, cfg, input_s2d=False):
    """CUDA-event time of the detect fn's decode + greedy NMS alone, on
    the outputs ``m`` gives for ``x`` (the NMS's Jacobi sweeps depend on
    the detections, and each reads a flag on the host)."""
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.quant.int8_graph import int8_predict

    boxes, probs = int8_predict(m, x, cfg, input_s2d=input_s2d)
    return time_ms(lambda: nms.batched_postprocess(
        boxes, probs, cfg.conf_thresh, cfg.nms_thresh, cfg.pre_nms_top_k,
        cfg.top_k), 5)


def phase_layer_times(card_name, max_err):
    """Each main-path layer at batch 256: kernel == plain version, then
    kernel, plain version and cuDNN fp16 conv timed, and the bound
    (phase 4, timing)."""
    from yolo_tpu_torch.kernels import int8_conv as K

    peak_ops, peak_bw = peaks(card_name)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator().manual_seed(2)
    per_kernel = {}
    for name, h, c_in, c_out, pool, _ in slim_layers():
        form = main_form(name, pool)
        x, w, bias = make_case(gen, BATCH_SERVE, h, c_in, c_out,
                               s2d=form == "s2d")
        kw = dict(shifts(c_in, "plain"), leaky=name != "pred",
                  rounding="nearest")
        # K1, K2 and K3 read their weights packed, as serving does
        packed = (K.pack_pool_s2d_weights(w) if form == "s2d" else
                  K.pack_conv3x3_weights(w))
        K.reset_launch_counts()
        got = call(form, x, w, bias, c_in, kw, packed)
        line = ran_line()
        want = plain(form, x, w, bias, c_in, kw)
        check_equal(line, got, want, max_err,
                    f"{name} ({form}), batch {BATCH_SERVE}")
        extra = {}
        if line in ("int8_conv3x3_requant", "int8_conv3x3_im2col"):
            # the mma.sync conv kernel K1 and K3 ran on before, at the
            # same shape
            mma = lambda: K._launch(  # noqa: E731
                line, x, w, bias, h=h, w=h, c_in=c_in, pool=pool,
                s2d=False, **kw)
            check_equal(f"{line} (mma.sync)", mma(), want, max_err,
                        f"{name}, batch {BATCH_SERVE}")
            layout = (K.conv3x3_pool_wgmma_layout if pool
                      else K.conv3x3_wgmma_layout)
            extra = layout_fields(layout(h, h, c_in, c_out))
            extra["mma_sync_ms"] = time_ms(mma, 10)
        elif line == "int8_conv3x3_pool_requant":
            # the mma.sync pool_s2d kernel K2 ran on before
            mma = lambda: K._launch(  # noqa: E731
                line, x, w, bias, h=h, w=h, c_in=c_in, pool=True, s2d=True,
                **kw)
            check_equal(f"{line} (mma.sync)", mma(), want, max_err,
                        f"{name}, batch {BATCH_SERVE}")
            extra = row_layout_fields(K.pool_s2d_wgmma_layout(h, h, c_in,
                                                              c_out))
            extra["mma_sync_ms"] = time_ms(mma, 10)
        del got, want
        ms = time_ms(lambda: call(form, x, w, bias, c_in, kw, packed), 10)
        plain_ms = time_ms(lambda: plain(form, x, w, bias, c_in, kw), 2,
                           warmup=1)
        xh = torch.randn((BATCH_SERVE, c_in, h, h), device="cuda",
                         dtype=torch.float16
                         ).contiguous(memory_format=torch.channels_last)
        wh = torch.randn((c_out, c_in, 3, 3), device="cuda",
                         dtype=torch.float16
                         ).contiguous(memory_format=torch.channels_last)
        lib_ms = time_ms(
            lambda: torch.nn.functional.conv2d(xh, wh, padding=1), 10)
        del xh, wh
        ho = h // 2 if pool else h
        ops = 2 * BATCH_SERVE * h * h * 9 * c_in * c_out
        nbytes = (x.numel() + w.numel() + 4 * c_out
                  + BATCH_SERVE * ho * ho * c_out)
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        if line == "int8_conv3x3_pool_requant":  # bytes bound it
            extra.update(bandwidth_fields(nbytes, ms, peak_bw))
        emit("layer_time", layer=name, kernel=line, batch=BATCH_SERVE,
             equal=True, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9, **extra)
        add_time(per_kernel, line, 1, ms, plain_ms, lib_ms, t_ops,
                 t_bytes, extra.get("mma_sync_ms"))
        del x, w, bias, packed
        torch.cuda.empty_cache()
    return per_kernel


def add_time(per_kernel, kernel, count, ms, plain_ms, lib_ms, t_ops,
             t_bytes, mma_sync_ms=None):
    """Add one shape's times, ``count`` launches of it per forward, to its
    kernel's per-forward sums; the bound is the sum of each shape's own.
    ``mma_sync_ms``: a wgmma conv3x3 shape's time on the mma.sync conv."""
    agg = per_kernel.setdefault(kernel, dict(
        ms=0.0, plain_ms=0.0, library_ms=0.0, t_ops=0.0, t_bytes=0.0,
        bound_ms=0.0))
    if mma_sync_ms is not None:
        agg["mma_sync_ms"] = agg.get("mma_sync_ms", 0.0) + count * mma_sync_ms
    agg["ms"] += count * ms
    agg["plain_ms"] += count * plain_ms
    agg["library_ms"] += count * lib_ms
    agg["t_ops"] += count * t_ops
    agg["t_bytes"] += count * t_bytes
    agg["bound_ms"] += count * max(t_ops, t_bytes)


# ---------------------------------------------------------------------------
# yolo_v3 (phases 2b-4b)
# ---------------------------------------------------------------------------


def v3_shapes():
    """The v3 program's work at 416², by distinct shape, in program order:
    ({(H, C, C_mid): blocks} for K4, {(k, stride, pad, C_in parts, C_out,
    H_in, leaky): convs} for int8_conv_requant)."""
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    prog, specs = tv3._program(), tv3.conv_specs(V3_PRED_OUT)
    res, convs, slots = {}, {}, {}
    h, c, parts, ci, i = SIZE, 3, None, 0, 0
    while i < len(prog):
        op = prog[i]
        if op[0] == "push":  # push, conv 1x1, conv 3x3, res: one K4 block
            _, _, cin, cmid = specs[ci]
            res[(h, cin, cmid)] = res.get((h, cin, cmid), 0) + 1
            ci, i = ci + 2, i + 4
            continue
        if op[0] == "conv":
            _, k, cin, cout = specs[ci]
            key = (k, op[2], op[3], parts or (c,), cout, h, op[4])
            convs[key] = convs.get(key, 0) + 1
            h, c, parts, ci = (h + 2 * op[3] - k) // op[2] + 1, cout, None, \
                ci + 1
        elif op[0] == "save":
            slots[op[1]] = (h, c)
        elif op[0] == "load":
            h, c = slots[op[1]]
        elif op[0] == "up":
            h *= 2
        elif op[0] == "concat":
            parts = (slots[op[1]][1], c)
        i += 1
    return res, convs


def v3_tables(depth, case="plain"):
    """Shift tables that spread an int8 output over a conv of ``depth``
    int8 products: acc_shift brings the accumulator's spread to ~2^12;
    case "out_shift<0" shifts the activation left by 2 to the output."""
    acc_shift = max(0, round(math.log2(math.sqrt(depth) * 74 * 60 / 4096)))
    sa_out = 4
    if case == "acc_shift>=32":
        acc_shift = 33
    if case == "out_shift<0":
        acc_shift, sa_out = acc_shift + 8, 12
    return dict(sw=acc_shift + 10 - 4, sb=8, sa_in=4, sa_out=sa_out,
                retune=10)


def ri(gen, shape, lo, hi, dtype):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                         device="cuda").to(dtype)


def res_case(gen, b, h, c, cmid):
    x = ri(gen, (b, h, h, c), -128, 128, torch.int8)
    w1 = ri(gen, (1, 1, c, cmid), -90, 120, torch.int8)
    b1 = ri(gen, (cmid,), -100, 100, torch.int32)
    w2 = ri(gen, (3, 3, cmid, c), -90, 120, torch.int8)
    b2 = ri(gen, (c,), -100, 100, torch.int32)
    return x, w1, b1, w2, b2


def res_kw(c, cmid, case):
    """(p1, p2) shift tables of a residual block's two convs; case
    "out_shift<0" gives conv2 a negative output shift."""
    p1 = v3_tables(c, case)
    return p1, dict(v3_tables(9 * cmid), sa_in=p1["sa_out"],
                    sa_out=12 if case == "out_shift<0" else 5)


def conv_case(gen, b, key):
    k, stride, pad, cins, cout, h, leaky = key
    xs = [ri(gen, (b, h, h, c), -128, 128, torch.int8) for c in cins]
    w = ri(gen, (k, k, sum(cins), cout), -90, 120, torch.int8)
    bias = ri(gen, (cout,), -100, 100, torch.int32)
    return xs, w, bias


def conv_kw(key, case="plain", rounding="nearest"):
    k, stride, pad, cins, cout, h, leaky = key
    leaky = {"leaky_off": False, "slope_0.1": 0.1}.get(case, leaky)
    kw = dict(v3_tables(k * k * sum(cins), case), padding=pad, stride=stride,
              leaky=leaky, rounding=rounding)
    return kw


def mma_sync_conv(x, w, bias, kw):
    """``int8_conv_requant`` on the mma.sync conv kernel, whatever route
    the wrapper would take."""
    from yolo_tpu_torch.kernels import int8_conv as K

    return K._launch_conv_requant(
        K._parts(x, kw["sa_in"]), w, bias,
        **{a: v for a, v in kw.items() if a != "sa_in"})


def conv_input(xs, kw, split_scales=True):
    """One tensor, or the (tensor, sa) parts of a concat at two scales."""
    if len(xs) == 1:
        return xs[0]
    sa = kw["sa_in"]
    return [(xs[0], sa), (xs[1], sa + 2 if split_scales else sa)]


def layout_fields(lay):
    """The wgmma conv3x3's layout at a shape, for a JSON line."""
    return dict(tile=[lay.tile_h, lay.tile_w], ring_stages=lay.ring_stages,
                blocks_per_sm=lay.blocks_per_sm, bn=lay.bn,
                consumer_warpgroups=lay.consumer_warpgroups,
                rows_used=lay.tile_pixels / lay.mma_rows,
                halo_channels=lay.halo_channels)


def row_layout_fields(lay):
    """The layout of a kernel of ``csrc/int8_entry_conv.cu``, for a JSON
    line."""
    return dict(tile=[lay.tile_h, lay.tile_w], blocks_per_sm=lay.blocks_per_sm,
                bn=lay.bn, smem_bytes=lay.smem_bytes, in_pitch=lay.in_pitch,
                out_pitch=lay.out_pitch)


def bandwidth_fields(nbytes, ms, peak_bw):
    """GB/s that ``nbytes`` moved in ``ms``, and its share of HBM's."""
    return dict(gbps=nbytes / ms / 1e6, hbm_share=nbytes / ms * 1e3 / peak_bw)


def check_equal(kernel, got, want, max_err, what):
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    max_err[kernel] = max(max_err.get(kernel, 0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel} differs from its plain version at "
                             f"{what}: max |diff| {err}")


def phase_v3_kernels(max_err):
    """K4, int8_conv_requant and K5 == their plain versions (phase 2b)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.kernels import int8_gemm as G

    gen = torch.Generator(device="cuda").manual_seed(3)
    res, convs = v3_shapes()
    n = 0
    shapes = [(V3_BATCH_CHECK, h, c, cmid) for h, c, cmid in res]
    for bsz, h, c, cmid in shapes + RES_EDGE_SHAPES:
        args = res_case(gen, bsz, h, c, cmid)
        packed = K.pack_res_block_weights(args[1], args[3])
        for i, (leaky, rounding, case, sa_res, form) in enumerate((
                (0.1, "nearest", "plain", 3, "hwio"),
                (0.1, "nearest", "plain", 3, "packed"),
                (0.1, "floor", "plain", 3, "packed"),
                (True, "nearest", "plain", 3, "hwio"),
                (0.1, "nearest", "plain", None, "packed"),
                (0.1, "nearest", "acc_shift>=32", 3, "hwio"),
                (0.1, "floor", "out_shift<0", 3, "packed"))):
            p1, p2 = res_kw(c, cmid, case)
            kw = dict(sa_res=sa_res, leaky=leaky, rounding=rounding)
            if form == "packed":
                got = K.int8_res_block(args[0], None, args[2], p1, None,
                                       args[4], p2, packed=packed, **kw)
            else:
                got = K.int8_res_block(*args[:3], p1, *args[3:], p2, **kw)
            torch.cuda.synchronize()
            want = K.int8_res_block_plain(*args[:3], p1, *args[3:], p2,
                                          **kw)
            check_equal("int8_res_block", got, want, max_err,
                        f"{h}x{h} C{c} {leaky} {rounding} {case} {sa_res} "
                        f"{form}")
            if i == 0:
                std = float(got.float().std())
            n += 1
        emit("v3_kernels_vs_plain", kernel="int8_res_block",
             shape=[bsz, h, h, c, cmid],
             tile=list(K.res_block_layout(h, h, c, cmid)[:2]), equal=True,
             out_std=round(std, 3))
    for key in convs:
        xs, w, bias = conv_case(gen, V3_BATCH_CHECK, key)
        cases = [("nearest", "plain", True), ("floor", "plain", True),
                 ("nearest", "acc_shift>=32", True)]
        if len(xs) == 2:
            cases.append(("nearest", "plain", False))  # equal part scales
        if key[1] == 2 or key[0] == 1:  # the other epilogues
            cases += [("floor", "out_shift<0", True),
                      ("nearest", "leaky_off", True)]
        if key[0] == 1:  # the darknet slope on the 1x1 kernel
            cases.append(("floor", "slope_0.1", True))
        for rounding, case, split in cases:
            kw = conv_kw(key, case, rounding)
            x = conv_input(xs, kw, split)
            K.reset_launch_counts()
            got = K.int8_conv_requant(x, w, bias, **kw)
            torch.cuda.synchronize()
            line = ran_line()
            want = K.int8_conv_requant_plain(x, w, bias, **kw)
            check_equal(line, got, want, max_err,
                        f"{key} {rounding} {case} split={split}")
            if key[0] == 1:
                # the mma.sync conv kernel these convs ran on before
                check_equal("int8_conv_requant.mma_sync",
                            mma_sync_conv(x, w, bias, kw), want, max_err,
                            f"{key} {rounding} {case} split={split}")
                n += 1
            if case == "plain" and rounding == "nearest" and split:
                std = float(got.float().std())
            n += 1
        emit("v3_kernels_vs_plain", kernel=line,
             shape=[V3_BATCH_CHECK, *key[:5], key[5]], leaky=key[6],
             equal=True, out_std=round(std, 3))
    for bsz, h, c_in, c_out in CONV3X3_EDGE_SHAPES:
        x = ri(gen, (bsz, h, h, c_in), -128, 128, torch.int8)
        w = ri(gen, (3, 3, c_in, c_out), -90, 120, torch.int8)
        bias = ri(gen, (c_out,), -100, 100, torch.int32)
        packed = K.pack_conv3x3_weights(w)
        for wrapper, rounding, case, form in (
                ("int8_conv3x3_requant", "nearest", "plain", "hwio"),
                ("int8_conv3x3_requant", "floor", "out_shift<0", "packed"),
                ("int8_conv_requant", "nearest", "acc_shift>=32", "packed"),
                ("int8_conv_requant", "floor", "plain", "hwio")):
            kw = dict(shifts(c_in, case), leaky=True, rounding=rounding)
            if wrapper == "int8_conv_requant":
                kw.update(padding=1, stride=1)
            fn = getattr(K, wrapper)
            K.reset_launch_counts()
            got = (fn(x, None, bias, packed=packed, **kw) if form == "packed"
                   else fn(x, w, bias, **kw))
            torch.cuda.synchronize()
            want = getattr(K, wrapper + "_plain")(x, w, bias, **kw)
            check_equal(ran_line(), got, want, max_err,
                        f"{wrapper} {h}x{h} {c_in}->{c_out} {rounding} "
                        f"{case} {form}")
            n += 1
        emit("v3_kernels_vs_plain", kernel="conv3x3_wgmma edge tiles",
             shape=[bsz, h, h, c_in, c_out],
             tile=list(K.conv3x3_wgmma_layout(h, h, c_in, c_out)[:2]),
             equal=True)
    for bsz, h, c_in, c_out in S2_EDGE_SHAPES:
        x = ri(gen, (bsz, h, h, c_in), -128, 128, torch.int8)
        w = ri(gen, (3, 3, c_in, c_out), -90, 120, torch.int8)
        bias = ri(gen, (c_out,), -100, 100, torch.int32)
        packed = K.pack_conv3x3_weights(w)
        for rounding, case, form, leaky in (
                ("nearest", "plain", "hwio", 0.1),
                ("floor", "out_shift<0", "packed", 0.1),
                ("nearest", "acc_shift>=32", "packed", True),
                ("floor", "plain", "hwio", False)):
            kw = dict(shifts(c_in, case), leaky=leaky, rounding=rounding,
                      padding=1, stride=2)
            K.reset_launch_counts()
            got = (K.int8_conv_requant(x, None, bias, packed=packed, **kw)
                   if form == "packed" else
                   K.int8_conv_requant(x, w, bias, **kw))
            torch.cuda.synchronize()
            want = K.int8_conv_requant_plain(x, w, bias, **kw)
            check_equal(ran_line(), got, want, max_err,
                        f"stride 2 {h}x{h} {c_in}->{c_out} {rounding} "
                        f"{case} {form} {leaky}")
            n += 1
        lay = K.conv3x3_s2_wgmma_layout(h, h, c_in, c_out)
        emit("v3_kernels_vs_plain", kernel="conv3x3_s2_wgmma edge tiles",
             shape=[bsz, h, h, c_in, c_out],
             tile=[lay.tile_h, lay.tile_w],
             halo_channels=lay.halo_channels, equal=True)
    for bsz, h, w, cins, c_out in CONV1X1_EDGE_SHAPES:
        xs = [ri(gen, (bsz, h, w, c), -128, 128, torch.int8) for c in cins]
        wt = ri(gen, (1, 1, sum(cins), c_out), -90, 120, torch.int8)
        bias = ri(gen, (c_out,), -100, 100, torch.int32)
        packed = K.pack_conv1x1_weights(wt)
        for (rounding, case, form, leaky), split in zip(
                THIN_CASES + (("nearest", "plain", "packed", True),),
                (True, False, True, False, True)):
            kw = dict(v3_tables(sum(cins), case), leaky=leaky,
                      rounding=rounding)
            x = conv_input(xs, kw, split)
            K.reset_launch_counts()
            got = (K.int8_conv_requant(x, None, bias, packed=packed, **kw)
                   if form == "packed" else
                   K.int8_conv_requant(x, wt, bias, **kw))
            torch.cuda.synchronize()
            check_equal(ran_line(), got,
                        K.int8_conv_requant_plain(x, wt, bias, **kw),
                        max_err, f"1x1 {h}x{w} {cins}->{c_out} {rounding} "
                                 f"{case} {form} {leaky} split={split}")
            n += 1
        lay = K.conv1x1_wgmma_layout(bsz * h * w, cins[0],
                                     cins[1] if len(cins) == 2 else 0, c_out,
                                     len(cins) == 2)
        emit("v3_kernels_vs_plain", kernel="conv1x1_wgmma edge shapes",
             shape=[bsz, h, w, list(cins), c_out], bn=lay.bn,
             grid=lay.grid, equal=True)
    for bsz, h, w, c_in, c_out in ENTRY_EDGE_SHAPES:
        x, wt, bias = rand_case(gen, bsz, h, w, c_in, c_out)
        packed = K.pack_entry_conv_weights(wt)
        for rounding, case, form, leaky in THIN_CASES:
            kw = dict(shifts(c_in, case), leaky=leaky, rounding=rounding,
                      padding=1, stride=1)
            K.reset_launch_counts()
            got = (K.int8_conv_requant(x, None, bias, packed=packed, **kw)
                   if form == "packed" else
                   K.int8_conv_requant(x, wt, bias, **kw))
            torch.cuda.synchronize()
            check_equal(ran_line(), got,
                        K.int8_conv_requant_plain(x, wt, bias, **kw),
                        max_err, f"entry conv {h}x{w} {c_in}->{c_out} "
                                 f"{rounding} {case} {form} {leaky}")
            n += 1
        lay = K.entry_conv3x3_layout(h, w, c_in, c_out)
        emit("v3_kernels_vs_plain", kernel="entry_conv3x3_wgmma edge shapes",
             shape=[bsz, h, w, c_in, c_out], tile=[lay.tile_h, lay.tile_w],
             equal=True)
    for m, k, nn in GEMM_SHAPES:
        a = ri(gen, (m, k), -128, 128, torch.int8)
        b = ri(gen, (k, nn), -128, 128, torch.int8)
        want = G.int8_gemm_plain(a, b)
        for layout, bb in (("kn", b), ("k_major", b.t().contiguous().t())):
            got = G.int8_gemm(a, bb)
            torch.cuda.synchronize()
            check_equal("int8_gemm", got, want, max_err,
                        f"M, K, N = {m}, {k}, {nn}, b {layout}")
            n += 1
        emit("v3_kernels_vs_plain", kernel="int8_gemm", shape=[m, k, nn],
             layouts=["kn", "k_major"], equal=True)
    emit("v3_kernels_vs_plain_done", cases=n, max_abs_err=max_err)


def phase_v3_golden():
    """yolo_v3 golden 416² fixture: heads bit-exact, detections (3b)."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_seed

    path = (Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
            / "yolo_v3_int8_416_golden.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    m = int8_yolo_v3_from_seed(g, device="cuda")
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = np.random.default_rng(int(g["image_seed"])).random(
        (g["head_q_1"].shape[0], SIZE, SIZE, 3), dtype=np.float32)
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa_in)
    heads = tv3.int8_yolo_v3_forward(m, x_q)
    for i, (head, sa) in enumerate(zip(heads, m.tap_sa[::-1][:3])):
        head_q = torch.round(head * 2.0 ** sa).to(torch.int8).cpu()
        want = torch.as_tensor(g[f"head_q_{i + 1}"])
        if not torch.equal(head_q, want):
            diff = (head_q.int() - want.int()).abs()
            raise AssertionError(
                f"v3 golden head {i + 1} differs: max |diff| "
                f"{int(diff.max())}, {int((diff > 0).sum())} values")
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda"))
    boxes, scores, classes, valid = (t.cpu().numpy() for t in detect(x_q))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    emit("v3_golden", images=int(x_q.shape[0]), heads_bit_exact=True,
         classes_valid_exact=True,
         boxes_max_abs_diff=float(np.abs(boxes - g["boxes"]).max()),
         scores_max_abs_diff=float(np.abs(scores - g["scores"]).max()),
         valid_slots=int(valid.sum()))
    return m, cfg


def phase_v3_serving(m, cfg, card):
    """Batch-128 yolo_v3 serving through the detect fn (phase 4b)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.rand((V3_BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                        device="cuda")
    x_q = fp.quantize_input(images, m.sa_in).contiguous()
    del images
    resets = (K.reset_res_block_pack_count, K.reset_conv3x3_pack_count,
              K.reset_entry_conv_pack_count, K.reset_conv1x1_pack_count)
    for reset in resets:
        reset()
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda"))
    packs_at_setup = K.res_block_pack_count()
    conv_packs_at_setup = K.conv3x3_pack_count()
    entry_packs_at_setup = K.entry_conv_pack_count()
    conv1x1_packs_at_setup = K.conv1x1_pack_count()
    if (packs_at_setup, conv_packs_at_setup, entry_packs_at_setup,
            conv1x1_packs_at_setup) != (23, 14, 1, 14):
        raise AssertionError(f"the detect fn packed {packs_at_setup} "
                             f"residual blocks, {conv_packs_at_setup} "
                             f"3x3 convs, {entry_packs_at_setup} entry "
                             f"convs and {conv1x1_packs_at_setup} 1x1 "
                             f"convs, want 23, 14, 1 and 14")
    for _ in range(SERVE_WARMUP):
        detect(x_q)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for reset in resets:
        reset()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        out = detect(x_q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    if (K.res_block_pack_count() or K.conv3x3_pack_count()
            or K.entry_conv_pack_count() or K.conv1x1_pack_count()):
        raise AssertionError(f"serving packed K4 weights "
                             f"{K.res_block_pack_count()} times, 3x3 conv "
                             f"weights {K.conv3x3_pack_count()} times, the "
                             f"entry conv's {K.entry_conv_pack_count()}, "
                             f"1x1 conv weights {K.conv1x1_pack_count()}")
    want = dict.fromkeys(K.KERNEL_NAMES, 0)
    want.update({"int8_res_block": 23 * SERVE_ITERS,
                 "int8_conv_requant": 29 * SERVE_ITERS,
                 "greedy_nms_keep": SERVE_ITERS})
    if counts != want:
        raise AssertionError(f"v3 launch counts {counts}, want {want}")
    entries = K.launch_counts_by_entry()
    # none on the mma.sync conv (yolo_int8_conv_requant): an entry without
    # a launch is left out
    want_routes = {WGMMA3: 9 * SERVE_ITERS, S2_3: 5 * SERVE_ITERS,
                   ENTRY3: SERVE_ITERS, CONV1X1: 14 * SERVE_ITERS}
    if entries["int8_conv_requant"] != want_routes:
        raise AssertionError(f"int8_conv_requant launched "
                             f"{entries['int8_conv_requant']}, want "
                             f"{want_routes}")
    boxes, scores, classes, valid = out
    if (tuple(boxes.shape) != (V3_BATCH_SERVE, cfg.top_k, 4)
            or not torch.isfinite(boxes).all()
            or not torch.isfinite(scores).all()):
        raise AssertionError("v3 serving output has the wrong shape or is "
                             "not finite")
    m_packed = m.to("cuda")  # the weights the detect fn serves
    m_packed.pack_res_blocks()
    m_packed.pack_conv3x3s()
    head_ms = time_ms(lambda: tv3.int8_yolo_v3_forward(m_packed, x_q), 5)
    emit("v3_serving", batch=V3_BATCH_SERVE, iters=SERVE_ITERS,
         images_per_sec=V3_BATCH_SERVE * SERVE_ITERS / dt,
         ms_per_batch=1e3 * dt / SERVE_ITERS, backbone_ms_per_batch=head_ms,
         launches=counts, launches_by_entry=entries,
         res_block_packs_at_setup=packs_at_setup,
         conv3x3_packs_at_setup=conv_packs_at_setup,
         entry_conv_packs_at_setup=entry_packs_at_setup,
         conv1x1_packs_at_setup=conv1x1_packs_at_setup, packs_in_loop=0,
         card=card)
    return entries


def fp16_conv_ms(b, h, c_in, c_out, k, stride, pad):
    xh = torch.randn((b, c_in, h, h), device="cuda", dtype=torch.float16
                     ).contiguous(memory_format=torch.channels_last)
    wh = torch.randn((c_out, c_in, k, k), device="cuda", dtype=torch.float16
                     ).contiguous(memory_format=torch.channels_last)
    return time_ms(lambda: torch.nn.functional.conv2d(
        xh, wh, stride=stride, padding=pad), 10)


def int_mm_ms(m, k, n):
    """torch._int_mm of int8 [m, k] x [k, n], or None where it refuses
    the shape (it needs m > 16 and k, n multiples of 8)."""
    if m <= 16 or k % 8 or n % 8:
        return None
    a = torch.ones((m, k), dtype=torch.int8, device="cuda")
    b = torch.ones((n, k), dtype=torch.int8, device="cuda").t()
    return time_ms(lambda: torch._int_mm(a, b), 10)


def res_block_fill(args, p1, p2, kw):
    """K4 at 13^2 C 1024 runs one block per image and one per SM (y1 takes
    119 KB), so batch 128 leaves 4 of the H100's 132 SMs idle. Time it at
    batch 128, at one block per SM and at two: what filling the idle SMs
    could gain is at most the time of the step from 128 to 132 blocks."""
    from yolo_tpu_torch.kernels import int8_conv as K

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = args[0]
    times = {}
    for bsz in (x.shape[0], sms, 2 * sms):
        xb = x[torch.arange(bsz, device=x.device) % x.shape[0]].contiguous()
        times[bsz] = time_ms(lambda: K.int8_res_block(
            xb, *args[1:3], p1, *args[3:], p2, **kw), 10)
    emit("v3_res_block_fill", shape=list(x.shape[1:]), sms=sms,
         blocks_per_image=1, ms_by_batch=times,
         ms_per_image_by_batch={b: t / b for b, t in times.items()})


def phase_v3_times(card_name, max_err):
    """Each distinct v3 shape at batch 128 (K4, int8_conv_requant) and the
    K5 probe at 8192^3: kernel == plain version, then kernel, plain
    version and a library yardstick timed, with the bound (phase 4b)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.kernels import int8_gemm as G

    peak_ops, peak_bw = peaks(card_name)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = V3_BATCH_SERVE
    res, convs = v3_shapes()
    per_kernel = {}

    def record(kernel, count, what, ms, plain_ms, lib_ms, ops, nbytes,
               **extra):
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        emit("v3_shape_time", kernel=kernel, shape=what, per_forward=count,
             equal=True, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9, **extra)
        add_time(per_kernel, kernel, count, ms, plain_ms, lib_ms, t_ops,
                 t_bytes, extra.get("mma_sync_ms"))

    for (h, c, cmid), count in res.items():
        lay = K.res_block_layout(h, h, c, cmid)
        share1, share3 = K.res_block_row_shares(lay.tile_h, lay.tile_w,
                                                lay.halo_rows_per_box)
        emit("v3_res_block_tile", shape=[h, h, c, cmid],
             rows_used_1x1=share1, rows_used_3x3=share3, **lay._asdict())
        if min(share1, share3) < 0.85:
            raise AssertionError(f"K4 at {h}x{h} uses {share1:.3f} / "
                                 f"{share3:.3f} of its rows")
        args = res_case(gen, b, h, c, cmid)
        packed = K.pack_res_block_weights(args[1], args[3])
        p1, p2 = res_kw(c, cmid, "plain")
        kw = dict(sa_res=3, leaky=0.1, packed=packed)
        check_equal("int8_res_block",
                    K.int8_res_block(*args[:3], p1, *args[3:], p2, **kw),
                    K.int8_res_block_plain(*args[:3], p1, *args[3:], p2,
                                           **kw),
                    max_err, f"{h}x{h} C{c}, batch {b}")
        ms = time_ms(lambda: K.int8_res_block(*args[:3], p1, *args[3:], p2,
                                              **kw), 10)
        plain_ms = time_ms(lambda: K.int8_res_block_plain(
            *args[:3], p1, *args[3:], p2, **kw), 2, warmup=1)
        del packed
        lib_ms = (fp16_conv_ms(b, h, c, cmid, 1, 1, 0)
                  + fp16_conv_ms(b, h, cmid, c, 3, 1, 1))
        record("int8_res_block", count, [b, h, h, c, cmid], ms, plain_ms,
               lib_ms, 2 * b * h * h * 10 * c * cmid,
               2 * b * h * h * c + 10 * c * cmid + 4 * (c + cmid))
        if h == 13:
            res_block_fill(args, p1, p2, kw)
        del args
        torch.cuda.empty_cache()
    for key, count in convs.items():
        k, stride, pad, cins, cout, h, leaky = key
        xs, w, bias = conv_case(gen, b, key)
        kw = conv_kw(key)
        x = conv_input(xs, kw)
        extra, packed, layout = {}, None, None
        shape = (k, stride, pad, len(cins), cins[0], kw["sw"])
        if K.conv1x1_wgmma_route(*shape[:4], cins, kw["sw"]):
            layout = K.conv1x1_wgmma_layout
        elif K.conv3x3_wgmma_route(*shape):
            layout = K.conv3x3_wgmma_layout
        elif K.conv3x3_s2_wgmma_route(*shape):
            layout = K.conv3x3_s2_wgmma_layout
        elif K.entry_conv3x3_route(*shape[:5], cout, kw["sw"]):
            layout = K.entry_conv3x3_layout
        if layout is K.entry_conv3x3_layout:  # as serving reads them
            packed = K.pack_entry_conv_weights(w)
        elif layout is K.conv1x1_wgmma_layout:
            packed = K.pack_conv1x1_weights(w)
        elif layout is not None:
            packed = K.pack_conv3x3_weights(w)
        K.reset_launch_counts()
        got = K.int8_conv_requant(x, w, bias, packed=packed, **kw)
        line = ran_line()
        want = K.int8_conv_requant_plain(x, w, bias, **kw)
        check_equal(line, got, want, max_err, f"{key}, batch {b}")
        if packed is not None:
            # the mma.sync conv kernel these convs ran on before
            mma = lambda: mma_sync_conv(x, w, bias, kw)  # noqa: E731
            check_equal("int8_conv_requant.mma_sync", mma(), want, max_err,
                        f"{key}, batch {b}")
            if layout is K.conv1x1_wgmma_layout:
                lay = layout(b * h * h, cins[0],
                             cins[1] if len(cins) == 2 else 0, cout,
                             len(cins) == 2)
                extra = dict(bn=lay.bn, ring_stages=lay.ring_stages,
                             blocks_per_sm=lay.blocks_per_sm,
                             grid=lay.grid, n_tiles=lay.n_tiles,
                             weight_bytes=lay.weight_bytes)
            elif layout is K.entry_conv3x3_layout:
                extra = row_layout_fields(layout(h, h, cins[0], cout))
            else:
                extra = layout_fields(layout(h, h, cins[0], cout))
            extra["mma_sync_ms"] = time_ms(mma, 10)
        del got, want
        ms = time_ms(lambda: K.int8_conv_requant(x, w, bias, packed=packed,
                                                 **kw), 10)
        plain_ms = time_ms(lambda: K.int8_conv_requant_plain(x, w, bias,
                                                             **kw),
                           2, warmup=1)
        ho = (h + 2 * pad - k) // stride + 1
        nbytes = (b * h * h * sum(cins) + w.numel() + 4 * cout
                  + b * ho * ho * cout)
        if layout in (K.conv3x3_s2_wgmma_layout, K.entry_conv3x3_layout,
                      K.conv1x1_wgmma_layout):
            extra.update(bandwidth_fields(nbytes, ms, peak_bw))
        lib_ms = None
        if k == 1 and stride == 1 and pad == 0:
            lib_ms = int_mm_ms(b * h * h, sum(cins), cout)
        if lib_ms is None:
            lib_ms = fp16_conv_ms(b, h, sum(cins), cout, k, stride, pad)
        ops = 2 * b * ho * ho * k * k * sum(cins) * cout
        record(line, count, [b, h, h, list(cins), cout, k, stride, pad], ms,
               plain_ms, lib_ms, ops, nbytes, **extra)
        if layout is K.conv1x1_wgmma_layout:
            # the mma.sync conv's line: the same 1x1s, timed on it
            add_time(per_kernel, "int8_conv_requant.mma_sync", count,
                     extra["mma_sync_ms"], plain_ms, lib_ms,
                     1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw)
        del xs, x, w, bias, packed
        torch.cuda.empty_cache()
    m, k, n = GEMM_PROBE
    a = ri(gen, (m, k), -128, 128, torch.int8)
    # b K-major (column-major [K, N]): the layout both the kernel and
    # torch._int_mm read, so neither copies
    bb = ri(gen, (n, k), -128, 128, torch.int8).t()
    check_equal("int8_gemm", G.int8_gemm(a, bb), G.int8_gemm_plain(a, bb),
                max_err, f"M, K, N = {m}, {k}, {n}")
    ms = time_ms(lambda: G.int8_gemm(a, bb), 10)
    plain_ms = time_ms(lambda: G.int8_gemm_plain(a, bb), 2, warmup=1)
    lib_ms = time_ms(lambda: torch._int_mm(a, bb), 10)
    record("int8_gemm", 1, [m, k, n], ms, plain_ms, lib_ms, 2 * m * k * n,
           m * k + k * n + 4 * m * n)
    return per_kernel


# ---------------------------------------------------------------------------
# slim_yolo_v2 with per-channel weight scales (phases 2c-4c)
# ---------------------------------------------------------------------------


def nhwc_layers():
    """(name, H at the layer's input, c_in, c_out, pool, wrapper form) on
    the per-channel path, NHWC input: conv1 too is a pooled
    ``int8_conv3x3_im2col`` (the NHWC form of K2's wgmma kernel, C_in
    3)."""
    return [(name, h, c_in, c_out, pool,
             "im2col_pool" if pool else "requant")
            for name, h, c_in, c_out, pool, _ in slim_layers()]


def pc_shifts(gen, c_in, c_out, case):
    """Shifts of a per-column case: sw an int32 [C_out] array whose
    accumulator shifts spread +-2 around ``shifts``' (>= 3 distinct
    values), with ``case``:

    - "mixed": one column at -1 (a left shift), one at 33 and one at -40
      (outside the short form), one at 31 (0 under nearest);
    - "short": all in [0, 30] (the short shift form);
    - "count": 4 lower (left shifts where that is below 0), so that
      many values pass int16 (counting);
    - "count_scalar": a scalar sw 4 lower (the counting form's table of
      one shift)."""
    kw = shifts(c_in, "plain")
    base = kw["sw"] + kw["sa_in"] - kw["retune"]  # the accumulator shift
    if case == "count_scalar":
        kw["sw"] -= 4
        return kw
    s = base + torch.randint(-2, 3, (c_out,), generator=gen).numpy()
    if case == "count":
        s = s - 4
    if case == "mixed":
        s[: 4] = [-1, 33, 31, -40][: c_out]
    if case == "short":
        s = np.clip(s, 0, 30)
    kw["sw"] = (s - kw["sa_in"] + kw["retune"]).astype(np.int32)
    assert len(np.unique(kw["sw"])) >= 3
    return kw


PC_CASES = ("mixed", "short", "count", "count_scalar")


def packed_for(w, c_in):
    """A layer's weights as the serving model packs them: conv1's (C_in
    <= 4) for the NHWC form of K2's kernel, the others' for the wgmma
    conv3x3."""
    from yolo_tpu_torch.kernels import int8_conv as K

    return (K.pack_pool_nhwc_weights(w) if c_in <= 4
            else K.pack_conv3x3_weights(w))


def pc_case(form, x, w, bias, c_in, kw, packed, max_err, case, where):
    """One per-column or counting case (``kw`` from ``pc_shifts(...,
    case)``): the kernel from packed weights == its plain version, and
    counting, the counts equal and nonzero; returns (the kernels-line
    name, the count or None)."""
    from yolo_tpu_torch.kernels import int8_conv as K

    counting, what = case.startswith("count"), f"{where} {case}"
    got_n = (torch.zeros(1, dtype=torch.int32, device="cuda")
             if counting else None)
    want_n = torch.zeros_like(got_n) if counting else None
    K.reset_launch_counts()
    got = call(form, x, None, bias, c_in, dict(kw, overflow=got_n), packed)
    torch.cuda.synchronize()
    k = ran_line()
    want = plain(form, x, w, bias, c_in, dict(kw, overflow=want_n))
    check_equal(k, got, want, max_err, what)
    if not counting:
        return k, None
    if int(got_n) != int(want_n) or int(want_n) == 0:
        raise AssertionError(f"{k} counted {int(got_n)} overflows at {what}, "
                             f"its plain version {int(want_n)} (want equal "
                             f"and nonzero)")
    return k, int(got_n)


def phase_pc_kernels(max_err):
    """The per-column and counting forms == their plain versions at slim's
    NHWC layer shapes (phase 2c): K1's six widths (pred's 35 columns
    included) and K3's three on the wgmma conv3x3, conv1 (C_in 3) on the
    NHWC form of K2's wgmma kernel, both roundings, per-channel sw with >=
    3 distinct values, a negative shift, shifts >= 31 and a scalar sw
    counted; each count equal to the plain version's, and nonzero. Then
    the NHWC form of K2's kernel at edge shapes, in its scalar form
    (every shift form, both roundings, leaky on and off, from HWIO and
    from packed weights) and its per-column and counting forms."""
    from yolo_tpu_torch.kernels import int8_conv as K

    gen = torch.Generator().manual_seed(5)
    n = 0
    for name, h, c_in, c_out, pool, form in nhwc_layers():
        x, w, bias = make_case(gen, BATCH_CHECK, h, c_in, c_out, s2d=False)
        packed = packed_for(w, c_in)
        counts = []
        for rounding in ("nearest", "floor"):
            for case in PC_CASES:
                kw = dict(pc_shifts(gen, c_in, c_out, case),
                          leaky=name != "pred", rounding=rounding)
                k, count = pc_case(form, x, w, bias, c_in, kw, packed,
                                   max_err, case, f"{name} {rounding}")
                if count is not None:
                    counts.append(count)
                n += 1
        emit("pc_kernels_vs_plain", layer=name, form=form, kernel=k,
             shape=[BATCH_CHECK, h, h, c_in, c_out], equal=True,
             overflow_counts=counts)
    for bsz, h, w, c_in, c_out in POOL_NHWC_EDGE_SHAPES:
        x, wt, bias = rand_case(gen, bsz, h, w, c_in, c_out)
        packed = K.pack_pool_nhwc_weights(wt)
        for rounding, case, form, leaky in THIN_CASES:
            kw = dict(shifts(c_in, case), leaky=bool(leaky),
                      rounding=rounding)
            K.reset_launch_counts()
            got = (call("im2col_pool", x, None, bias, c_in, kw, packed)
                   if form == "packed" else
                   call("im2col_pool", x, wt, bias, c_in, kw))
            torch.cuda.synchronize()
            check_equal(ran_line(), got,
                        plain("im2col_pool", x, wt, bias, c_in, kw), max_err,
                        f"NHWC pooled {h}x{w} {c_in}->{c_out} {rounding} "
                        f"{case} {form} {leaky}")
            n += 1
        for i, case in enumerate(PC_CASES):
            for rounding in ("nearest", "floor"):
                kw = dict(pc_shifts(gen, c_in, c_out, case),
                          leaky=i % 2 == 0, rounding=rounding)
                pc_case("im2col_pool", x, wt, bias, c_in, kw, packed,
                        max_err, case, f"NHWC pooled {h}x{w} {c_in}->"
                                       f"{c_out} {rounding}")
                n += 1
        lay = K.pool_nhwc_wgmma_layout(h, w, c_in, c_out)
        emit("pc_kernels_vs_plain", kernel="pooled NHWC wgmma edge shapes",
             shape=[bsz, h, w, c_in, c_out], tile=[lay.tile_h, lay.tile_w],
             equal=True)
    emit("pc_kernels_vs_plain_done", cases=n)


# the two-part form's shift cases: ``shifts``' scalar ones and
# ``pc_shifts``' per-column ones (one table where the parts' scales agree,
# two where they differ)
PARTS_CASES = ("plain", "acc_shift>=32", "out_shift<0", "mixed", "short")
PARTS_LINES = ("int8_conv_requant.conv3x3_parts_wgmma",
               "int8_conv_requant.conv3x3_parts_cols_wgmma")


def parts_kw(gen, cins, c_out, case, unequal):
    """(shifts of a two-part case, the parts' scales): part 1 one scale
    below part 0 where ``unequal`` (two accumulator shifts: the split)."""
    c_in = sum(cins)
    kw = (pc_shifts(gen, c_in, c_out, case) if case in ("mixed", "short")
          else shifts(c_in, case))
    sa0 = kw.pop("sa_in")
    return kw, (sa0, sa0 - 1 if unequal else sa0)


def parts_case(x, cins, w, wp, bias, kw, max_err, what):
    """One two-part conv from the packed weights, as the forward calls it,
    == its plain version; -> (its kernels-line name, the share of its
    outputs at the most common value)."""
    from yolo_tpu_torch.kernels import int8_conv as K

    parts = [(t.contiguous(), sa) for t, sa in
             zip((x[..., :cins[0]], x[..., cins[0]:]), kw["sas"])]
    kw = {k: v for k, v in kw.items() if k != "sas"}
    K.reset_launch_counts()
    got = K.int8_conv_requant(parts, None, bias, packed=wp, sa_in=None,
                              padding=1, **kw)
    torch.cuda.synchronize()
    line = ran_line()
    if line not in PARTS_LINES:
        raise AssertionError(f"the two-part conv at {what} launched {line}")
    want = K.int8_conv_requant_plain(parts, w, bias, sa_in=None, padding=1,
                                     **kw)
    check_equal(line, got, want, max_err, what)
    top = float(torch.unique(want, return_counts=True)[1].max()
                / want.numel())
    if top == 1.0:
        raise AssertionError(f"{line} at {what}: every output one value")
    return line, top


def phase_parts_kernels(max_err):
    """The wgmma conv3x3's two-part form and tiny's conv_2 pooled call ==
    their plain versions (phase 2e): the two-part form at
    ``PARTS_SHAPES`` (odd 13² and 9², even 26², C_out 35, 64, 256 and
    1,024), both roundings, equal part scales (one accumulator) and
    unequal ones (the split: two), each shift case of ``PARTS_CASES``
    (scalar sw in the short and the general shift forms; per-column sw
    on one table or two, with shifts outside [0, 31] and all inside), the
    slopes 0.1, 0.125 and none, from the parts' packed weights; then the
    two served convs at their serving batch, scalar and per column; then
    conv_2's pooled call (3x3, 16 -> 32 with its 2x2 pool) at slope 0.1,
    scalar and per column, at 64², 100² and the served 208² at batch
    256."""
    from yolo_tpu_torch.kernels import int8_conv as K

    gen = torch.Generator().manual_seed(17)
    n = 0
    for bsz, h, cins, c_out in PARTS_SHAPES + PARTS_SERVED:
        served = (bsz, h, cins, c_out) in PARTS_SERVED
        x, w, bias = make_case(gen, bsz, h, sum(cins), c_out, s2d=False)
        wp = K.pack_conv3x3_parts_weights(w, cins)
        lines, tops = set(), []
        # at the serving batch: the served conv's scales (tiny's one,
        # yolo_v2's two), scalar and per column, nearest
        grid = ([("nearest", c_out == 1024, case) for case in
                 ("plain", "short")] if served else
                [(r, u, case) for r in ("nearest", "floor")
                 for u in (False, True) for case in PARTS_CASES])
        for i, (rounding, unequal, case) in enumerate(grid):
            kw, sas = parts_kw(gen, cins, c_out, case, unequal)
            kw.update(sas=sas, rounding=rounding,
                      leaky=(0.1, True, False)[i % 3] if not served
                      else 0.1 if c_out == 256 else True)
            line, top = parts_case(x, cins, w, wp, bias, kw, max_err,
                                   f"{bsz}x{h}² {list(cins)} -> {c_out} "
                                   f"{rounding} {case} sas {list(sas)}")
            lines.add(line)
            tops.append(top)
            n += 1
        emit("parts_kernels_vs_plain", shape=[bsz, h, h, list(cins), c_out],
             equal=True, cases=len(grid), lines=sorted(lines),
             top_value_share_max=max(tops),
             layouts={str(split): K.conv3x3_parts_wgmma_layout(
                 h, h, *cins, c_out, split)._asdict()
                 for split in (False, True)})
        del x, w, bias, wp
        torch.cuda.empty_cache()
    for bsz, h in ((2, 64), (2, 100), (BATCH_SERVE, 208)):
        x, w, bias = make_case(gen, bsz, h, 16, 32, s2d=False)
        packed = K.pack_conv3x3_weights(w)
        lines = set()
        for rounding in ("nearest", "floor") if bsz == 2 else ("nearest",):
            for case in ("plain", "mixed", "short"):
                kw = (shifts(16, case) if case == "plain"
                      else pc_shifts(gen, 16, 32, case))
                kw.update(leaky=0.1, rounding=rounding)
                K.reset_launch_counts()
                got = call("im2col_pool", x, None, bias, 16, kw, packed)
                torch.cuda.synchronize()
                line = ran_line()
                lines.add(line)
                check_equal(line, got, plain("im2col_pool", x, w, bias, 16,
                                             kw), max_err,
                            f"conv_2 pooled {bsz}x{h}² {rounding} {case}")
                n += 1
        emit("parts_kernels_vs_plain", conv="tiny conv_2 + pool, slope 0.1",
             shape=[bsz, h, h, 16, 32], equal=True, lines=sorted(lines))
        del x, w, bias
        torch.cuda.empty_cache()
    emit("parts_kernels_vs_plain_done", cases=n)


PC_FIXTURE = "slim_int8_pc_416_golden.npz"


def pc_variant(m, g, key):
    """The fixture's diagnostics model ``key``: ``m`` (overflow), its
    ``raised`` layers' retune + ``raised_by`` (overflow_raised), or every
    layer's + ``all_raised_by`` (overflow_all)."""
    from yolo_tpu_torch.quant import fixed_point as fp

    by = {"overflow": {},
          "overflow_raised": dict.fromkeys(map(str, g["raised"]),
                                           int(g["raised_by"])),
          "overflow_all": dict.fromkeys(m.retune, int(g["all_raised_by"]))
          }[key]
    return fp.Int8Model(m.w_q, m.b_q, m.sw, m.sb, m.sa,
                        {k: v + by.get(k, 0) for k, v in m.retune.items()})


def phase_pc_golden():
    """The per-channel golden 416² fixture (phase 3c): the head of 4 NHWC
    images bit-exact with the JAX package's, from packed weights and from
    HWIO ones; classes and valid exact, boxes and scores allclose (atol =
    rtol = 1e-5); ``int8_forward_diagnostics``' head equal to the forward's
    and its counts equal to the fixture's, for the calibrated model and
    its two raised-retune variants."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.convert import int8_model_from_seed
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
    from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES

    path = Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
    with np.load(path / PC_FIXTURE) as z:
        g = {k: z[k] for k in z.files}
    m = int8_model_from_seed(g, device="cuda")
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = np.random.default_rng(int(g["image_seed"])).random(
        (g["head_q"].shape[0], SIZE, SIZE, 3), dtype=np.float32)
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa["in"])
    want = torch.as_tensor(g["head_q"])
    counts = {}
    for key in ("overflow", "overflow_raised", "overflow_all"):
        mv = pc_variant(m, g, key).to("cuda")
        mv.pack_conv3x3()
        head, ov = fp.int8_forward_diagnostics(mv, x_q)
        if not torch.equal(head, fp.int8_forward(mv, x_q)):
            raise AssertionError(f"the diagnostics forward's head differs "
                                 f"from the forward's ({key})")
        got = np.asarray([int(ov[n]) for n in QUANT_LAYER_NAMES], np.int32)
        if not np.array_equal(got, g[key]):
            raise AssertionError(f"per-channel golden {key} counts "
                                 f"{got.tolist()}, want {g[key].tolist()}")
        counts[key] = got.tolist()
        if key != "overflow":
            continue
        for what, mm in (("packed", mv), ("hwio", m)):
            head_q = torch.round(fp.int8_forward(mm, x_q)
                                 * 2.0 ** m.sa["pred"]).to(torch.int8).cpu()
            if not torch.equal(head_q, want):
                diff = (head_q.int() - want.int()).abs()
                raise AssertionError(
                    f"per-channel golden head ({what} weights) differs: max "
                    f"|diff| {int(diff.max())}, {int((diff > 0).sum())} "
                    f"values")
    detect = eager(make_int8_detect_fn(m, cfg, device="cuda"))
    boxes, scores, classes, valid = (t.cpu().numpy() for t in detect(x_q))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    emit("pc_golden", images=int(x_q.shape[0]), head_bit_exact=True,
         classes_valid_exact=True, overflow_counts_equal=counts,
         distinct_sw={n: int(len(np.unique(m.sw[n])))
                      for n in QUANT_LAYER_NAMES},
         boxes_max_abs_diff=float(np.abs(boxes - g["boxes"]).max()),
         scores_max_abs_diff=float(np.abs(scores - g["scores"]).max()),
         valid_slots=int(valid.sum()))
    return m, cfg


def phase_pc_serving(m, cfg, card):
    """Batch-256 per-channel serving through the detect fn on NHWC int8
    input, then ``int8_forward_diagnostics`` at the same batch (phase 4c):
    per forward 6 launches on the per-column stride-1 form, 3 on the
    per-column pooled form and 1 (conv1) on the per-column NHWC form of
    K2's wgmma kernel, none on the mma.sync conv, the weights and the
    shift tables made when the detect fn took the model, never in the
    loop; the diagnostics forward 6 / 3 / 1 on the counting forms, its
    head equal to the forward's."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.rand((BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                        device="cuda")
    x_q = fp.quantize_input(images, m.sa["in"]).contiguous()
    del images
    resets = (K.reset_conv3x3_pack_count, K.reset_pool_s2d_pack_count,
              K.reset_pool_nhwc_pack_count, K.reset_shift_table_count)

    def made():
        return (K.conv3x3_pack_count(), K.pool_s2d_pack_count(),
                K.pool_nhwc_pack_count(), K.shift_table_count())

    for reset in resets:
        reset()
    detect = eager(make_int8_detect_fn(m, cfg, device="cuda"))
    at_setup = made()
    if at_setup != (9, 0, 1, 20):
        raise AssertionError(f"the per-channel detect fn packed {at_setup[0]}"
                             f" conv3x3 layers, conv1 {at_setup[1]} times "
                             f"for K2 and {at_setup[2]} times for its NHWC "
                             f"form, and made {at_setup[3]} shift tables, "
                             f"want 9, 0, 1 and 20")
    for _ in range(SERVE_WARMUP):
        detect(x_q)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for reset in resets:
        reset()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        out = detect(x_q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    entries = K.launch_counts_by_entry()
    if made() != (0, 0, 0, 0):
        raise AssertionError(f"per-channel serving packed or made tables "
                             f"in the loop: {made()}")
    want = dict.fromkeys(K.KERNEL_NAMES, 0)
    want.update({"int8_conv3x3_requant": 6 * SERVE_ITERS,
                 "int8_conv3x3_im2col": 4 * SERVE_ITERS,
                 "greedy_nms_keep": SERVE_ITERS})
    want_entries = {"int8_conv3x3_requant": {COLS3: 6 * SERVE_ITERS},
                    "int8_conv3x3_im2col": {POOL_COLS3: 3 * SERVE_ITERS,
                                            POOL_NHWC_COLS: SERVE_ITERS},
                    **nms_launches(SERVE_ITERS)}
    if counts != want or entries != want_entries:
        raise AssertionError(f"per-channel launches {counts} "
                             f"{entries}, want {want} {want_entries}")
    boxes, scores, classes, valid = out
    if (tuple(boxes.shape) != (BATCH_SERVE, cfg.top_k, 4)
            or not torch.isfinite(boxes).all()
            or not torch.isfinite(scores).all()):
        raise AssertionError("per-channel serving output has the wrong "
                             "shape or is not finite")
    m_packed = m.to("cuda")
    m_packed.pack_conv3x3()  # the weights and tables the detect fn serves
    head_ms = time_ms(lambda: fp.int8_forward(m_packed, x_q), 5)
    # the diagnostics forward, timed as serving is, its launches checked
    fp.int8_forward_diagnostics(m_packed, x_q)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        head, ov = fp.int8_forward_diagnostics(m_packed, x_q)
    torch.cuda.synchronize()
    diag_dt = time.perf_counter() - t0
    diag_entries = K.launch_counts_by_entry()
    want_diag = {"int8_conv3x3_requant": {COUNT3: 6 * SERVE_ITERS},
                 "int8_conv3x3_im2col": {POOL_COUNT3: 3 * SERVE_ITERS,
                                         POOL_NHWC_COUNT: SERVE_ITERS}}
    if diag_entries != want_diag:
        raise AssertionError(f"diagnostics launched {diag_entries}, want "
                             f"{want_diag}")
    if not torch.equal(head, fp.int8_forward(m_packed, x_q)):
        raise AssertionError("the diagnostics head differs from the "
                             "forward's at batch 256")
    emit("pc_serving", batch=BATCH_SERVE, iters=SERVE_ITERS,
         images_per_sec=BATCH_SERVE * SERVE_ITERS / dt,
         ms_per_batch=1e3 * dt / SERVE_ITERS, backbone_ms_per_batch=head_ms,
         postprocess_ms=postprocess_ms(m_packed, x_q, cfg),
         diagnostics_ms_per_batch=1e3 * diag_dt / SERVE_ITERS,
         diagnostics_overflow={k: int(v) for k, v in ov.items()},
         launches=counts, launches_by_entry=entries,
         diagnostics_launches_by_entry=diag_entries,
         packs_tables_at_setup=list(at_setup), packs_in_loop=0, card=card)
    return entries, diag_entries


def phase_pc_layer_times(card_name, max_err):
    """Each per-channel layer at batch 256 (phase 4c, timing): its
    per-column, counting and scalar kernels each == its plain version
    (output and count), then timed, beside the plain versions and cuDNN's
    fp16 conv (one wrapper call each, CUDA events), and the bound; conv1
    (the NHWC form of K2's wgmma kernel) also on the mma.sync conv it ran
    on before (same process), with its layout."""
    from yolo_tpu_torch.kernels import int8_conv as K

    peak_ops, peak_bw = peaks(card_name)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator().manual_seed(7)
    per_kernel = {}
    for name, h, c_in, c_out, pool, form in nhwc_layers():
        x, w, bias = make_case(gen, BATCH_SERVE, h, c_in, c_out, s2d=False)
        packed = packed_for(w, c_in)
        kw = dict(pc_shifts(gen, c_in, c_out, "short"), leaky=name != "pred",
                  rounding="nearest")
        table = K.acc_shift_table(kw["sw"], kw["sa_in"], kw["retune"],
                                  "nearest", c_out, "cuda")
        n = torch.zeros(1, dtype=torch.int32, device="cuda")
        n_want = torch.zeros_like(n)
        fields, host, mma_ms = {}, {}, {}
        for what, plain_kw, kern_kw in (
                ("cols", kw, dict(kw, shifts=table)),
                ("count", dict(kw, overflow=n_want),
                 dict(kw, shifts=table, overflow=n)),
                ("scalar", dict(kw, sw=int(np.max(kw["sw"]))),
                 dict(kw, sw=int(np.max(kw["sw"]))))):
            K.reset_launch_counts()
            got = call(form, x, None, bias, c_in, kern_kw, packed)
            line = ran_line()
            want = plain(form, x, w, bias, c_in, plain_kw)
            check_equal(line, got, want, max_err,
                        f"{name} ({what}), batch {BATCH_SERVE}")
            if what == "count":
                if int(n) != int(n_want):
                    raise AssertionError(f"{line} counted {int(n)} at "
                                         f"{name}, its plain version "
                                         f"{int(n_want)}")
                overflow = int(n)
            if c_in <= 4:
                # the mma.sync conv conv1 ran on before, same shifts
                mma = lambda: K._launch(  # noqa: E731
                    "int8_conv3x3_im2col", x, w, bias, h=h, w=h, c_in=c_in,
                    pool=True, s2d=False, **kern_kw)
                check_equal(f"{line} (mma.sync)", mma(), want, max_err,
                            f"{name} ({what}), batch {BATCH_SERVE}")
                mma_ms[what] = time_ms(mma, 10)
            del got, want
            ms = time_ms(lambda: call(form, x, None, bias, c_in, kern_kw,
                                      packed), 10)
            host[what] = host_ms(lambda: call(form, x, None, bias, c_in,
                                              kern_kw, packed))
            plain_ms = time_ms(lambda: plain(form, x, w, bias, c_in,
                                             plain_kw), 2, warmup=1)
            fields[what] = (line, ms, plain_ms)
        xh = torch.randn((BATCH_SERVE, c_in, h, h), device="cuda",
                         dtype=torch.float16
                         ).contiguous(memory_format=torch.channels_last)
        wh = torch.randn((c_out, c_in, 3, 3), device="cuda",
                         dtype=torch.float16
                         ).contiguous(memory_format=torch.channels_last)
        lib_ms = time_ms(
            lambda: torch.nn.functional.conv2d(xh, wh, padding=1), 10)
        del xh, wh
        ho = h // 2 if pool else h
        ops = 2 * BATCH_SERVE * h * h * 9 * c_in * c_out
        nbytes = (x.numel() + w.numel() + 8 * c_out
                  + BATCH_SERVE * ho * ho * c_out)
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        (line, ms, plain_ms), (cline, cms, cplain_ms), (sline, sms, _) = (
            fields["cols"], fields["count"], fields["scalar"])
        extra = ({} if c_in > 4 else dict(
            mma_sync_ms=mma_ms, **row_layout_fields(
                K.pool_nhwc_wgmma_layout(h, h, c_in, c_out))))
        emit("pc_layer_time", layer=name, kernel=line, batch=BATCH_SERVE,
             equal=True, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             scalar_kernel=sline, scalar_ms=sms, count_kernel=cline,
             count_ms=cms, count_plain_ms=cplain_ms, overflow=overflow,
             host_ms=host, bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9, **bandwidth_fields(nbytes, ms, peak_bw),
             **extra)
        add_time(per_kernel, line, 1, ms, plain_ms, lib_ms, t_ops, t_bytes,
                 mma_ms.get("cols"))
        add_time(per_kernel, cline, 1, cms, cplain_ms, lib_ms, t_ops,
                 t_bytes, mma_ms.get("count"))
        if c_in <= 4:  # the other layers' scalar lines are phase 4's
            add_time(per_kernel, sline, 1, sms, fields["scalar"][2], lib_ms,
                     t_ops, t_bytes, mma_ms["scalar"])
        del x, w, bias, packed, table
        torch.cuda.empty_cache()
    return per_kernel

# ---------------------------------------------------------------------------
# yolo_v3 with per-channel weight scales (phase 2d)
# ---------------------------------------------------------------------------

PCV3_FIXTURE = "yolo_v3_int8_pc_416_golden.npz"
# each route's per-column C entry
PCV3_ENTRY = {"s1": COLS3, "s2": S2_COLS3, "entry": ENTRY_COLS3,
              "1x1": CONV1X1_COLS}
# the walk's int8 inputs: uniform over int8 (on the CPU, at 26² and below,
# the fixture's convs saturated 0-18% of their outputs on such inputs)
PCV3_INPUT = (-128, 128)


def pcv3_walk(m):
    """The per-channel v3 model's 29 convs outside the residual blocks and
    its 23 residual blocks, in program order: ([(conv index, route, k,
    stride, pad, parts ((C_in, sa), ...), C_out, H at the input, leaky,
    sa_out)], [(index of the block's 1x1 conv, its first tap, its input
    scale, H, C, C_mid, leaky)])."""
    prog = m.program
    out, blocks, slots = [], [], {}
    h, stream, parts, ci, ti, i = SIZE, (3, m.sa_in), None, 0, 0, 0
    while i < len(prog):
        op = prog[i]
        if op[0] == "push":  # a residual block: K4's two convs, three taps
            blocks.append((ci, ti, stream[1], h, stream[0],
                           m.w_q[ci].shape[3], prog[i + 1][4]))
            stream = (stream[0], m.tap_sa[ti + 2])
            ci, ti, i = ci + 2, ti + 3, i + 4
            continue
        if op[0] == "conv":
            k, cout = m.w_q[ci].shape[0], m.w_q[ci].shape[3]
            parts = parts or (stream,)
            route = ("1x1" if k == 1 else "entry" if parts[0][0] <= 3
                     else "s2" if op[2] == 2 else "s1")
            out.append((ci, route, k, op[2], op[3], parts, cout, h, op[4],
                        m.tap_sa[ti]))
            h = (h + 2 * op[3] - k) // op[2] + 1
            stream, parts = (cout, m.tap_sa[ti]), None
            ci, ti = ci + 1, ti + 1
        elif op[0] == "save":
            slots[op[1]] = (h, stream)
        elif op[0] == "load":
            h, stream = slots[op[1]]
        elif op[0] == "up":
            h *= 2
        elif op[0] == "concat":
            parts = (slots[op[1]][1], stream)
        i += 1
    return out, blocks


def pcv3_res_params(m, blk, with_res=True):
    """(p1, p2, keywords) of K4 on residual block ``blk`` of the model:
    its two convs' scales as the forward passes them."""
    ci, ti, sa, _, _, _, leaky = blk
    p1 = dict(sw=m.sw[ci], sb=m.sb[ci], sa_in=sa, sa_out=m.tap_sa[ti],
              retune=m.retune[ci])
    p2 = dict(sw=m.sw[ci + 1], sb=m.sb[ci + 1], sa_in=m.tap_sa[ti],
              sa_out=m.tap_sa[ti + 1], retune=m.retune[ci + 1])
    return p1, p2, dict(sa_res=m.tap_sa[ti + 2] if with_res else None,
                        leaky=leaky)


def pcv3_res_call(m, blk, x, rounding, with_res=True):
    """K4's per-column form on block ``blk`` from the model's packed
    weights and shift tables: the call a forward makes."""
    from yolo_tpu_torch.kernels import int8_conv as K

    ci = blk[0]
    p1, p2, kw = pcv3_res_params(m, blk, with_res)
    tables = m.shift_tables[rounding]
    return K.int8_res_block(x, None, m.b_q[ci], p1, None, m.b_q[ci + 1], p2,
                            rounding=rounding, packed=m.res_packed[ci],
                            shifts=(tables[ci][0], tables[ci + 1][0]), **kw)


def pcv3_res_plain(m, blk, x, rounding, with_res=True):
    from yolo_tpu_torch.kernels import int8_conv as K

    ci = blk[0]
    p1, p2, kw = pcv3_res_params(m, blk, with_res)
    return K.int8_res_block_plain(x, m.w_q[ci], m.b_q[ci], p1, m.w_q[ci + 1],
                                  m.b_q[ci + 1], p2, rounding=rounding, **kw)


def pcv3_res_case(m, blk, x, rounding, with_res, max_err, what):
    """One K4 per-column case: exactly one launch, on its per-column C
    entry (no shift table made in the call), equal to the plain version,
    its output neither all saturated nor all one value; returns the share
    of saturated outputs."""
    from yolo_tpu_torch.kernels import int8_conv as K

    before = dict(K.launch_counts_by_entry().get("int8_res_block", {}))
    tables_before = K.shift_table_count()
    got = pcv3_res_call(m, blk, x, rounding, with_res)
    torch.cuda.synchronize()
    after = K.launch_counts_by_entry().get("int8_res_block", {})
    new = {e: n - before.get(e, 0) for e, n in after.items()
           if n != before.get(e, 0)}
    if new != {RES_COLS: 1}:
        raise AssertionError(f"{what} launched {new}, want one launch of "
                             f"{RES_COLS}")
    if K.shift_table_count() != tables_before:
        raise AssertionError(f"{what} made a shift table in the call")
    check_equal("int8_res_block.cols", got,
                pcv3_res_plain(m, blk, x, rounding, with_res), max_err, what)
    sat = float(((got == 127) | (got == -128)).float().mean())
    if sat == 1.0 or int(got.min()) == int(got.max()):
        raise AssertionError(f"{what}: outputs all saturated or all one "
                             f"value (saturated share {sat})")
    return sat


def pcv3_stages(blocks):
    """The first residual block of each darknet53 stage shape (H, C,
    C_mid)."""
    stages = {}
    for blk in blocks:
        stages.setdefault(blk[3:6], blk)
    return list(stages.values())


def pcv3_inputs(gen, conv, sas=None, batch=V3_BATCH_SERVE):
    """Random int8 input of ``conv`` (its parts at their scales, or at
    ``sas``) and the ``int8_conv_requant`` keywords of the model's conv."""
    _, _, _, stride, pad, parts, _, h, leaky, sa_out = conv
    sas = list(sas or [sa for _, sa in parts])
    xs = [ri(gen, (batch, h, h, c), *PCV3_INPUT, torch.int8)
          for c, _ in parts]
    x = xs[0] if len(xs) == 1 else list(zip(xs, sas))
    return x, dict(sa_in=sas[0], sa_out=sa_out, padding=pad, stride=stride,
                   leaky=leaky)


def pcv3_call(m, conv, x, kw, rounding, tables=None):
    """The per-column kernel of ``conv`` from the model's packed weights
    and its shift tables (or ``tables``): the call a forward makes."""
    from yolo_tpu_torch.kernels import int8_conv as K

    ci = conv[0]
    return K.int8_conv_requant(
        x, None, m.b_q[ci], sw=m.sw[ci], sb=m.sb[ci], retune=m.retune[ci],
        rounding=rounding, packed=m.packed_weights(ci),
        shifts=m.shift_tables[rounding][ci] if tables is None else tables,
        **kw)


def pcv3_plain(m, conv, x, kw, rounding):
    from yolo_tpu_torch.kernels import int8_conv as K

    ci = conv[0]
    parts = x if isinstance(x, list) else [(x, kw["sa_in"])]
    return K.int8_conv_requant_plain(
        parts, m.w_q[ci], m.b_q[ci], sw=m.sw[ci], sb=m.sb[ci],
        retune=m.retune[ci], rounding=rounding,
        **{a: v for a, v in kw.items() if a != "sa_in"}, sa_in=None)


def pcv3_case(m, conv, x, kw, rounding, max_err, what, tables=None):
    """One per-column case: exactly one launch, on the route's per-column
    C entry (no shift table made in the call), equal to the plain
    version, its output neither all saturated nor all one value; returns
    the share of saturated outputs."""
    from yolo_tpu_torch.kernels import int8_conv as K

    before = dict(K.launch_counts_by_entry().get("int8_conv_requant", {}))
    tables_before = K.shift_table_count()
    got = pcv3_call(m, conv, x, kw, rounding, tables)
    torch.cuda.synchronize()
    after = K.launch_counts_by_entry().get("int8_conv_requant", {})
    new = {e: n - before.get(e, 0) for e, n in after.items()
           if n != before.get(e, 0)}
    line = [k for k, (w, e, _, _) in LINES.items()
            if (w, e) == ("int8_conv_requant", PCV3_ENTRY[conv[1]])][0]
    if new != {PCV3_ENTRY[conv[1]]: 1}:
        raise AssertionError(f"{what} launched {new}, want one launch of "
                             f"{PCV3_ENTRY[conv[1]]}")
    if K.shift_table_count() != tables_before:
        raise AssertionError(f"{what} made a shift table in the call")
    check_equal(line, got, pcv3_plain(m, conv, x, kw, rounding), max_err,
                what)
    sat = float(((got == 127) | (got == -128)).float().mean())
    if sat == 1.0 or int(got.min()) == int(got.max()):
        raise AssertionError(f"{what}: outputs all saturated or all one "
                             f"value (saturated share {sat})")
    return sat


def load_pcv3():
    """The per-channel 416² fixture's arrays and its model on the card
    (weights rebuilt from its seed)."""
    from pathlib import Path

    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_seed

    path = Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
    with np.load(path / PCV3_FIXTURE) as z:
        g = {k: z[k] for k in z.files}
    return g, int8_yolo_v3_from_seed(g, device="cuda")


def phase_pcv3_kernels(max_err):
    """yolo_v3 with per-channel sw (phase 2d), on the per-channel 416²
    fixture's model: every conv's sw holds >= 2 values;
    ``pack_res_blocks`` and ``pack_conv3x3s`` make the shift tables once
    (K4's 92: two per block, both roundings; the 29 other convs' 62); then
    K4's per-column form at the five darknet53 stage shapes, batch 128,
    each on the first block of its stage (its packed weights, tables and
    scales) with random int8 input, in both roundings, with and without
    the residual, each one launch of its per-column C entry, no table
    made in a call, torch.equal to its plain version; then the walk of the
    29 convs outside the residual blocks at batch 128, 416², each on
    random int8 input through ``int8_conv_requant`` with the packed
    weights and tables, as the forward calls it: each on its per-column C
    entry (9 head 3x3s, 5 stride-2, 1 entry conv, 14 1x1s), none on the
    mma.sync conv, no table made in a call, each torch.equal to its plain
    version, in both roundings; then the two concat 1x1s with their parts'
    scales forced equal (one table, one accumulator) and forced different
    (a table per part, split). Every case prints its share of saturated
    outputs."""
    from yolo_tpu_torch.kernels import int8_conv as K

    _, m = load_pcv3()
    distinct = [int(len(np.unique(np.asarray(s)))) for s in m.sw]
    if min(distinct) < 2:
        raise AssertionError(f"a conv's per-channel sw has fewer than 2 "
                             f"values: {distinct}")
    K.reset_shift_table_count()
    m.pack_res_blocks()
    res_tables = K.shift_table_count()
    m.pack_conv3x3s()
    conv_tables = K.shift_table_count() - res_tables
    convs, blocks = pcv3_walk(m)
    routes = [c[1] for c in convs]
    want = {PCV3_ENTRY[r]: routes.count(r) for r in PCV3_ENTRY}
    if want != {COLS3: 9, S2_COLS3: 5, ENTRY_COLS3: 1, CONV1X1_COLS: 14}:
        raise AssertionError(f"the walk's routes {want}")
    groups = sum(len({sa for _, sa in c[5]}) for c in convs)
    if (len(blocks), res_tables, conv_tables) != (23, 92, 2 * groups):
        raise AssertionError(f"{len(blocks)} residual blocks, "
                             f"pack_res_blocks made {res_tables} shift "
                             f"tables and pack_conv3x3s {conv_tables}, want "
                             f"23, 92 and {2 * groups}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    n = 0
    for blk in pcv3_stages(blocks):
        ci, _, sa, h, c, cmid, _ = blk
        for rounding in ("nearest", "floor"):
            for with_res in (True, False):
                x = ri(gen, (V3_BATCH_SERVE, h, h, c), *PCV3_INPUT,
                       torch.int8)
                sat = pcv3_res_case(
                    m, blk, x, rounding, with_res, max_err,
                    f"v3 per-channel residual block {ci} ({h}x{h} C {c}, "
                    f"C_mid {cmid}) {rounding}, residual {with_res}")
                emit("pcv3_res_block_vs_plain", conv=ci, entry=RES_COLS,
                     rounding=rounding, residual=with_res,
                     shape=[V3_BATCH_SERVE, h, h, c, cmid],
                     distinct_sw=[distinct[ci], distinct[ci + 1]],
                     saturated_share=sat, equal=True)
                del x
                n += 1
        torch.cuda.empty_cache()
    launches = None
    for rounding in ("nearest", "floor"):
        K.reset_launch_counts()
        for conv in convs:
            ci, route, k, stride, pad, parts, cout, h = conv[:8]
            x, kw = pcv3_inputs(gen, conv)
            what = (f"v3 per-channel conv {ci} ({route}, {h}x{h} "
                    f"{[c for c, _ in parts]} -> {cout}) {rounding}")
            sat = pcv3_case(m, conv, x, kw, rounding, max_err, what)
            emit("pcv3_kernels_vs_plain", conv=ci, route=route,
                 entry=PCV3_ENTRY[route], rounding=rounding,
                 shape=[V3_BATCH_SERVE, h, h, [c for c, _ in parts], cout,
                        k, stride, pad],
                 part_scales=[sa for _, sa in parts],
                 distinct_sw=distinct[ci], saturated_share=sat, equal=True)
            del x
            n += 1
        entries = K.launch_counts_by_entry()
        if entries != {"int8_conv_requant": want}:
            raise AssertionError(f"the per-channel v3 walk launched "
                                 f"{entries}, want {want}")
        launches = launches or entries
        torch.cuda.empty_cache()
    for conv in (c for c in convs if len(c[5]) == 2):
        ci, route, k, stride, pad, parts, cout, h = conv[:8]
        sa0, sa1 = (sa for _, sa in parts)
        for what, sas in (("equal", (sa0, sa0)),
                          ("different", (sa0, sa1 if sa1 != sa0
                                         else sa0 + 2))):
            for rounding in ("nearest", "floor"):
                tables = K.conv_shift_tables(m.sw[ci], sas, m.retune[ci],
                                             rounding, cout, "cuda",
                                             K.CONV1X1_ALIGN)
                x, kw = pcv3_inputs(gen, conv, sas)
                sat = pcv3_case(m, conv, x, kw, rounding, max_err,
                                f"v3 per-channel concat conv {ci}, part "
                                f"scales {what} {sas}, {rounding}", tables)
                lay = K.conv1x1_wgmma_layout(
                    V3_BATCH_SERVE * h * h, parts[0][0], parts[1][0], cout,
                    sas[0] != sas[1])
                emit("pcv3_concat_vs_plain", conv=ci, scales=what,
                     part_scales=list(sas), rounding=rounding,
                     tables=len(tables), split=sas[0] != sas[1], bn=lay.bn,
                     saturated_share=sat, equal=True)
                del x
                n += 1
    emit("pcv3_kernels_vs_plain_done", cases=n,
         shift_tables_at_pack=[res_tables, conv_tables],
         walk_launches=launches, distinct_sw_min=min(distinct),
         distinct_sw_max=max(distinct))
    return m, convs, blocks


# the per-column C entries a per-channel v3 forward launches, and how
# many times each
PCV3_FORWARD = {"int8_res_block": {RES_COLS: 23},
                "int8_conv_requant": {COLS3: 9, S2_COLS3: 5,
                                      ENTRY_COLS3: 1, CONV1X1_COLS: 14}}


def phase_pcv3_golden():
    """The per-channel yolo_v3 golden 416² fixture on the card (phase 3d):
    the heads of its 2 seeded images through the CUDA forward (the packed
    weights and tables the detect fn serves, one launch of a per-column C
    entry per conv or block) bit-exact with the JAX package's, and
    through the detect fn classes and valid exact, boxes and scores
    allclose (atol = rtol = 1e-5)."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    g, m = load_pcv3()
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = np.random.default_rng(int(g["image_seed"])).random(
        (g["head_q_1"].shape[0], SIZE, SIZE, 3), dtype=np.float32)
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa_in)
    m_packed = m.to("cuda")
    m_packed.pack_res_blocks()
    m_packed.pack_conv3x3s()
    K.reset_launch_counts()
    heads = tv3.int8_yolo_v3_forward(m_packed, x_q)
    torch.cuda.synchronize()
    if K.launch_counts_by_entry() != PCV3_FORWARD:
        raise AssertionError(f"the per-channel v3 forward launched "
                             f"{K.launch_counts_by_entry()}, want "
                             f"{PCV3_FORWARD}")
    for i, (head, sa) in enumerate(zip(heads, m.tap_sa[::-1][:3])):
        head_q = torch.round(head * 2.0 ** sa).to(torch.int8).cpu()
        want = torch.as_tensor(g[f"head_q_{i + 1}"])
        if not torch.equal(head_q, want):
            diff = (head_q.int() - want.int()).abs()
            raise AssertionError(
                f"per-channel v3 golden head {i + 1} differs: max |diff| "
                f"{int(diff.max())}, {int((diff > 0).sum())} values")
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda"))
    boxes, scores, classes, valid = (t.cpu().numpy() for t in detect(x_q))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    emit("pcv3_golden", images=int(x_q.shape[0]), heads_bit_exact=True,
         classes_valid_exact=True,
         boxes_max_abs_diff=float(np.abs(boxes - g["boxes"]).max()),
         scores_max_abs_diff=float(np.abs(scores - g["scores"]).max()),
         valid_slots=int(valid.sum()), launches_by_entry=PCV3_FORWARD)
    return m, cfg


def v3_postprocess_ms(m, x_q, cfg):
    """CUDA-event time of the v3 detect fn's decode + greedy NMS alone, on
    the heads ``m`` gives for ``x_q``."""
    from yolo_tpu_torch.detector import predict
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    boxes, probs = predict(tv3.int8_yolo_v3_forward(m, x_q), cfg)
    return time_ms(lambda: nms.batched_postprocess(
        boxes, probs, cfg.conf_thresh, cfg.nms_thresh, cfg.pre_nms_top_k,
        cfg.top_k), 5)


def phase_pcv3_serving(m, cfg, card):
    """Batch-128 per-channel yolo_v3 serving through the detect fn (phase
    4d), timed as phase 4b: per forward 23 launches on K4's per-column C
    entry and 9 / 5 / 1 / 14 on the per-column entries of the stride-1,
    stride-2, entry and 1x1 kernels, none on the mma.sync conv nor on a
    scalar entry; the 23 blocks, 14 3x3s, the entry conv and the 14 1x1s
    packed and the 92 + 62 shift tables made when the detect fn took the
    model, none in the loop."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    gen = torch.Generator(device="cuda").manual_seed(11)
    images = torch.rand((V3_BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                        device="cuda")
    x_q = fp.quantize_input(images, m.sa_in).contiguous()
    del images
    resets = (K.reset_res_block_pack_count, K.reset_conv3x3_pack_count,
              K.reset_entry_conv_pack_count, K.reset_conv1x1_pack_count,
              K.reset_shift_table_count)

    def made():
        return (K.res_block_pack_count(), K.conv3x3_pack_count(),
                K.entry_conv_pack_count(), K.conv1x1_pack_count(),
                K.shift_table_count())

    for reset in resets:
        reset()
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda"))
    at_setup = made()
    if at_setup != (23, 14, 1, 14, 92 + 62):
        raise AssertionError(f"the per-channel v3 detect fn packed "
                             f"{at_setup[:4]} residual blocks, 3x3s, entry "
                             f"convs and 1x1s and made {at_setup[4]} shift "
                             f"tables, want (23, 14, 1, 14) and 92 + 62")
    for _ in range(SERVE_WARMUP):
        detect(x_q)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for reset in resets:
        reset()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        out = detect(x_q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    entries = K.launch_counts_by_entry()
    if made() != (0, 0, 0, 0, 0):
        raise AssertionError(f"per-channel v3 serving packed or made "
                             f"tables in the loop: {made()}")
    want = {w: {e: n * SERVE_ITERS for e, n in by.items()}
            for w, by in PCV3_FORWARD.items()}
    want.update(nms_launches(SERVE_ITERS))
    if entries != want:
        raise AssertionError(f"per-channel v3 launches {entries}, want "
                             f"{want}")
    boxes, scores, classes, valid = out
    if (tuple(boxes.shape) != (V3_BATCH_SERVE, cfg.top_k, 4)
            or not torch.isfinite(boxes).all()
            or not torch.isfinite(scores).all()):
        raise AssertionError("per-channel v3 serving output has the wrong "
                             "shape or is not finite")
    m_packed = m.to("cuda")  # the weights and tables the detect fn serves
    m_packed.pack_res_blocks()
    m_packed.pack_conv3x3s()
    head_ms = time_ms(lambda: tv3.int8_yolo_v3_forward(m_packed, x_q), 5)
    emit("pcv3_serving", batch=V3_BATCH_SERVE, iters=SERVE_ITERS,
         images_per_sec=V3_BATCH_SERVE * SERVE_ITERS / dt,
         ms_per_batch=1e3 * dt / SERVE_ITERS, backbone_ms_per_batch=head_ms,
         postprocess_ms=v3_postprocess_ms(m_packed, x_q, cfg),
         launches=counts, launches_by_entry=entries,
         packs_tables_at_setup=list(at_setup), packs_in_loop=0,
         tables_in_loop=0, card=card)
    return entries


def phase_pcv3_times(card_name, max_err, m, convs, blocks):
    """Each per-channel v3 stage shape of K4 and each distinct conv shape
    outside the residual blocks at batch 128 (phase 4d, timing): its
    per-column kernel (the model's packed weights and tables) == its
    plain version, then both timed (CUDA events), beside a library
    yardstick the port never calls (cuDNN's fp16 1x1 + 3x3 convs for K4,
    ``torch._int_mm`` for the 1x1s, else cuDNN's fp16 conv), and the
    bound."""
    from yolo_tpu_torch.kernels import int8_conv as K

    peak_ops, peak_bw = peaks(card_name)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda").manual_seed(10)
    b = V3_BATCH_SERVE
    per_kernel = {}
    for blk in pcv3_stages(blocks):
        ci, _, sa, h, c, cmid, _ = blk
        count = sum(1 for other in blocks if other[3:6] == blk[3:6])
        x = ri(gen, (b, h, h, c), *PCV3_INPUT, torch.int8)
        check_equal("int8_res_block.cols",
                    pcv3_res_call(m, blk, x, "nearest"),
                    pcv3_res_plain(m, blk, x, "nearest"), max_err,
                    f"v3 per-channel residual block {h}x{h} C {c}, batch "
                    f"{b}")
        ms = time_ms(lambda: pcv3_res_call(m, blk, x, "nearest"), 10)
        host = host_ms(lambda: pcv3_res_call(m, blk, x, "nearest"))
        plain_ms = time_ms(lambda: pcv3_res_plain(m, blk, x, "nearest"), 2,
                           warmup=1)
        del x
        torch.cuda.empty_cache()
        lib_ms = (fp16_conv_ms(b, h, c, cmid, 1, 1, 0)
                  + fp16_conv_ms(b, h, cmid, c, 3, 1, 1))
        ops = 2 * b * h * h * 10 * c * cmid
        nbytes = 2 * b * h * h * c + 10 * c * cmid + 8 * (c + cmid)
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        emit("pcv3_shape_time", kernel="int8_res_block.cols",
             shape=[b, h, h, c, cmid], per_forward=count, equal=True, ms=ms,
             host_ms=host, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9)
        add_time(per_kernel, "int8_res_block.cols", count, ms, plain_ms,
                 lib_ms, t_ops, t_bytes)
    shapes = {}
    for conv in convs:
        route, k, stride, pad, parts, cout, h = conv[1:8]
        key = (route, k, stride, pad, tuple(c for c, _ in parts), cout, h)
        shapes.setdefault(key, []).append(conv)
    for key, group in shapes.items():
        route, k, stride, pad, cins, cout, h = key
        conv = group[0]
        x, kw = pcv3_inputs(gen, conv)
        line = [n for n, (w, e, _, _) in LINES.items()
                if (w, e) == ("int8_conv_requant", PCV3_ENTRY[route])][0]
        check_equal(line, pcv3_call(m, conv, x, kw, "nearest"),
                    pcv3_plain(m, conv, x, kw, "nearest"), max_err,
                    f"v3 per-channel {key}, batch {b}")
        ms = time_ms(lambda: pcv3_call(m, conv, x, kw, "nearest"), 10)
        host = host_ms(lambda: pcv3_call(m, conv, x, kw, "nearest"))
        plain_ms = time_ms(lambda: pcv3_plain(m, conv, x, kw, "nearest"), 2,
                           warmup=1)
        del x
        torch.cuda.empty_cache()
        ho = (h + 2 * pad - k) // stride + 1
        ops = 2 * b * ho * ho * k * k * sum(cins) * cout
        nbytes = (b * h * h * sum(cins) + k * k * sum(cins) * cout
                  + 8 * cout + b * ho * ho * cout)
        lib_ms = (int_mm_ms(b * h * h, sum(cins), cout) if route == "1x1"
                  else None)
        if lib_ms is None:
            lib_ms = fp16_conv_ms(b, h, sum(cins), cout, k, stride, pad)
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        emit("pcv3_shape_time", kernel=line, shape=[b, h, h, list(cins),
                                                    cout, k, stride, pad],
             per_forward=len(group), equal=True, ms=ms, host_ms=host,
             plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9, **bandwidth_fields(nbytes, ms, peak_bw))
        add_time(per_kernel, line, len(group), ms, plain_ms, lib_ms, t_ops,
                 t_bytes)
    return per_kernel


# ---------------------------------------------------------------------------
# The port's PTQ toolchain (phase 5)
# ---------------------------------------------------------------------------

BN_FIXTURE = "slim_int8_bn_416_tables.npz"
V3_FIXTURE = "yolo_v3_int8_416_golden.npz"
SLIM_TABLES = ("sw", "sb", "sa", "retune")
# the launches of one served forward of each phase-5 model
PTQ_PC_FORWARD = {"int8_conv3x3_requant": {COLS3: 6},
                  "int8_conv3x3_im2col": {POOL_COLS3: 3, POOL_NHWC_COLS: 1}}
PTQ_V3_FORWARD = {"int8_res_block": {"yolo_int8_res_block": 23},
                  "int8_conv_requant": {WGMMA3: 9, S2_3: 5, ENTRY3: 1,
                                        CONV1X1: 14}}
PTQ_S2D_FORWARD = {"int8_conv3x3_pool_requant": {POOL_S2D: 1},
                   "int8_conv3x3_im2col": {POOL3: 3},
                   "int8_conv3x3_requant": {WGMMA3: 6}}


def load_fixture(name):
    from pathlib import Path

    path = Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
    with np.load(path / name) as z:
        return {k: z[k] for k in z.files}


def fixture_images(g, n):
    return np.random.default_rng(int(g["image_seed"])).random(
        (n, SIZE, SIZE, 3), dtype=np.float32)


def timed(fn):
    """(fn(), seconds), the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def log2_distance(v: float) -> float:
    """How far log2(v) lies from the nearest integer."""
    f = math.log2(v) % 1.0
    return min(f, 1.0 - f)


def check_slim_tables(m, g, what):
    from yolo_tpu_torch.quant.convert import weights_sha256
    from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES

    for table in SLIM_TABLES:
        for k, v in getattr(m, table).items():
            if not np.array_equal(np.asarray(v), g[f"{table}.{k}"]):
                raise AssertionError(f"{what}: {table}.{k} = {v}, the JAX "
                                     f"package's {g[f'{table}.{k}']}")
    names = list(QUANT_LAYER_NAMES)
    digest = weights_sha256([m.w_q[n].cpu().numpy() for n in names],
                            [m.b_q[n].cpu().numpy() for n in names])
    if digest != str(g["wb_sha256"]):
        raise AssertionError(f"{what}: int8 weights' sha256 {digest}, the "
                             f"JAX package's {g['wb_sha256']}")


def check_v3_tables(m, g, what):
    from yolo_tpu_torch.quant.convert import (
        _v3_tables_from_arrays, weights_sha256)

    want = _v3_tables_from_arrays(g)
    if m.sa_in != want["sa_in"]:
        raise AssertionError(f"{what}: sa_in {m.sa_in}, want "
                             f"{want['sa_in']}")
    for field in ("tap_sa", "sb", "retune"):
        got = [int(v) for v in getattr(m, field)]
        bad = [i for i, (a, b) in enumerate(zip(got, want[field]))
               if a != b]
        if bad or len(got) != len(want[field]):
            raise AssertionError(f"{what}: {field} differs at {bad[:8]} "
                                 f"(port {[got[i] for i in bad[:8]]}, JAX "
                                 f"{[want[field][i] for i in bad[:8]]})")
    if len(m.sw) != len(want["sw"]) or not all(
            np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(m.sw, want["sw"])):
        raise AssertionError(f"{what}: sw differs from the JAX package's")
    digest = weights_sha256([w.cpu().numpy() for w in m.w_q],
                            [b.cpu().numpy() for b in m.b_q])
    if digest != str(g["wb_sha256"]):
        raise AssertionError(f"{what}: int8 weights' sha256 {digest}, the "
                             f"JAX package's {g['wb_sha256']}")


def check_head(head_q, want, what):
    want = torch.as_tensor(want)
    if not torch.equal(head_q.cpu(), want):
        diff = (head_q.cpu().int() - want.int()).abs()
        raise AssertionError(f"{what} differs: max |diff| "
                             f"{int(diff.max())}, {int((diff > 0).sum())} "
                             f"values")


def check_detections(out, g):
    boxes, scores, classes, valid = (t.cpu().numpy() for t in out)
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    return int(valid.sum())


def eager(detect):
    """A detect fn of the port's makers, uncaptured: its device function
    (``detect.captured.fn``, the one ``serving.export`` traces) on the
    input moved to its device, so that every launch of a call goes
    through its wrapper and counts there."""
    fn, dev = detect.captured.fn, detect.device
    return lambda x: fn(torch.as_tensor(x).to(dev))


def served_once(detect, x, want, what):
    """One detect call, the launch counts zeroed just before it and read
    just after; they must be ``want`` (the forward's) and one NMS
    launch."""
    from yolo_tpu_torch.kernels import int8_conv as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = detect(x)
    torch.cuda.synchronize()
    entries = K.launch_counts_by_entry()
    want = {**want, **nms_launches(1)}
    if entries != want:
        raise AssertionError(f"{what} launched {entries}, want {want}")
    return out, entries


def float_forward_ms(model, images):
    """CUDA-event ms per image of the float model's forward (true
    float32, no taps)."""
    x = torch.as_tensor(images).cuda()
    with torch.no_grad():
        return time_ms(lambda: model(x), 5) / x.shape[0]


def phase_ptq_slim_pc(card):
    """5a: per-channel slim, the port's pipeline at 416² on the card."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import qsim
    from yolo_tpu_torch.quant.convert import (
        slim_from_params, slim_seeded_fused_params)
    from yolo_tpu_torch.quant.int8_graph import (
        make_int8_detect_fn, quantize_pipeline)

    g = load_fixture(PC_FIXTURE)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = fixture_images(g, g["head_q"].shape[0])
    model = slim_from_params(slim_seeded_fused_params(
        int(g["weight_seed"]), int(g["pred_out"])), device="cuda")
    m, secs = timed(lambda: quantize_pipeline(model, cfg, [images],
                                              fold_bn=False,
                                              per_channel=True))
    check_slim_tables(m, g, "5a per-channel slim")
    pq = qsim.fake_quantize_params(model, per_channel=True)
    _, calib_s = timed(lambda: qsim.calibrate(pq, cfg, [images]))
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa["in"])
    detect = eager(make_int8_detect_fn(m, cfg, device="cuda"))
    out, entries = served_once(detect, x_q, PTQ_PC_FORWARD, "5a served")
    m_packed = m.to("cuda")
    m_packed.pack_conv3x3()
    check_head(torch.round(fp.int8_forward(m_packed, x_q)
                           * 2.0 ** m.sa["pred"]).to(torch.int8),
               g["head_q"], "5a head")
    emit("ptq_slim_pc", images=len(images), pipeline_s=secs,
         calib_ms_per_batch=1e3 * calib_s,
         float_ms_per_image=float_forward_ms(model, images),
         tables_equal=True, wb_sha256_equal=True, head_bit_exact=True,
         valid_slots=check_detections(out, g), launches_by_entry=entries,
         card=card)
    return entries


def phase_ptq_v3(card, fixture):
    """5b: yolo_v3 (scalar or per-channel by the fixture), the port's
    pipeline at 416² on the card."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.convert import yolo_v3_from_params
    from yolo_tpu_torch.quant.generic import (
        calibrate_generic, fake_quantize_all_convs)

    g = load_fixture(fixture)
    per_channel = "per_channel" in g and bool(g["per_channel"])
    what = "5b per-channel v3" if per_channel else "5b v3"
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = fixture_images(g, g["head_q_1"].shape[0])
    recipe = (tv3.seeded_fused_params_per_channel if per_channel
              else tv3.seeded_fused_params)
    model = yolo_v3_from_params(recipe(int(g["weight_seed"]),
                                       int(g["pred_out"])), device="cuda")
    m, secs = timed(lambda: tv3.quantize_pipeline_yolo_v3(
        model, cfg, [images], fold_bn=False, per_channel=per_channel))
    check_v3_tables(m, g, what)
    pq = fake_quantize_all_convs(model, per_channel=per_channel)
    _, calib_s = timed(lambda: calibrate_generic(pq, cfg, [images]))
    del pq
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa_in)
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda"))
    out, entries = served_once(
        detect, x_q, PCV3_FORWARD if per_channel else PTQ_V3_FORWARD,
        f"{what} served")
    m_packed = m.to("cuda")
    m_packed.pack_res_blocks()
    m_packed.pack_conv3x3s()
    heads = tv3.int8_yolo_v3_forward(m_packed, x_q)
    for i, (head, sa) in enumerate(zip(heads, m.tap_sa[::-1][:3])):
        check_head(torch.round(head * 2.0 ** sa).to(torch.int8),
                   g[f"head_q_{i + 1}"], f"{what} head {i + 1}")
    emit("ptq_v3_pc" if per_channel else "ptq_v3", images=len(images),
         pipeline_s=secs, calib_ms_per_batch=1e3 * calib_s,
         float_ms_per_image=float_forward_ms(model, images),
         tables_equal=True, wb_sha256_equal=True, heads_bit_exact=True,
         valid_slots=check_detections(out, g), launches_by_entry=entries,
         card=card)
    return entries


def phase_ptq_bn(card):
    """5c: slim from BN-form params, the fold included, per tensor: the
    port's pipeline at 416² on the card, its weight.h, the s2d path."""
    import hashlib

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import qsim
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
    from yolo_tpu_torch.quant.convert import (
        slim_from_params, slim_seeded_bn_params)
    from yolo_tpu_torch.quant.int8_graph import (
        make_int8_detect_fn, quantize_pipeline)
    from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES
    from yolo_tpu_torch.quant.retune import c_header

    g = load_fixture(BN_FIXTURE)
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = fixture_images(g, g["head_q"].shape[0])
    model = slim_from_params(slim_seeded_bn_params(
        int(g["weight_seed"]), int(g["pred_out"])), device="cuda")
    m, secs = timed(lambda: quantize_pipeline(model, cfg, [images],
                                              fold_bn=True))
    # the card's float scales and maxima, for how far they lie from the
    # JAX package's (the tables are checked below)
    pq = qsim.fake_quantize_params(fold_batch_norm(model))
    states, calib_s = timed(lambda: qsim.calibrate(pq, cfg, [images]))
    _, _, maxima = qsim.quant_forward(pq, torch.as_tensor(images).cuda(),
                                      cfg, states)
    scale = np.asarray([float(states[n]["scale"]) for n in TRACKER_NAMES])
    pre = np.asarray([float(maxima[n]) for n in QUANT_LAYER_NAMES])
    drift = {"tracker_scale_max_rel": float(np.max(
        np.abs(scale - g["tracker_scale"]) / g["tracker_scale"])),
        "pre_max_max_rel": float(np.max(
            np.abs(pre - g["pre_max"]) / g["pre_max"])),
        "tracker_scale_unequal": int(np.sum(
            scale.astype(np.float32) != g["tracker_scale"])),
        "pre_max_unequal": int(np.sum(pre.astype(np.float32)
                                      != g["pre_max"])),
        "closest_sa_log2_to_integer": min(log2_distance(v) for v in scale)}
    emit("ptq_bn_floats", **drift,
         fixture_closest_log2_to_integer={
             k[5:]: float(np.min(np.minimum(g[k], 1 - g[k])))
             for k in g if k.startswith("frac_")})
    check_slim_tables(m, g, "5c BN-fold slim")
    header = hashlib.sha256(c_header(m).encode()).hexdigest()
    if header != str(g["header_sha256"]):
        raise AssertionError(f"5c weight.h sha256 {header}, the JAX "
                             f"package's {g['header_sha256']}")
    x2 = fp.s2d_input(fp.quantize_input(torch.as_tensor(images).cuda(),
                                        m.sa["in"])).contiguous()
    detect = eager(make_int8_detect_fn(m, cfg, input_s2d=True, device="cuda"))
    out, entries = served_once(detect, x2, PTQ_S2D_FORWARD, "5c served")
    boxes, scores = out[0], out[1]
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("5c detections are not finite")
    m_packed = m.to("cuda")
    m_packed.pack_conv3x3()
    check_head(torch.round(fp.int8_forward(m_packed, x2, input_s2d=True)
                           * 2.0 ** m.sa["pred"]).to(torch.int8),
               g["head_q"], "5c head")
    emit("ptq_bn", images=len(images), pipeline_s=secs,
         calib_ms_per_batch=1e3 * calib_s,
         float_ms_per_image=float_forward_ms(model, images),
         fused_float_ms_per_image=float_forward_ms(fold_batch_norm(model),
                                                   images),
         tables_equal=True, wb_sha256_equal=True, header_sha256_equal=True,
         head_bit_exact=True, valid_slots=int(out[3].sum()),
         launches_by_entry=entries, card=card)
    return entries


def phase_ptq(card):
    """Phase 5: the port's PTQ toolchain on the card, each model served
    once; -> the launches of each served forward."""
    runs = [phase_ptq_slim_pc(card)]
    torch.cuda.empty_cache()
    for fixture in (V3_FIXTURE, PCV3_FIXTURE):
        runs.append(phase_ptq_v3(card, fixture))
        torch.cuda.empty_cache()
    runs.append(phase_ptq_bn(card))
    return runs


# ---------------------------------------------------------------------------
# The serving entry point (phase 6)
# ---------------------------------------------------------------------------

SPP_FIXTURE = "yolo_v3_spp_int8_416_golden.npz"
# the launches of one served yolo_v3_spp forward: v3's (conv_set_3's
# first 1x1, 4096 -> 512 after the SPP block, is one of the fourteen)
SPP_FORWARD = {"int8_res_block": {"yolo_int8_res_block": 23},
               "int8_conv_requant": {WGMMA3: 9, S2_3: 5, ENTRY3: 1,
                                     CONV1X1: 14}}
SERVE_CLI_BATCH, SERVE_CLI_ITERS = 64, 20


def synthetic_frames(n, seed=0):
    """u8 BGR camera-sized frames, as ``cli.serve`` makes them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
            for _ in range(n)]


def phase_native(card):
    """6a: the native preprocessing library built from ``native/`` and in
    use; its s2d layout byte-equal to ``s2d_input_np`` of its NHWC int8,
    and within the JAX package's tolerances of the numpy path."""
    from yolo_tpu_torch.data import transforms
    from yolo_tpu_torch.data.transforms import BaseTransform
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.utils import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native preprocessing library did not "
                             "build or load (make -C native)")
    load_s = time.perf_counter() - t0
    frames = synthetic_frames(8, seed=5)
    size = (SIZE, SIZE)
    nhwc = native.preprocess_batch(frames, size, int8_scale=16.0)
    s2d = native.preprocess_batch(frames, size, int8_scale=16.0,
                                  layout="s2d")
    if not np.array_equal(s2d, fp.s2d_input_np(nhwc)):
        raise AssertionError("native s2d differs from s2d_input_np of its "
                             "NHWC output")
    ref = np.stack([BaseTransform(size)(f)[0] for f in frames])
    f32 = native.preprocess_batch(frames, size)
    refq = np.clip(np.round(ref * 16.0), -128, 127)
    f32_err = float(np.abs(f32 - ref).max())
    i8_err = int(np.abs(nhwc.astype(np.int32) - refq).max())
    if f32_err >= 0.05 or i8_err > 1:
        raise AssertionError(f"native preprocessing off the numpy path: "
                             f"float {f32_err}, int8 {i8_err} levels")
    batch = synthetic_frames(V3_BATCH_SERVE, seed=6)
    host = host_ms_once(lambda: native.preprocess_batch(
        batch, size, int8_scale=16.0, layout="s2d"))
    emit("native", load_or_build_s=load_s, s2d_equal=True,
         f32_max_abs_diff=f32_err, int8_max_level_diff=i8_err,
         cv2=transforms.cv2 is not None,
         s2d_ms_per_batch=host, batch=V3_BATCH_SERVE, frame=[480, 640],
         card=card)


def host_ms_once(fn, n: int = 3) -> float:
    """Median host ms of ``n`` calls of a host-only function."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def serve_loop(detect, x, iters=SERVE_ITERS):
    """images/sec of ``iters`` detect calls after the warm-up, and the
    launches by C entry of those calls."""
    from yolo_tpu_torch.kernels import int8_conv as K

    for _ in range(SERVE_WARMUP):
        detect(x)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = detect(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return x.shape[0] * iters / dt, K.launch_counts_by_entry(), out


def per_forward(entries, n):
    return {k: {e: c // n for e, c in v.items()} for k, v in entries.items()}


def check_v3_forms(m, m_packed, x_q):
    """6b: the other s2d modes ("stride2", True) on the card give the
    plain walk's heads with its launches on each entry, and a residual
    block cut by ``limit`` runs its convs one by one on the card and gives
    the CPU walk's live tensors."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    K.reset_launch_counts()
    plain = tv3.int8_yolo_v3_forward(m_packed, x_q, s2d=False)
    plain_entries = K.launch_counts_by_entry()
    for s2d in ("stride2", True):
        K.reset_launch_counts()
        got = tv3.int8_yolo_v3_forward(m_packed, x_q, s2d=s2d)
        entries = K.launch_counts_by_entry()
        if entries != plain_entries or not all(
                torch.equal(a, b) for a, b in zip(got, plain)):
            raise AssertionError(f"6b: s2d={s2d!r} differs from the plain "
                                 f"walk (launches {entries}, plain "
                                 f"{plain_entries})")
    limit = 5  # the entry pair, then the first block's push, 1x1, 3x3
    K.reset_launch_counts()
    got = tv3.int8_yolo_v3_forward(m_packed, x_q[:1], limit=limit)
    counts = K.launch_counts()
    want = tv3.int8_yolo_v3_forward(m.to("cpu"), x_q[:1].cpu(),
                                    limit=limit)
    if (counts["int8_conv_requant"] != 4 or counts["int8_res_block"]
            or len(got) != len(want)
            or not all(torch.equal(a.cpu(), b) for a, b in zip(got, want))):
        raise AssertionError(f"6b: limit={limit} differs from the CPU walk "
                             f"(launches {counts})")


def phase_v3_s2d(m, cfg, card, launches_v3):
    """6b: yolo_v3 on the s2d serving layout (``input_s2d``, the fused
    entry pair re-executed on the entry conv and stride-2 kernels) at
    416²: the fixture's heads bit-exact, detections equal to the NHWC
    detect fn's, per-forward launches phase 4b's, the relayout's device
    time and s2d against NHWC serving at batch 128 (NHWC, s2d, s2d,
    NHWC in one process)."""
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    g = load_fixture(V3_FIXTURE)
    x_q = fp.quantize_input(torch.as_tensor(fixture_images(
        g, g["head_q_1"].shape[0])).cuda(), m.sa_in)
    x2 = fp.s2d_input(x_q).contiguous()
    m_packed = m.to("cuda")
    m_packed.pack_res_blocks()
    m_packed.pack_conv3x3s()
    heads = tv3.int8_yolo_v3_forward(m_packed, x2, input_s2d=True)
    for i, (head, sa) in enumerate(zip(heads, m.tap_sa[::-1][:3])):
        check_head(torch.round(head * 2.0 ** sa).to(torch.int8),
                   g[f"head_q_{i + 1}"], f"6b v3 s2d head {i + 1}")
    detect_s2d = eager(tv3.make_int8_yolo_v3_detect_fn(
        m, cfg, input_s2d=True, device="cuda"))
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda"))
    for a, b in zip(detect_s2d(x2), detect(x_q)):
        if not torch.equal(a, b):
            raise AssertionError("6b: s2d detections differ from NHWC's")
    valid = check_detections(detect_s2d(x2), g)
    check_v3_forms(m, m_packed, x_q)
    gen = torch.Generator(device="cuda").manual_seed(4)
    xb = fp.quantize_input(torch.rand((V3_BATCH_SERVE, SIZE, SIZE, 3),
                                      generator=gen, device="cuda"),
                           m.sa_in).contiguous()
    xb2 = fp.s2d_input(xb).contiguous()
    relayout_ms = time_ms(lambda: fp.nhwc_from_entry_blocks(
        fp.s2d_entry_from_input(xb2)), 10)
    relayout_bytes = (fp.s2d_entry_from_input(xb2).numel() + xb.numel())
    if not torch.equal(fp.nhwc_from_entry_blocks(
            fp.s2d_entry_from_input(xb2)), xb):
        raise AssertionError("6b: the relayout is not the NHWC images")
    forward_ms = time_ms(lambda: tv3.int8_yolo_v3_forward(
        m_packed, xb2, input_s2d=True), 5)
    ips = {"nhwc": [], "s2d": []}
    entries = None
    for form in ("nhwc", "s2d", "s2d", "nhwc"):
        rate, got, _ = serve_loop(detect_s2d if form == "s2d" else detect,
                                  xb2 if form == "s2d" else xb)
        ips[form].append(rate)
        if form == "s2d":
            entries = got
            want = per_forward(launches_v3, SERVE_ITERS)
            if per_forward(got, SERVE_ITERS) != want:
                raise AssertionError(f"6b: s2d serving launched "
                                     f"{per_forward(got, SERVE_ITERS)} per "
                                     f"forward, phase 4b {want}")
    _, peak_bw = peaks(torch.cuda.get_device_name(0))
    emit("v3_s2d", heads_bit_exact=True, detections_equal_nhwc=True,
         valid_slots=valid, batch=V3_BATCH_SERVE, relayout_ms=relayout_ms,
         relayout_bytes=relayout_bytes,
         relayout_bound_ms=1e3 * relayout_bytes / peak_bw,
         s2d_forward_ms=forward_ms,
         relayout_share_of_forward=relayout_ms / forward_ms,
         images_per_sec_s2d=ips["s2d"], images_per_sec_nhwc=ips["nhwc"],
         launches_per_forward=per_forward(entries, SERVE_ITERS), card=card)
    return entries


def profiled(fn, n: int = 1):
    """``n`` calls of ``fn`` under ``torch.profiler`` -> (the names of the
    CUDA kernels they ran, their device ms per call; None where it
    recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    return sorted({e.name for e in kernels}), (ms if kernels else None)


def spp_kernels(x):
    """The CUDA kernels one ``int_spp`` call runs, by name, as
    ``torch.profiler`` records them (empty where it recorded none)."""
    from yolo_tpu_torch.quant import fixed_point as fp

    return profiled(lambda: fp.int_spp(x))[0]


def phase_spp(card):
    """6c: yolo_v3_spp INT8 at 416² on its fixture: heads bit-exact (NHWC
    and s2d input), detections, served at batch 128 with its launches
    (the 4096 -> 512 1x1's route recorded); ``int_spp`` equal to its CPU
    run, its device time and the kernels it runs."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_seed

    g = load_fixture(SPP_FIXTURE)
    m = int8_yolo_v3_from_seed(g, device="cuda")
    cfg = get_config("yolo_v3_spp", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    x_q = fp.quantize_input(torch.as_tensor(fixture_images(
        g, g["head_q_1"].shape[0])).cuda(), m.sa_in)
    m_packed = m.to("cuda")
    m_packed.pack_res_blocks()
    m_packed.pack_conv3x3s()
    for name, heads in (
            ("nhwc", tv3.int8_yolo_v3_forward(m_packed, x_q)),
            ("s2d", tv3.int8_yolo_v3_forward(m_packed, fp.s2d_input(x_q),
                                             input_s2d=True))):
        for i, (head, sa) in enumerate(zip(heads, m.tap_sa[::-1][:3])):
            check_head(torch.round(head * 2.0 ** sa).to(torch.int8),
                       g[f"head_q_{i + 1}"], f"6c spp {name} head {i + 1}")
    detect = eager(tv3.make_int8_yolo_v3_detect_fn(
        m, cfg, input_s2d=True, device="cuda"))
    x2 = fp.s2d_input(x_q).contiguous()
    out, _ = served_once(detect, x2, SPP_FORWARD, "6c spp served")
    valid = check_detections(out, g)
    i = [op[1] for op in m.program if op[0] == "conv"].index(
        ("conv_set_3", 0))
    w = m.w_q[i]
    route = ("wgmma 1x1 (" + CONV1X1 + ")" if K.conv1x1_wgmma_route(
        1, 1, 0, 1, (w.shape[2],), m.sw[i], c_out=w.shape[3])
        else "mma.sync (yolo_int8_conv_requant)")
    c5 = torch.randint(-128, 128, (V3_BATCH_SERVE, 13, 13, 1024),
                       dtype=torch.int8, device="cuda")
    if not torch.equal(fp.int_spp(c5).cpu(), fp.int_spp(c5.cpu())):
        raise AssertionError("6c: int_spp on the card differs from the CPU")
    spp_ms = time_ms(lambda: fp.int_spp(c5), 10)
    x_mid = torch.randint(-128, 128, (V3_BATCH_SERVE, 13, 13, 4096),
                          dtype=torch.int8, device="cuda")
    kw = dict(sw=m.sw[i], sb=m.sb[i], sa_in=m.tap_sa[i], sa_out=m.sa_in,
              retune=m.retune[i], leaky=True,
              packed=m_packed.packed_weights(i))
    conv_ms = time_ms(lambda: K.int8_conv_requant(x_mid, w, m.b_q[i], **kw),
                      10)
    del x_mid
    gen = torch.Generator(device="cuda").manual_seed(4)
    xb2 = fp.s2d_input(fp.quantize_input(
        torch.rand((V3_BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                   device="cuda"), m.sa_in)).contiguous()
    forward_ms = time_ms(lambda: tv3.int8_yolo_v3_forward(
        m_packed, xb2, input_s2d=True), 5)
    rate, entries, _ = serve_loop(detect, xb2)
    if per_forward(entries, SERVE_ITERS) != {**SPP_FORWARD,
                                             **nms_launches(1)}:
        raise AssertionError(f"6c spp serving launched "
                             f"{per_forward(entries, SERVE_ITERS)} per "
                             f"forward, want {SPP_FORWARD} and the NMS")
    emit("v3_spp", heads_bit_exact=["nhwc", "s2d"], valid_slots=valid,
         batch=V3_BATCH_SERVE, images_per_sec=rate,
         launches_per_forward=per_forward(entries, SERVE_ITERS),
         backbone_ms_per_batch=forward_ms,
         conv_set_3_0=[int(v) for v in w.shape], conv_set_3_0_route=route,
         conv_set_3_0_ms=conv_ms, int_spp_ms=spp_ms, int_spp_equal_cpu=True,
         int_spp_kernels=spp_kernels(c5), card=card)
    return entries


def phase_serve_cli(card, cases=(("slim_yolo_v2", SERVE_CLI_BATCH, "s2d"),
                                  ("yolo_v3", SERVE_CLI_BATCH, "s2d"))):
    """6d (and 7c): ``cli.serve.main`` in process for each (version, batch,
    the input mode ``--input auto`` must give) of ``cases`` (6d: slim_yolo_v2
    and yolo_v3 at batch 64, the s2d layout), 416²: end-to-end frames/sec
    sequential and overlapped, native preprocessing in use,
    ``detect_frames`` equal to the detect fn on the same preprocessed
    batch, ``detect_stream`` equal to ``detect_frames`` batch by batch.
    -> the launches of each run."""
    from yolo_tpu_torch.cli import serve
    from yolo_tpu_torch.kernels import int8_conv as K

    runs = []
    for version, bsz, mode in cases:
        argv = ["-v", version, "--input_size", str(SIZE), str(SIZE),
                "--batch", str(bsz), "--iters", str(SERVE_CLI_ITERS)]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        entries = K.launch_counts_by_entry()
        sd = res["detector"]
        per_replay = check_replays(sd.detect_fn.captured,
                                   f"cli.serve -v {version}")
        if (sd._native is None or sd.s2d != (mode == "s2d")
                or sd.sa_in is None):
            raise AssertionError(f"6d {version}: native preprocessing "
                                 f"{sd._native is not None}, s2d {sd.s2d}, "
                                 f"host int8 {sd.sa_in is not None}, want "
                                 f"{mode}")
        frames = synthetic_frames(bsz)
        got = sd.detect_frames(frames)
        preprocess_ms = host_ms_once(lambda: sd.preprocess(frames))
        batch = torch.from_numpy(sd.preprocess(frames)).cuda()
        detect_ms = time_ms(lambda: sd.detect_fn(batch), 5)
        want = sd._postprocess(frames, sd.detect_fn(batch), None)
        halves = [frames[:bsz // 2], frames[bsz // 2:]]
        streamed = list(sd.detect_stream(halves))
        for a, b in zip(got + streamed[0] + streamed[1],
                        want + sd.detect_frames(halves[0])
                        + sd.detect_frames(halves[1])):
            if not all(np.array_equal(u, v) for u, v in zip(a, b)):
                raise AssertionError(f"6d {version}: served detections "
                                     f"differ")
        emit("serve_cli", version=version, argv=argv,
             fps=res["fps"], fps_sequential=res["fps_sequential"],
             overlap_gain=res["fps"] / res["fps_sequential"],
             main_s=main_s, preprocess_ms_per_batch=preprocess_ms,
             detect_ms_per_batch=detect_ms, native=True, input=mode,
             detect_frames_equal_detect_fn=True,
             detect_stream_equal_detect_frames=True,
             detections=int(sum(len(s) for _, s, _ in got)),
             launches_by_entry=entries, launches_per_replay=per_replay,
             card=card)
        runs.append(entries)
        del sd, res
        torch.cuda.empty_cache()
    return runs

# ---------------------------------------------------------------------------
# tiny_yolo_v3 and yolo_v2 (phase 7)
# ---------------------------------------------------------------------------

# version -> what phase 7 runs: its fixture and per-channel fixture,
# serving batch, the port's functions by name (convert: from_seed, seeded,
# from_params; int8_models: pipeline, forward, maker), its heads' tap
# names, and per forward on NHWC input the launches by wrapper and C entry
# at a scalar sw (none on the mma.sync general conv)
FAMILY7 = {
    "tiny_yolo_v3": dict(
        fixture="tiny_yolo_v3_int8_416_golden.npz",
        pc_fixture="tiny_yolo_v3_int8_pc_416_golden.npz", batch=256,
        from_seed="int8_tiny_from_seed", seeded="tiny_seeded_fused_params",
        from_params="tiny_from_params", pipeline="quantize_pipeline_tiny",
        forward="int8_tiny_forward", maker="make_int8_tiny_detect_fn",
        heads=("pred_1", "pred_2"),
        launches={"int8_conv_requant": {ENTRY3: 1, WGMMA3: 7, PARTS3: 1,
                                        CONV1X1: 3},
                  "int8_conv3x3_im2col": {POOL3: 1}}),
    "yolo_v2": dict(
        fixture="yolo_v2_int8_416_golden.npz",
        pc_fixture="yolo_v2_int8_pc_416_golden.npz", batch=128,
        from_seed="int8_yolo_v2_from_seed",
        seeded="yolo_v2_seeded_fused_params",
        from_params="yolo_v2_from_params",
        pipeline="quantize_pipeline_yolo_v2", forward="int8_yolo_v2_forward",
        maker="make_int8_yolo_v2_detect_fn", heads=("pred",),
        launches={"int8_conv_requant": {ENTRY3: 1, WGMMA3: 13, PARTS3: 1,
                                        CONV1X1: 8}}),
}
# the per-column C entry of each scalar one on phase 7's paths (7d)
COLS_OF = {ENTRY3: ENTRY_COLS3, WGMMA3: COLS3, PARTS3: PARTS_COLS3,
           CONV1X1: CONV1X1_COLS, POOL3: POOL_COLS3}
# cli.serve runs of phase 7c: (version, batch, the input mode --input auto
# gives)
CLI7 = (("tiny_yolo_v3", 64, "s2d"), ("yolo_v2", 64, "s2d"),
        ("yolo_v2", 128, "int8"))


def family7_launches(version, s2d, per_channel=False):
    """Per-forward launches by wrapper and C entry: on the s2d layout the
    entry conv and its pool run once on K2's wgmma kernel instead; with a
    per-channel sw (NHWC input only) each on its per-column C entry."""
    out = {w: {COLS_OF[e] if per_channel else e: n for e, n in by.items()}
           for w, by in FAMILY7[version]["launches"].items()}
    if s2d:
        del out["int8_conv_requant"][ENTRY3]
        out["int8_conv3x3_pool_requant"] = {POOL_S2D: 1}
    return out


FAMILY7_PACKS = ("conv3x3", "conv3x3_parts", "entry_conv", "conv1x1",
                 "pool_s2d", "shift_table")


def family7_packs():
    from yolo_tpu_torch.kernels import int8_conv as K

    return (K.conv3x3_pack_count(), K.conv3x3_parts_pack_count(),
            K.entry_conv_pack_count(), K.conv1x1_pack_count(),
            K.pool_s2d_pack_count(), K.shift_table_count())


def reset_family7_packs():
    from yolo_tpu_torch.kernels import int8_conv as K

    for reset in (K.reset_conv3x3_pack_count,
                  K.reset_conv3x3_parts_pack_count,
                  K.reset_entry_conv_pack_count,
                  K.reset_conv1x1_pack_count, K.reset_pool_s2d_pack_count,
                  K.reset_shift_table_count):
        reset()


# the kernels-line names whose device time phase 7 reads with
# torch.profiler: the convs this slice moved onto the wgmma conv3x3
FAMILY7_DEVICE_LINES = PARTS_LINES + ("int8_conv3x3_im2col",
                                      "int8_conv3x3_im2col.cols")


def family7_conv_times(version, m, forward, xb, xb2, peak_ops, peak_bw,
                       max_err):
    """Every conv of one NHWC forward at the serving batch, on its real
    input (recorded from the forward), with the model's packed weights and
    (per-channel) shift tables, and the entry conv + pool on the s2d
    layout (``xb2``; None: not run): kernel == plain version, then the
    kernel, the plain version and a library yardstick (cuDNN fp16 conv2d;
    torch._int_mm for a 1x1) timed, with the bound; the two-part and
    pooled convs also their device time (torch.profiler). -> {kernels-line
    name: per-forward sums (``add_time``)}, each conv's line emitted."""
    from yolo_tpu_torch.kernels import int8_conv as K

    calls = []
    real_conv, real_pool = m.conv, m.conv_pool

    def spy(name, x, sa_in, rounding, leaky=True):
        calls.append((name, x, sa_in, leaky, False))
        return real_conv(name, x, sa_in, rounding, leaky)

    def spy_pool(name, x, sa_in, rounding, leaky=True):
        calls.append((name, x, sa_in, leaky, True))
        return real_pool(name, x, sa_in, rounding, leaky)

    m.conv, m.conv_pool = spy, spy_pool
    try:
        forward(m, xb)
    finally:
        del m.conv, m.conv_pool
    per_kernel = {}

    def record(line, name, shape, ms, plain_ms, lib_ms, ops, nbytes,
               **extra):
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        emit("family7_conv_time", version=version, conv=name, kernel=line,
             shape=shape, equal=True, ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9, share_of_bound=max(t_ops, t_bytes) / ms,
             **extra)
        add_time(per_kernel, line, 1, ms, plain_ms, lib_ms, t_ops, t_bytes)

    for name, x, sa_in, leaky, pooled in calls:
        w, bias, packed = m.w_q[name], m.b_q[name], m.packed.get(name)
        tables = m._tables(name, "nearest")
        kw = dict(sw=m.sw[name], sb=m.sb[name], sa_in=sa_in,
                  sa_out=m.sa[name], retune=m.retune[name], leaky=leaky,
                  rounding="nearest")
        if pooled:
            def run():
                return K.int8_conv3x3_im2col(
                    x, w, bias, packed=packed, pool=True,
                    shifts=None if tables is None else tables[0], **kw)

            def run_plain():
                return K.int8_conv3x3_im2col_plain(x, w, bias, pool=True,
                                                   **kw)
        else:
            kw["padding"] = m.PAD[name]

            def run():
                return K.int8_conv_requant(x, w, bias, packed=packed,
                                           shifts=tables, **kw)

            def run_plain():
                return K.int8_conv_requant_plain(x, w, bias, **kw)
        K.reset_launch_counts()
        got = run()
        line = ran_line()
        check_equal(line, got, run_plain(), max_err, f"{version} {name}")
        del got
        ms = time_ms(run, 10)
        plain_ms = time_ms(run_plain, 2, warmup=1)
        xs = [p for p, _ in x] if isinstance(x, list) else [x]
        b, h = xs[0].shape[:2]
        cins = [t.shape[-1] for t in xs]
        k, c_out = w.shape[0], w.shape[3]
        lib_ms = int_mm_ms(b * h * h, sum(cins), c_out) if k == 1 else None
        if lib_ms is None:
            lib_ms = fp16_conv_ms(b, h, sum(cins), c_out, k, 1, k // 2)
        extra = {}
        if line in FAMILY7_DEVICE_LINES:  # their device time alone
            extra["device_ms"] = profiled(run, 5)[1]
        out_px = b * h * h // (4 if pooled else 1)
        record(line, name + (" + pool" if pooled else ""),
               [b, h, h, cins, c_out, k], ms, plain_ms, lib_ms,
               2 * b * h * h * k * k * sum(cins) * c_out,
               sum(t.numel() for t in xs) + w.numel() + 4 * c_out
               + out_px * c_out, **extra)
        if extra.get("device_ms") is not None:
            agg = per_kernel[line]
            agg["device_ms"] = agg.get("device_ms", 0.0) + extra["device_ms"]
        torch.cuda.empty_cache()
    del calls
    if xb2 is None:
        return per_kernel
    # the entry conv + its pool on the s2d layout (K2)
    first = m.CONV_ORDER[0]
    w, bias = m.w_q[first], m.b_q[first]
    kw = dict(c_in=3, sw=m.sw[first], sb=m.sb[first], sa_in=m.sa["in"],
              sa_out=m.sa[first], retune=m.retune[first], leaky=0.1,
              rounding="nearest")
    K.reset_launch_counts()
    got = m.entry_s2d(xb2, "nearest")
    line = ran_line()
    want = K.int8_conv3x3_pool_s2d_plain(xb2, w, bias, **kw)
    check_equal(line, got, want, max_err, f"{version} {first} on s2d")
    del got, want
    b, c_out = xb2.shape[0], w.shape[3]
    ms = time_ms(lambda: m.entry_s2d(xb2, "nearest"), 10)
    plain_ms = time_ms(lambda: K.int8_conv3x3_pool_s2d_plain(
        xb2, w, bias, **kw), 2, warmup=1)
    record(line, f"{first} + pool (s2d)", [b, SIZE, SIZE, [3], c_out, 3], ms,
           plain_ms, fp16_conv_ms(b, SIZE, 3, c_out, 3, 1, 1),
           2 * b * SIZE * SIZE * 9 * 3 * c_out,
           xb2.numel() + w.numel() + 4 * c_out + b * SIZE * SIZE * c_out // 4)
    torch.cuda.empty_cache()
    return per_kernel


def phase_family7(version, card, max_err):
    """7a / 7b: the family's 416² fixture on the card (heads bit-exact on
    NHWC and s2d input, detections, launches per forward), served at its
    batch on s2d and NHWC input (packs at setup, none in the loop), its
    convs timed; -> (the serving runs' launches, {line: per-forward
    sums})."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.detector import predict
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_models as tim

    f = FAMILY7[version]
    peak_ops, peak_bw = peaks(torch.cuda.get_device_name(0))
    g = load_fixture(f["fixture"])
    cfg = get_config(version, "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    m = getattr(convert, f["from_seed"])(g, device="cuda")
    forward, maker = getattr(tim, f["forward"]), getattr(tim, f["maker"])
    x_q = fp.quantize_input(torch.as_tensor(fixture_images(
        g, g["head_q_1"].shape[0])).cuda(), m.sa["in"]).contiguous()
    x2 = fp.s2d_input(x_q).contiguous()
    m_packed = m.to("cuda")
    m_packed.pack()
    for layout, x in (("nhwc", x_q), ("s2d", x2)):
        heads = forward(m_packed, x, input_s2d=layout == "s2d")
        for i, (head, name) in enumerate(zip(heads, f["heads"])):
            check_head(torch.round(head * 2.0 ** m.sa[name]).to(torch.int8),
                       g[f"head_q_{i + 1}"],
                       f"7 {version} {layout} head {i + 1}")
    detect_nhwc = eager(maker(m, cfg, device="cuda"))
    reset_family7_packs()
    detect = eager(maker(m, cfg, input_s2d=True, device="cuda"))
    packs_at_setup = family7_packs()
    valid = {}
    for layout, fn, x in (("nhwc", detect_nhwc, x_q), ("s2d", detect, x2)):
        out, _ = served_once(fn, x, family7_launches(version, layout == "s2d"),
                             f"7 {version} {layout} served")
        valid[layout] = check_detections(out, g)
    batch = f["batch"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    xb = fp.quantize_input(torch.rand((batch, SIZE, SIZE, 3), generator=gen,
                                      device="cuda"),
                           m.sa["in"]).contiguous()
    xb2 = fp.s2d_input(xb).contiguous()
    reset_family7_packs()
    ips, runs = {}, []
    for layout, fn, x in (("s2d", detect, xb2), ("nhwc", detect_nhwc, xb)):
        rate, entries, out = serve_loop(fn, x)
        want = {**family7_launches(version, layout == "s2d"),
                **nms_launches(1)}
        if per_forward(entries, SERVE_ITERS) != want:
            raise AssertionError(f"7 {version} {layout} serving launched "
                                 f"{per_forward(entries, SERVE_ITERS)} per "
                                 f"forward, want {want}")
        if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
            raise AssertionError(f"7 {version}: detections not finite")
        ips[layout] = rate
        runs.append(entries)
    if any(family7_packs()):
        raise AssertionError(f"7 {version}: serving packed weights "
                             f"{family7_packs()}")
    backbone_ms = {
        layout: time_ms(lambda: forward(m_packed, x, input_s2d=s2d), 5)
        for layout, x, s2d in (("s2d", xb2, True), ("nhwc", xb, False))}
    boxes, probs = predict(forward(m_packed, xb2, input_s2d=True), cfg)
    post_ms = time_ms(lambda: nms.batched_postprocess(
        boxes, probs, cfg.conf_thresh, cfg.nms_thresh, cfg.pre_nms_top_k,
        cfg.top_k), 5)
    del boxes, probs, detect, detect_nhwc
    torch.cuda.empty_cache()
    ops = {}
    if version == "tiny_yolo_v3":  # conv_6's output, 13² x 512
        c = torch.randint(-128, 128, (batch, 13, 13, 512), dtype=torch.int8,
                          device="cuda")
        if not torch.equal(fp.int_zero_pad_maxpool_s1(c).cpu(),
                           fp.int_zero_pad_maxpool_s1(c.cpu())):
            raise AssertionError("7: int_zero_pad_maxpool_s1 on the card "
                                 "differs from the CPU")
        names, dev_ms = profiled(lambda: fp.int_zero_pad_maxpool_s1(c), 5)
        ops["int_zero_pad_maxpool_s1"] = dict(
            ms=time_ms(lambda: fp.int_zero_pad_maxpool_s1(c), 10),
            device_ms=dev_ms, kernels=[n[:120] for n in names],
            equal_cpu=True,
            bound_ms=1e3 * 2 * c.numel() / peak_bw)
    times = family7_conv_times(version, m_packed, forward, xb, xb2, peak_ops,
                               peak_bw, max_err)
    emit("family7_serving", version=version, batch=batch,
         heads_bit_exact=["nhwc", "s2d"], valid_slots=valid,
         images_per_sec=ips, backbone_ms_per_batch=backbone_ms,
         postprocess_ms=post_ms,
         launches_per_forward={
             layout: family7_launches(version, layout == "s2d")
             for layout in ("s2d", "nhwc")},
         packs_at_setup=dict(zip(FAMILY7_PACKS, packs_at_setup)),
         packs_in_loop=0,
         wgmma_parts_and_pooled={k: v for k, v in times.items()
                                 if k in FAMILY7_DEVICE_LINES},
         torch_ops=ops, card=card)
    return runs, times


def phase_family7_pc(version, card, max_err):
    """7d: the family with per-channel weight scales on its per-channel
    416² fixture (weights rebuilt from its seed): the heads of its 2
    images through the CUDA forward bit-exact with the JAX package's, the
    detect fn's detections the fixture's, served at the family's batch on
    NHWC input with every conv on the per-column form of its kernel (the
    packs and shift tables made when the detect fn took the model, none
    in the loop); then every conv of one forward on its real input against
    its plain version, timed. -> (the serving runs' launches, {line:
    per-forward sums})."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_models as tim

    f = FAMILY7[version]
    peak_ops, peak_bw = peaks(torch.cuda.get_device_name(0))
    g = load_fixture(f["pc_fixture"])
    cfg = get_config(version, "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    m = getattr(convert, f["from_seed"])(g, device="cuda")
    if not (m.per_channel and all(np.ndim(sw) for sw in m.sw.values())):
        raise AssertionError(f"7d {version}: the fixture's sw is not "
                             f"per-channel")
    forward, maker = getattr(tim, f["forward"]), getattr(tim, f["maker"])
    x_q = fp.quantize_input(torch.as_tensor(fixture_images(
        g, g["head_q_1"].shape[0])).cuda(), m.sa["in"]).contiguous()
    m_packed = m.to("cuda")
    m_packed.pack()
    heads = forward(m_packed, x_q)
    for i, (head, name) in enumerate(zip(heads, f["heads"])):
        check_head(torch.round(head * 2.0 ** m.sa[name]).to(torch.int8),
                   g[f"head_q_{i + 1}"], f"7d {version} head {i + 1}")
    reset_family7_packs()
    detect = eager(maker(m, cfg, device="cuda"))
    packs_at_setup = family7_packs()
    want = family7_launches(version, False, per_channel=True)
    out, _ = served_once(detect, x_q, want, f"7d {version} served")
    valid = check_detections(out, g)
    gen = torch.Generator(device="cuda").manual_seed(4)
    xb = fp.quantize_input(torch.rand((f["batch"], SIZE, SIZE, 3),
                                      generator=gen, device="cuda"),
                           m.sa["in"]).contiguous()
    reset_family7_packs()
    rate, entries, out = serve_loop(detect, xb)
    if per_forward(entries, SERVE_ITERS) != {**want, **nms_launches(1)}:
        raise AssertionError(f"7d {version} serving launched "
                             f"{per_forward(entries, SERVE_ITERS)} per "
                             f"forward, want {want}")
    if any(family7_packs()):
        raise AssertionError(f"7d {version}: serving packed weights or made "
                             f"shift tables {family7_packs()}")
    if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
        raise AssertionError(f"7d {version}: detections not finite")
    backbone_ms = time_ms(lambda: forward(m_packed, xb), 5)
    del detect, out
    torch.cuda.empty_cache()
    times = family7_conv_times(f"{version} per-channel", m_packed, forward,
                               xb, None, peak_ops, peak_bw, max_err)
    emit("family7_pc_serving", version=version, batch=f["batch"],
         heads_bit_exact=True, valid_slots=valid, images_per_sec=rate,
         backbone_ms_per_batch=backbone_ms, launches_per_forward=want,
         packs_at_setup=dict(zip(FAMILY7_PACKS, packs_at_setup)),
         packs_in_loop=0, tables_in_loop=0, card=card)
    return [entries], times


def check_named_tables(m, g, what):
    """An Int8Tiny / Int8YoloV2's tables and weights' sha256 equal to the
    fixture's (the JAX package's)."""
    from yolo_tpu_torch.quant.convert import weights_sha256

    for table in SLIM_TABLES:
        for k, v in getattr(m, table).items():
            if not np.array_equal(np.asarray(v), g[f"{table}.{k}"]):
                raise AssertionError(f"{what}: {table}.{k} = {v}, the JAX "
                                     f"package's {g[f'{table}.{k}']}")
    order = m.CONV_ORDER
    digest = weights_sha256([m.w_q[n].cpu().numpy() for n in order],
                            [m.b_q[n].cpu().numpy() for n in order])
    if digest != str(g["wb_sha256"]):
        raise AssertionError(f"{what}: int8 weights' sha256 {digest}, the "
                             f"JAX package's {g['wb_sha256']}")


def phase_ptq_family7(version, card):
    """The port's PTQ of the family on the card from the fixture's seed and
    images: every table and the weights' sha256 equal to the fixture's,
    the model served once (its launches checked), detections the
    fixture's. -> that run's launches."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_models as tim

    f = FAMILY7[version]
    g = load_fixture(f["fixture"])
    cfg = get_config(version, "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = fixture_images(g, g["head_q_1"].shape[0])
    model = getattr(convert, f["from_params"])(getattr(convert, f["seeded"])(
        int(g["weight_seed"]), int(g["pred_out"])), device="cuda")
    m, secs = timed(lambda: getattr(tim, f["pipeline"])(
        model, cfg, [images], fold_bn=False))
    check_named_tables(m, g, f"7 {version} PTQ")
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa["in"])
    out, entries = served_once(eager(getattr(tim, f["maker"])(
                                   m, cfg, device="cuda")),
                               x_q, family7_launches(version, False),
                               f"7 {version} PTQ served")
    emit("family7_ptq", version=version, images=len(images),
         pipeline_s=secs, float_ms_per_image=float_forward_ms(model, images),
         tables_equal=True, wb_sha256_equal=True,
         valid_slots=check_detections(out, g), launches_by_entry=entries,
         card=card)
    return entries


def phase_7(card, max_err):
    """Phase 7: tiny_yolo_v3 (7a) and yolo_v2 (7b) INT8 on the card, the
    port's PTQ of each, both with per-channel weight scales (7d), then
    ``cli.serve.main`` for both (7c). -> (every run's launches, {version,
    or version + ".pc" for 7d: {line: per-forward sums}})."""
    runs, times = [], {}
    for version in FAMILY7:
        served, times[version] = phase_family7(version, card, max_err)
        runs += served
        torch.cuda.empty_cache()
        runs.append(phase_ptq_family7(version, card))
        torch.cuda.empty_cache()
    for version in FAMILY7:
        served, times[version + ".pc"] = phase_family7_pc(version, card,
                                                          max_err)
        runs += served
        torch.cuda.empty_cache()
    runs += phase_serve_cli(card, CLI7)
    return runs, times


# ---------------------------------------------------------------------------
# The serving entry point's last slice (phase 8): the greedy NMS kernel,
# detect fns captured in CUDA graphs, artifacts, the float Detector and
# trained weights
# ---------------------------------------------------------------------------

# the NMS kernel's bytes a candidate (box 16, class 4 and valid 1 read,
# keep 1 written) and float operations an IoU test (two max, two min,
# three subtractions, two clamps, a product, a sum, a division)
NMS_BYTES, NMS_IOU_OPS = 22, 12
# the card's float32 rate outside the tensor cores (data sheet, FMA as 2)
PEAK_F32 = 67e12
# phase 8b's serving configurations (PERF.md §4): name -> (fixture,
# loader, config version, batch, input layout); the loader is
# "slim" (int8_model_from_arrays), "slim_pc" (int8_model_from_seed),
# "v3" (int8_yolo_v3_from_seed) or a FAMILY7 version
SERVED = {
    "slim_s2d": ("slim_int8_416_golden.npz", "slim", "slim_yolo_v2",
                 BATCH_SERVE, "s2d"),
    "slim_nhwc": ("slim_int8_416_golden.npz", "slim", "slim_yolo_v2",
                  BATCH_SERVE, "nhwc"),
    "slim_pc": (PC_FIXTURE, "slim_pc", "slim_yolo_v2", BATCH_SERVE, "nhwc"),
    "yolo_v3": (V3_FIXTURE, "v3", "yolo_v3", V3_BATCH_SERVE, "nhwc"),
    "yolo_v3_pc": (PCV3_FIXTURE, "v3", "yolo_v3", V3_BATCH_SERVE, "nhwc"),
    "yolo_v3_s2d": (V3_FIXTURE, "v3", "yolo_v3", V3_BATCH_SERVE, "s2d"),
    "yolo_v3_spp": (SPP_FIXTURE, "v3", "yolo_v3_spp", V3_BATCH_SERVE,
                    "s2d"),
    **{f"{v}_{layout}": (FAMILY7[v]["fixture"], v, v, FAMILY7[v]["batch"],
                         layout)
       for v in ("tiny_yolo_v3", "yolo_v2") for layout in ("s2d", "nhwc")},
    **{f"{v}_pc": (FAMILY7[v]["pc_fixture"], v, v, FAMILY7[v]["batch"],
                   "nhwc") for v in ("tiny_yolo_v3", "yolo_v2")},
}
# the configurations whose device idle share phase 8b reads
IDLE_SHARE = ("slim_s2d", "tiny_yolo_v3_s2d")
# the configurations whose candidates 8a also times at K = 512, and the
# batch: slim s2d at cli.serve's batch, tiny s2d at its serving batch
NMS_K512 = {"slim_s2d": SERVE_CLI_BATCH, "tiny_yolo_v3_s2d": BATCH_SERVE}


def served_model(name):
    """(int8 model on the card, its config, maker() -> detect fn,
    forward(x) -> heads from packed weights, an input batch) of a phase
    8b configuration, random images from a seed."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import convert
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_models as tim
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    fixture, loader, version, batch, layout = SERVED[name]
    g = load_fixture(fixture)
    s2d = layout == "s2d"
    cfg = get_config(version, "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    if loader in ("slim", "slim_pc"):
        m = (convert.int8_model_from_arrays(g, device="cuda")
             if loader == "slim" else
             convert.int8_model_from_seed(g, device="cuda"))
        mp = m.to("cuda")
        mp.pack_conv3x3()

        def maker():
            return make_int8_detect_fn(m, cfg, input_s2d=s2d, device="cuda")

        def forward(x):
            return [fp.int8_forward(mp, x, input_s2d=s2d)]
        sa = m.sa["in"]
    elif loader == "v3":
        m = convert.int8_yolo_v3_from_seed(g, device="cuda")
        mp = m.to("cuda")
        mp.pack_res_blocks()
        mp.pack_conv3x3s()

        def maker():
            return tv3.make_int8_yolo_v3_detect_fn(m, cfg, input_s2d=s2d,
                                                   device="cuda")

        def forward(x):
            return tv3.int8_yolo_v3_forward(mp, x, input_s2d=s2d)
        sa = m.sa_in
    else:
        f = FAMILY7[loader]
        m = getattr(convert, f["from_seed"])(g, device="cuda")
        mp = m.to("cuda")
        mp.pack()

        def maker():
            return getattr(tim, f["maker"])(m, cfg, input_s2d=s2d,
                                            device="cuda")

        def forward(x):
            return getattr(tim, f["forward"])(mp, x, input_s2d=s2d)
        sa = m.sa["in"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = fp.quantize_input(torch.rand((batch, SIZE, SIZE, 3), generator=gen,
                                     device="cuda"), sa).contiguous()
    if s2d:
        x = fp.s2d_input(x).contiguous()
    return m, cfg, maker, forward, x


def host_reads(fn) -> int:
    """The synchronizing calls (host reads) of one ``fn()`` call, as
    ``torch.cuda.set_sync_debug_mode('warn')`` reports them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")  # warns once that it is new
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # torch's message: "called a synchronizing CUDA operation"
    return sum("synchronizing" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def idle_share(fn, n: int = 5) -> float:
    """1 - (device busy time / host wall time) over ``n`` calls of ``fn``
    that end in a synchronize: the union of the CUDA kernels'
    ``torch.profiler`` intervals against the window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return 1.0 - busy / wall_us if spans else float("nan")


def decode_nms_ms(heads, cfg, plain: bool) -> float:
    """CUDA-event ms of decode + postprocess from ``heads``, greedy NMS on
    the kernel or (``plain``) on its plain version, the torch fixpoint
    the detect fns ran before this slice."""
    from yolo_tpu_torch.detector import predict
    from yolo_tpu_torch.ops import nms

    def post():
        boxes, probs = predict(heads, cfg)
        return nms.batched_postprocess(
            boxes, probs, cfg.conf_thresh, cfg.nms_thresh, cfg.pre_nms_top_k,
            cfg.top_k)

    kernel = nms.greedy_nms_keep
    if plain:
        nms.greedy_nms_keep = nms.greedy_nms_keep_plain
    try:
        return time_ms(post, 3 if plain else 5)
    finally:
        nms.greedy_nms_keep = kernel


def our_kernels() -> set:
    """The names of the repo's hand-written CUDA kernels: the
    ``__global__`` functions of ``yolo_tpu_torch/kernels/csrc``."""
    import glob
    import re

    import yolo_tpu_torch.kernels as kernels

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^()]*\)"
                     r"\s*)?(\w+)\s*\(")
    names = set()
    for path in glob.glob(os.path.join(os.path.dirname(kernels.__file__),
                                       "csrc", "*.cu*")):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    return names


def kernel_base(symbol: str) -> str:
    """A CUDA kernel's function name from its mangled symbol
    (``_ZN..._GLOBAL__N_...13conv3x3_wgmmaILi128E...`` -> ``conv3x3_wgmma``):
    the last name of its nested name, before its template arguments."""
    if not symbol.startswith("_Z"):
        return symbol
    nested = symbol.startswith("_ZN")
    i, name = 3 if nested else 2, symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
        if not nested:
            break
    return name


def graph_kernels(graph) -> dict:
    """{kernel function name: nodes} of a captured ``torch.cuda.CUDAGraph``
    (kept: ``keep_graph=True``), as the CUDA driver lists its kernel
    nodes, child graphs' included: what every replay of it launches."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                    ("kernelParams", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                    ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def check(rc, what):
        if rc != 0:
            raise AssertionError(f"{what}: CUDA driver error {rc}")

    out: dict = {}

    def walk(h):
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(vp(h), None, ctypes.byref(n)),
              "cuGraphGetNodes")
        nodes = (vp * n.value)()
        check(cu.cuGraphGetNodes(vp(h), nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            check(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value == 4:  # CU_GRAPH_NODE_TYPE_GRAPH
                child = vp()
                check(cu.cuGraphChildGraphNodeGetGraph(
                    vp(node), ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
            if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            p = KernelNodeParams()
            check(cu.cuGraphKernelNodeGetParams_v2(vp(node), ctypes.byref(p)),
                  "cuGraphKernelNodeGetParams")
            symbol = ctypes.c_char_p()
            check(cu.cuFuncGetName(ctypes.byref(symbol), vp(p.func))
                  if p.func else
                  cu.cuKernelGetName(ctypes.byref(symbol), vp(p.kern)),
                  "cuFuncGetName")
            name = kernel_base(symbol.value.decode())
            out[name] = out.get(name, 0) + 1

    walk(graph.raw_cuda_graph())
    return out


# check_replays' tally since the last phase line: graphs checked
REPLAY_CHECKS = {"replay_graphs_checked": 0}


def replay_tally() -> dict:
    """``REPLAY_CHECKS`` for a phase's line, then zeroed."""
    out = dict(REPLAY_CHECKS)
    REPLAY_CHECKS.update(dict.fromkeys(REPLAY_CHECKS, 0))
    return out


def check_replays(core, what) -> dict:
    """Holds what each graph of ``core`` (a ``utils.capture.CapturedFn``)
    runs against what its launch counts say. An eager call of ``core.fn``
    on the graph's input must go through the wrapper launches the graph
    recorded at its capture, and the graph's kernel nodes
    (``graph_kernels``: what a replay launches) must hold as many of the
    repo's hand-written kernels (``our_kernels``) as those wrappers
    launched. So the launches ``utils.capture.replayed_launches`` derives
    for the replays are launches of the card's. The check's own launches
    are taken back out of the counts. -> {kernel name: {C entry: launches
    a replay runs}}, summed over the graphs."""
    import yolo_tpu_torch.kernels as kernels

    ours = our_kernels()
    saved = kernels.entry_counts()
    per_replay: dict = {}
    try:
        for key, g in core.graphs.items():
            kernels.reset_launch_counts()
            core.fn(g.input)
            torch.cuda.synchronize()
            called = kernels.entry_counts()
            nodes = {n: c for n, c in graph_kernels(g.graph).items()
                     if n in ours}
            if (called != g.launches
                    or sum(nodes.values()) != sum(called.values())):
                raise AssertionError(
                    f"{what} {key[0]}: the graph holds {nodes}, an eager "
                    f"call went through the wrappers' {called}; the "
                    f"capture recorded {g.launches}")
            REPLAY_CHECKS["replay_graphs_checked"] += 1
            for (wrapper, entry), n in called.items():
                by = per_replay.setdefault(wrapper, {})
                by[entry] = by.get(entry, 0) + n
    finally:
        kernels.restore_entry_counts(saved)
    return per_replay


def replayed_since(before: dict) -> dict:
    """The launches ``utils.capture.replayed_launches`` derived for the
    replays since it read ``before``."""
    from yolo_tpu_torch.utils import capture

    out: dict = {}
    for wrapper, by in capture.replayed_launches().items():
        for entry, n in by.items():
            d = n - before.get(wrapper, {}).get(entry, 0)
            if d:
                out.setdefault(wrapper, {})[entry] = d
    return out


def phase_captured(card):
    """8b: every served configuration's detect fn, captured whole in a
    CUDA graph, against its eager form (``eager``): detections
    ``torch.equal``; what a replay runs held to the launches it is
    credited with (``check_replays``); no wrapper launch in the captured
    serving loop, no host read in the eager call; images/sec both ways;
    decode + NMS ms with the NMS kernel and with the plain fixpoint; the
    device's idle share on slim s2d and tiny. -> (the eager serving loops'
    launches, {shape: NMS candidates} for 8a, the slim s2d and v3 models
    for 8c)."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.detector import predict
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.utils import capture

    runs, candidates, keep = [], {}, {}
    for name in SERVED:
        m, cfg, maker, forward, x = served_model(name)
        graphed = maker()
        uncaptured = eager(graphed)
        rate_e, entries_e, out_e = serve_loop(uncaptured, x)
        reads = host_reads(lambda: uncaptured(x))
        before = capture.replayed_launches()
        rate_c, entries_c, out_c = serve_loop(graphed, x)
        replayed = replayed_since(before)
        if not all(torch.equal(a, b) for a, b in zip(out_e, out_c)):
            raise AssertionError(f"8b {name}: captured detections differ "
                                 f"from the eager ones")
        once = per_forward(entries_e, SERVE_ITERS)
        calls = SERVE_WARMUP + SERVE_ITERS
        if entries_c or reads or replayed != {
                w: {e: n * calls for e, n in by.items()}
                for w, by in once.items()}:
            raise AssertionError(f"8b {name}: wrapper launches {entries_c} "
                                 f"in the captured loop, replayed "
                                 f"{replayed}, eager {entries_e}, host "
                                 f"reads {reads}")
        if entries_e.get("greedy_nms_keep") != {NMS_K: SERVE_ITERS}:
            raise AssertionError(f"8b {name}: NMS launches {entries_e}")
        per_replay = check_replays(graphed.captured, f"8b {name}")
        if per_replay != once:
            raise AssertionError(f"8b {name}: a replay runs {per_replay}, "
                                 f"an eager forward {once}")
        heads = forward(x)
        boxes, probs = predict(heads, cfg)
        candidates[name] = (*nms.nms_candidates(
            boxes, probs, cfg.conf_thresh, cfg.pre_nms_top_k)[1:],
            cfg.nms_thresh)
        # the NMS kernel at K = 512 (pre_nms_top_k's default): the CLI's
        # batch on slim s2d, and tiny's serving batch
        k_cli = get_config(cfg.name, "mask").pre_nms_top_k
        if name in NMS_K512:
            b = NMS_K512[name]
            candidates[f"{name}_b{b}_k{k_cli}"] = (*nms.nms_candidates(
                boxes[:b], probs[:b], cfg.conf_thresh, k_cli)[1:],
                cfg.nms_thresh)
        idle = ({"eager": idle_share(lambda: uncaptured(x)),
                 "captured": idle_share(lambda: graphed(x))}
                if name in IDLE_SHARE else None)
        emit("captured", config=name, batch=int(x.shape[0]),
             images_per_sec_eager=rate_e, images_per_sec_captured=rate_c,
             captured_equal_eager=True, host_reads_eager=reads,
             graphs=len(graphed.captured.graphs),
             launches_per_forward=once, replay_checked=per_replay,
             decode_nms_ms_plain=decode_nms_ms(heads, cfg, plain=True),
             decode_nms_ms_kernel=decode_nms_ms(heads, cfg, plain=False),
             valid_candidates=int(candidates[name][2].sum()),
             idle_share=idle, card=card)
        runs.append(entries_e)
        if name in ("slim_s2d", "yolo_v3"):
            keep[name] = (m, cfg, x)
        del uncaptured, graphed, out_e, out_c, heads, boxes, probs
        torch.cuda.empty_cache()
    return runs, candidates, keep


def nms_chain(b, k):
    """K same-class valid boxes in score order, each overlapping only its
    neighbours (IoU 0.25 > 0.2): greedy keeps every other one, the
    fixpoint needs about K sweeps."""
    x1 = torch.arange(k, dtype=torch.float32, device="cuda") * 0.6
    z = torch.zeros(k, device="cuda")
    boxes = torch.stack([x1, z, x1 + 1.0, z + 1.0], -1)
    return (boxes.expand(b, k, 4).contiguous(),
            torch.zeros((b, k), dtype=torch.int32, device="cuda"),
            torch.ones((b, k), dtype=torch.bool, device="cuda"))


def nms_ties(b, k, seed=0):
    """Boxes and classes on a coarse grid (equal boxes, equal IoUs), a
    fifth of the candidates not valid."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xy = torch.randint(0, 8, (b, k, 2), generator=gen, device="cuda") / 8.0
    wh = torch.randint(1, 4, (b, k, 2), generator=gen, device="cuda") / 8.0
    return (torch.cat([xy, xy + wh], -1).float().contiguous(),
            torch.randint(0, 2, (b, k), generator=gen, device="cuda",
                          dtype=torch.int32),
            torch.rand((b, k), generator=gen, device="cuda") > 0.2)


def nms_iou_tests(cls, valid) -> int:
    """The IoU tests the kernel makes on these inputs: pairs i < j of one
    class with i valid."""
    k = cls.shape[1]
    upper = torch.ones((k, k), dtype=torch.bool, device=cls.device).triu(1)
    same = cls[:, :, None] == cls[:, None, :]
    return int((same & upper & valid[:, :, None]).sum())


def phase_nms(card, candidates, max_err):
    """8a: the greedy NMS kernel (``csrc/nms_greedy.cu``) ``torch.equal``
    to its plain version (the Jacobi fixpoint, a host read a sweep) on
    the served configurations' real candidates, on the chain (K = 128,
    512, 1024) and on tied boxes with thresholds that are not exact in
    float32; each served shape timed, kernel and plain, beside its bound
    (``ms``: CUDA events around the call, the op's host work included;
    ``device_ms``: the kernel alone, ``torch.profiler``), and at K = 512
    slim s2d at cli.serve's batch and tiny s2d at its serving batch. ->
    the kernels line's times (slim s2d's shape) with the K = 512 shapes
    as its ``paths``."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.ops import nms

    cases = {f"{name} (nms_thresh {c[-1]})": c
             for name, c in candidates.items()}
    for b, k in ((1, 1024), (BATCH_SERVE, 128), (SERVE_CLI_BATCH, 512)):
        cases[f"chain B {b} K {k}"] = (*nms_chain(b, k), 0.2)
        for th in (0.3, 0.45, 0.7):
            cases[f"ties B {b} K {k} nms_thresh {th}"] = (*nms_ties(b, k),
                                                          th)
    times = {}
    for what, (boxes, cls, valid, th) in cases.items():
        K.reset_launch_counts()
        got = nms.greedy_nms_keep(boxes, cls, valid, th)
        want = nms.greedy_nms_keep_plain(boxes, cls, valid, th)
        if K.launch_counts()["greedy_nms_keep"] != 1 or not torch.equal(
                got, want):
            raise AssertionError(f"8a: the NMS kernel differs from its "
                                 f"plain version on {what}: "
                                 f"{int((got != want).sum())} candidates")
        if what.startswith("chain"):
            kept = got[0].nonzero().flatten().tolist()
            if kept != list(range(0, boxes.shape[1], 2)):
                raise AssertionError(f"8a: {what} kept {kept[:8]}...")
        if what.startswith("chain") or what.startswith("ties"):
            continue
        b, k = valid.shape
        t_bytes = b * k * NMS_BYTES / PEAK_BW
        t_ops = nms_iou_tests(cls, valid) * NMS_IOU_OPS / PEAK_F32
        names, device_ms = profiled(
            lambda: nms.greedy_nms_keep(boxes, cls, valid, th), 20)
        times[what.split(" ")[0]] = dict(
            batch=b, candidates=k, valid=int(valid.sum()),
            ms=time_ms(lambda: nms.greedy_nms_keep(boxes, cls, valid, th),
                       20),
            device_ms=device_ms, device_kernels=names,
            plain_ms=time_ms(lambda: nms.greedy_nms_keep_plain(
                boxes, cls, valid, th), 3),
            t_bytes=1e3 * t_bytes, t_ops=1e3 * t_ops,
            bound_ms=1e3 * max(t_bytes, t_ops))
    max_err["greedy_nms_keep"] = 0  # every case torch.equal
    emit("nms_kernel", cases=len(cases), all_equal=True, shapes=times,
         card=card)
    line = {f: times["slim_s2d"][f] for f in ("ms", "device_ms", "plain_ms",
                                              "t_bytes", "t_ops", "bound_ms")}
    paths = {k: dict(t, library_ms=None) for k, t in times.items()
             if k not in SERVED}
    return {"greedy_nms_keep": dict(line, library_ms=None, paths=paths)}


def phase_artifacts(card, keep):
    """8c: ``serving.export.save_artifact`` -> ``load_artifact`` of slim on
    the s2d layout at batch 256 and yolo_v3 at 128: the loaded program's
    outputs ``torch.equal`` to the live detect fn's, its images/sec
    (captured), what the replays run held to their credited launches
    (``check_replays``), then ``cli.serve --artifact`` on the slim one. ->
    the launches of the artifacts' warm-up calls and of the CLI run."""
    import tempfile

    from yolo_tpu_torch.cli import serve
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.dispatch import input_scale_exponent
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
    from yolo_tpu_torch.serving.export import load_artifact, save_artifact

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (m, cfg, x) in keep.items():
            s2d = name == "slim_s2d"
            live = (make_int8_detect_fn(m, cfg, input_s2d=True)
                    if s2d else tv3.make_int8_yolo_v3_detect_fn(m, cfg))
            meta = {"input": "s2d" if s2d else "int8",
                    "sa_in": input_scale_exponent(m),
                    "batch": int(x.shape[0]), "input_size": [SIZE, SIZE],
                    "version": cfg.name}
            path = f"{tmp}/{name}.pt2"
            _, export_s = timed(lambda: save_artifact(live, x, path,
                                                      meta=meta))
            (serve_fn, got_meta), load_s = timed(
                lambda: load_artifact(path, with_meta=True))
            K.reset_launch_counts()
            got = serve_fn(x)  # captured here
            runs.append(K.launch_counts_by_entry())  # its warm-up calls
            want = live(x)
            if got_meta != meta or not all(
                    torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"8c {name}: the artifact's outputs "
                                     f"differ from the live detect fn's")
            per_replay = check_replays(serve_fn.captured, f"8c {name}")
            if per_replay != check_replays(live.captured,
                                           f"8c {name} live"):
                raise AssertionError(f"8c {name}: the artifact's replay "
                                     f"runs {per_replay}, the live fn's "
                                     f"another")
            rate, _, _ = serve_loop(serve_fn, x)
            rate_live, _, _ = serve_loop(live, x)
            emit("artifact", config=name, batch=int(x.shape[0]),
                 megabytes=os.path.getsize(path) / 1e6, export_s=export_s,
                 load_s=load_s, equal_live=True,
                 images_per_sec_artifact=rate,
                 images_per_sec_live_captured=rate_live,
                 launches_per_replay=per_replay, card=card)
            if s2d:
                argv = ["--artifact", path, "--iters", "2"]
                K.reset_launch_counts()
                res = serve.main(argv)
                runs.append(K.launch_counts_by_entry())
                emit("serve_cli_artifact", argv=argv[2:], fps=res["fps"],
                     batch=res["detector"].batch_size,
                     launches_by_entry=runs[-1],
                     launches_per_replay=check_replays(
                         res["detector"].detect_fn.captured,
                         "8c cli.serve --artifact"), card=card)
            del live, serve_fn, got, want
            torch.cuda.empty_cache()
    return runs


def phase_float_and_trained(card):
    """8d: ``cli.serve --fp32`` for slim and yolo_v3 (the float Detector,
    captured), and ``--trained_model`` from a checkpoint the port's
    ``save_checkpoint`` wrote of the CLI's own seeded weights: its detect
    fn equal to the one the CLI builds without the checkpoint. -> the
    launches of the runs."""
    import tempfile

    from yolo_tpu_torch.cli import serve
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant.convert import module_to_params
    from yolo_tpu_torch.quant.dispatch import init_float_model
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint

    runs = []
    base = ["--input_size", str(SIZE), str(SIZE), "--batch",
            str(SERVE_CLI_BATCH), "--iters", "3"]
    for version in ("slim_yolo_v2", "yolo_v3"):
        argv = ["-v", version, "--fp32", *base]
        K.reset_launch_counts()
        res, main_s = timed(lambda: serve.main(argv))
        runs.append(K.launch_counts_by_entry())
        if set(runs[-1]) != {"greedy_nms_keep"}:
            raise AssertionError(f"8d --fp32 {version} launched "
                                 f"{runs[-1]}: only the NMS kernel serves "
                                 f"the float Detector")
        emit("serve_cli_fp32", version=version, fps=res["fps"],
             fps_sequential=res["fps_sequential"], main_s=main_s,
             launches_by_entry=runs[-1],
             launches_per_replay=check_replays(
                 res["detector"].detect_fn.captured, f"8d --fp32 {version}"),
             card=card)
        del res
        torch.cuda.empty_cache()
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE))
    model = init_float_model("slim_yolo_v2", cfg, "cuda",
                             torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/slim.msgpack"
        save_checkpoint(path, module_to_params(model), extra={"seed": 0})
        argv = ["--trained_model", path, *base]
        K.reset_launch_counts()
        res, main_s = timed(lambda: serve.main(argv))
        runs.append(K.launch_counts_by_entry())
        default, _ = serve.build(serve.parse_args(base))
        x = torch.from_numpy(default.preprocess(
            synthetic_frames(SERVE_CLI_BATCH))).cuda()
        if not all(torch.equal(a, b) for a, b in zip(
                res["detector"].detect_fn(x), default.detect_fn(x))):
            raise AssertionError("8d: --trained_model of the CLI's seeded "
                                 "weights detects otherwise than the CLI")
        emit("serve_cli_trained", fps=res["fps"],
             fps_sequential=res["fps_sequential"], main_s=main_s,
             equal_seeded_cli=True, launches_by_entry=runs[-1],
             launches_per_replay=check_replays(
                 res["detector"].detect_fn.captured, "8d --trained_model"),
             card=card)
    return runs


def phase_8(card, max_err):
    """Phase 8 (8b, 8a, 8c, 8d) -> (every run's launches, the NMS
    kernel's times)."""
    runs, candidates, keep = phase_captured(card)
    times = phase_nms(card, candidates, max_err)
    runs += phase_artifacts(card, keep)
    del keep
    torch.cuda.empty_cache()
    runs += phase_float_and_trained(card)
    return runs, times


# ---------------------------------------------------------------------------
# The evaluation path (phase 9): synthetic images through VOCEvaluator and
# the CLI's detect fns, INT8 on the hand-written kernels
# ---------------------------------------------------------------------------

# 9a: slim's images, evaluation batch, and the images held to the CPU
EVAL_IMAGES, EVAL_BATCH, EVAL_CPU_IMAGES = 256, 64, 16
# 9b: the other families' images (one batch); (version, -q)
EVAL_OTHER_IMAGES = 64
EVAL_OTHERS = (("slim_yolo_v2", False), ("tiny_yolo_v3", True),
               ("yolo_v2", True), ("yolo_v3", True))


def eval_forward(version):
    """Per-forward launches by wrapper and C entry of ``version``'s INT8
    detect fn on NHWC float32 input: slim's NHWC serving forward (phase
    4), yolo_v3's (4b), tiny_yolo_v3's and yolo_v2's (7), and one NMS."""
    if version.startswith("slim_yolo_v2"):
        out = {"int8_conv3x3_im2col": {POOL3: 3, POOL_NHWC: 1},
               "int8_conv3x3_requant": {WGMMA3: 6}}
    elif version == "yolo_v3":
        out = {"int8_res_block": {"yolo_int8_res_block": 23},
               "int8_conv_requant": {WGMMA3: 9, S2_3: 5, ENTRY3: 1,
                                     CONV1X1: 14}}
    else:
        out = family7_launches(version, s2d=False)
    return {**out, **nms_launches(1)}


def eval_build(version, quantize, n):
    """``cli.eval``'s detector of ``version`` on the card (the CLI's seeded
    weights, mask config, 416²; with ``quantize`` its family's PTQ on the
    stack of the first 16 images) and the CLI's synthetic recipe (seed 1,
    easy) at ``n`` images -> (args, cfg, dataset, model, detect fn,
    seconds to build)."""
    from yolo_tpu_torch.cli import eval as cli_eval
    from yolo_tpu_torch.cli.common import build_cfg
    from yolo_tpu_torch.data import BaseTransform, SyntheticDetection

    args = cli_eval.parse_args(["-v", version, "-d", "synthetic"]
                               + (["-q"] if quantize else []))
    cfg = build_cfg(args)
    dataset = SyntheticDetection(size=cfg.input_size,
                                 num_classes=cfg.num_classes,
                                 transform=BaseTransform(cfg.input_size),
                                 length=n, seed=1)
    (model, detect), seconds = timed(
        lambda: cli_eval.build_detect(args, cfg, dataset))
    return args, cfg, dataset, model, detect, seconds


def eval_capture(detect, cfg, batch):
    """The detect fn's one graph at the evaluation batch, captured on a
    zero batch before the evaluator runs (its capture, two eager warm-up
    forwards, is no evaluation cost) -> seconds."""
    h, w = cfg.input_size
    zeros = torch.zeros((batch, h, w, 3), device="cuda")
    _, seconds = timed(lambda: detect(zeros))
    return seconds


def eval_per_forward(detect, dataset, batch, want, what):
    """One eager forward of the detect fn on a batch of the dataset's
    images: its launches, zeroed just before and read just after, must be
    ``want``."""
    from yolo_tpu_torch.kernels import int8_conv as K

    x = torch.from_numpy(np.stack([dataset.pull_item(i)[0]
                                   for i in range(batch)])).cuda()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    eager(detect)(x)
    torch.cuda.synchronize()
    got = K.launch_counts_by_entry()
    if got != want:
        raise AssertionError(f"{what}: an eager forward launched {got}, "
                             f"want {want}")
    return got


def eval_pass_fields(ev, wall, n, batch):
    """The JSON fields of one evaluator pass: images/sec and ms per batch
    of each part of ``ev.seconds``."""
    batches = -(-n // batch)
    return dict(images_per_sec=n / wall, seconds=wall,
                ms_per_batch={k: 1e3 * v / batches
                              for k, v in ev.seconds.items()},
                mean_ap=ev.map)


def phase_eval_slim(card):
    """9a: slim_yolo_v2 INT8 evaluated on the card: ``cli.eval``'s detector
    (PTQ on the card), 256 synthetic images at batch 64 through
    ``VOCEvaluator(cache_device=True)``, two passes; per forward slim's
    NHWC serving launches and one NMS; the replays held to their recorded
    kernels; the first 16 images' detections and mAP held to the same
    evaluator's on the CPU route. -> the runs' wrapper launches (the
    evaluation passes are all replays)."""
    from yolo_tpu_torch.eval import VOCEvaluator
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
    from yolo_tpu_torch.utils import capture

    version = "slim_yolo_v2"
    K.reset_launch_counts()
    args, cfg, ds, m, detect, build_s = eval_build(version, True,
                                                   EVAL_IMAGES)
    capture_s = eval_capture(detect, cfg, EVAL_BATCH)
    want = eval_forward(version)
    eval_per_forward(detect, ds, EVAL_BATCH, want, "9a")
    setup = K.launch_counts_by_entry()  # the capture's warm-ups, the check
    ev = VOCEvaluator(ds, cfg.num_classes, cfg.input_size,
                      batch_size=EVAL_BATCH, cache_device=True)
    before = capture.replayed_launches()
    K.reset_launch_counts()
    passes = []
    for _ in range(2):
        mean_ap, wall = timed(lambda: ev.evaluate(detect))
        passes.append(eval_pass_fields(ev, wall, EVAL_IMAGES, EVAL_BATCH))
    calls = 2 * (-(-EVAL_IMAGES // EVAL_BATCH))
    replayed = replayed_since(before)
    wrapper = K.launch_counts_by_entry()
    if wrapper or replayed != {w: {e: n * calls for e, n in by.items()}
                               for w, by in want.items()}:
        raise AssertionError(f"9a: the evaluation's wrapper launches "
                             f"{wrapper} (want none: replays), replayed "
                             f"{replayed}, want {calls} x {want}")
    if passes[0]["mean_ap"] != passes[1]["mean_ap"]:
        raise AssertionError(f"9a: the cached pass scored "
                             f"{passes[1]['mean_ap']}, the first "
                             f"{passes[0]['mean_ap']}")
    per_replay = check_replays(detect.captured, "9a")
    if per_replay != want:
        raise AssertionError(f"9a: a replay runs {per_replay}, want {want}")
    # the first 16 images on the card and on the CPU route (the plain
    # versions), the same int8 model
    sub = type(ds)(size=ds.size, num_classes=ds.num_classes,
                   transform=ds.transform, length=EVAL_CPU_IMAGES, seed=1)
    evs = {dev: VOCEvaluator(sub, cfg.num_classes, cfg.input_size,
                             batch_size=EVAL_CPU_IMAGES)
           for dev in ("cuda", "cpu")}
    K.reset_launch_counts()
    evs["cuda"].evaluate(detect)
    runs = [setup, K.launch_counts_by_entry()]  # batch 16: a new graph
    (_, cpu_s) = timed(lambda: evs["cpu"].evaluate(
        make_int8_detect_fn(m, cfg, device="cpu")))
    n_dets = 0
    for cls_a, cls_b in zip(evs["cuda"].raw[0], evs["cpu"].raw[0]):
        for a, b in zip(cls_a, cls_b):
            if a.shape != b.shape:
                raise AssertionError(f"9a: {a.shape} detections on the "
                                     f"card, {b.shape} on the CPU")
            np.testing.assert_allclose(a[:, 4], b[:, 4], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_allclose(
                a[:, :4] / np.float32(SIZE), b[:, :4] / np.float32(SIZE),
                atol=1e-5, rtol=1e-5)
            n_dets += len(a)
    d_map = abs(evs["cuda"].map - evs["cpu"].map)
    if d_map > 1e-9 or n_dets == 0:
        raise AssertionError(f"9a: the first {EVAL_CPU_IMAGES} images score "
                             f"{evs['cuda'].map} on the card, "
                             f"{evs['cpu'].map} on the CPU ({n_dets} "
                             f"detections)")
    emit("eval_slim", version=version, images=EVAL_IMAGES, batch=EVAL_BATCH,
         input="nhwc float32", build_s=build_s, capture_s=capture_s,
         mean_ap=passes[0]["mean_ap"],
         class_aps=[float(a) for a in ev.class_aps],
         first_pass=passes[0], cached_pass=passes[1],
         launches_per_forward=want, launches_per_replay=per_replay,
         replayed=replayed,
         cpu_check=dict(images=EVAL_CPU_IMAGES, detections=n_dets,
                        mean_ap_card=evs["cuda"].map,
                        mean_ap_cpu=evs["cpu"].map, abs_diff=d_map,
                        cpu_seconds=cpu_s),
         card=card)
    return runs


def phase_eval_others(card):
    """9b: slim ``--fp32`` (the float Detector: cuDNN float32, TF32 off)
    and tiny_yolo_v3, yolo_v2 and yolo_v3 ``-q`` evaluated on the card, 64
    images each (one batch): mAP, images/sec, the INT8 ones' launches per
    forward their NHWC serving forward's, every graph's replay held to its
    recorded kernels. -> the runs' launches."""
    from yolo_tpu_torch.eval import VOCEvaluator
    from yolo_tpu_torch.kernels import int8_conv as K

    runs = []
    for version, quantize in EVAL_OTHERS:
        K.reset_launch_counts()
        args, cfg, ds, model, detect, build_s = eval_build(
            version, quantize, EVAL_OTHER_IMAGES)
        capture_s = eval_capture(detect, cfg, EVAL_OTHER_IMAGES)
        want = (eval_forward(version) if quantize else nms_launches(1))
        eval_per_forward(detect, ds, EVAL_OTHER_IMAGES, want,
                         f"9b {version}")
        ev = VOCEvaluator(ds, cfg.num_classes, cfg.input_size,
                          batch_size=EVAL_OTHER_IMAGES)
        mean_ap, wall = timed(lambda: ev.evaluate(detect))
        runs.append(K.launch_counts_by_entry())
        per_replay = check_replays(detect.captured, f"9b {version}")
        if per_replay != want:
            raise AssertionError(f"9b {version}: a replay runs {per_replay},"
                                 f" want {want}")
        emit("eval_family", version=version,
             engine="int8" if quantize else "fp32",
             images=EVAL_OTHER_IMAGES, batch=EVAL_OTHER_IMAGES,
             build_s=build_s, capture_s=capture_s,
             class_aps=[float(a) for a in ev.class_aps],
             **eval_pass_fields(ev, wall, EVAL_OTHER_IMAGES,
                                EVAL_OTHER_IMAGES),
             launches_per_forward=want, launches_per_replay=per_replay,
             card=card)
        del model, detect, ev
        torch.cuda.empty_cache()
    return runs


def write_eval_trees(root, n, cv2):
    """The CLI's first ``n`` synthetic images (raw BGR, 416²) as jpgs under
    ``root``: a VOC-format mask tree (``Mask``, split ``test``) and a
    COCO2017-layout tree (``coco``, ``val2017``), their boxes the
    annotations (label l as the mask class l, COCO category l + 1)."""
    import json

    from yolo_tpu_torch.data import SyntheticDetection
    from yolo_tpu_torch.data.voc import VOC_CLASSES_MASK

    ds = SyntheticDetection(size=(SIZE, SIZE), num_classes=2, length=n,
                            seed=1)
    voc = os.path.join(root, "Mask")
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(voc, sub))
    os.makedirs(os.path.join(root, "coco", "annotations"))
    os.makedirs(os.path.join(root, "coco", "val2017"))
    images, anns = [], []
    for i in range(n):
        img, target, h, w = ds.pull_item(i)
        cv2.imwrite(os.path.join(voc, "JPEGImages", f"{i:06d}.jpg"), img)
        cv2.imwrite(os.path.join(root, "coco", "val2017", f"{i + 1:012d}.jpg"),
                    img)
        objects = ""
        for x1, y1, x2, y2, label in target:
            px = [int(x1 * w) + 1, int(y1 * h) + 1, int(x2 * w),
                  int(y2 * h)]
            objects += (f"<object><name>{VOC_CLASSES_MASK[int(label)]}"
                        f"</name><difficult>0</difficult><bndbox>"
                        + "".join(f"<{k}>{v}</{k}>" for k, v in zip(
                            ("xmin", "ymin", "xmax", "ymax"), px))
                        + "</bndbox></object>")
            bw, bh = (x2 - x1) * w, (y2 - y1) * h
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(label) + 1,
                         "bbox": [float(x1 * w), float(y1 * h), float(bw),
                                  float(bh)],
                         "area": float(bw * bh), "iscrowd": 0})
        with open(os.path.join(voc, "Annotations", f"{i:06d}.xml"),
                  "w") as f:
            f.write(f"<annotation>{objects}</annotation>")
        images.append({"id": i + 1, "width": w, "height": h})
    with open(os.path.join(voc, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("".join(f"{i:06d}\n" for i in range(n)))
    with open(os.path.join(root, "coco", "annotations",
                           "instances_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "face"},
                                  {"id": 2, "name": "face_mask"}]}, f)


def phase_eval_clis(card):
    """9c: ``cli.eval.evaluate`` with ``-q`` on the CLI's default synthetic
    evaluation set (32 images, batch 32, on the card) returns and prints
    ``Mean AP``; ``cli.kmeans.main`` runs on the same set. Where cv2
    imports: ``cli.test`` and ``cli.demo`` draw and write jpgs, and 16
    synthetic images written as jpgs score through ``cli.eval -d mask
    --dataset_root`` (a VOC-format tree) and ``COCOEvaluator`` (a COCO
    tree). -> the runs' launches."""
    import contextlib
    import io
    import tempfile

    from yolo_tpu_torch.cli import eval as cli_eval
    from yolo_tpu_torch.cli import kmeans
    from yolo_tpu_torch.kernels import int8_conv as K

    argv = ["-d", "synthetic", "-q"]
    out = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        mean_ap, seconds = timed(lambda: cli_eval.evaluate(
            cli_eval.parse_args(argv)))
    runs = [K.launch_counts_by_entry()]
    printed = out.getvalue().splitlines()
    if f"Mean AP: {mean_ap:.4f}" not in printed:
        raise AssertionError(f"9c: cli.eval printed {printed[-3:]}, "
                             f"returned {mean_ap}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        anchors, avg_iou = kmeans.main(kmeans.parse_args(["-d",
                                                          "synthetic"]))
    if anchors.shape != (5, 2) or not 0 < avg_iou <= 1:
        raise AssertionError(f"9c: cli.kmeans gave {anchors}, {avg_iou}")
    emit("eval_cli", argv=argv, mean_ap=mean_ap, printed=printed[-1],
         seconds=seconds, launches_by_entry=runs[0], card=card)
    emit("kmeans_cli", argv=["-d", "synthetic"], avg_iou=avg_iou,
         anchors=anchors.tolist(), printed=out.getvalue().splitlines())
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        emit("test_demo_cli", ran=False,
             reason=f"cv2 does not import on this machine ({e}); "
                    f"tests/test_torch_eval_cli.py runs both on the CPU")
        return runs
    from yolo_tpu_torch.cli import demo
    from yolo_tpu_torch.cli import test as cli_test
    from yolo_tpu_torch.cli.common import build_cfg
    from yolo_tpu_torch.data import BaseTransform
    from yolo_tpu_torch.data.coco import COCODataset
    from yolo_tpu_torch.eval.coco_eval import COCOEvaluator

    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            K.reset_launch_counts()
            cli_test.test(cli_test.parse_args(
                ["-d", "synthetic", "-q", "--num_images", "2", "--output",
                 f"{tmp}/test"]))
            runs.append(K.launch_counts_by_entry())
            os.makedirs(f"{tmp}/imgs")
            frames = synthetic_frames(2)
            for i, frame in enumerate(frames):
                cv2.imwrite(f"{tmp}/imgs/{i}.jpg", frame)
            K.reset_launch_counts()
            demo.detect(demo.parse_args(["--path_to_img", f"{tmp}/imgs",
                                         "--path_to_save", f"{tmp}/demo"]))
            runs.append(K.launch_counts_by_entry())
        written = (sorted(os.listdir(f"{tmp}/test")),
                   sorted(os.listdir(f"{tmp}/demo")))
        if written != (["0.jpg", "1.jpg"], ["0.jpg", "1.jpg"]):
            raise AssertionError(f"9c: cli.test and cli.demo wrote "
                                 f"{written}")
        emit("test_demo_cli", ran=True, written=written, card=card)
        # the VOC-format and COCO datasets on jpgs cv2 decodes here:
        # cli.eval -d mask --dataset_root, and COCOEvaluator
        write_eval_trees(tmp, EVAL_CPU_IMAGES, cv2)
        argv = ["-d", "mask", "--dataset_root", tmp, "-q", "--batch_size",
                str(EVAL_CPU_IMAGES)]
        out = io.StringIO()
        K.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            voc_map, voc_s = timed(lambda: cli_eval.evaluate(
                cli_eval.parse_args(argv)))
            args = cli_eval.parse_args(["-d", "coco", "-q"])
            cfg = build_cfg(args)
            coco = COCODataset(f"{tmp}/coco", "instances_val2017.json",
                               "val2017", transform=BaseTransform(
                                   cfg.input_size))
            _, detect = cli_eval.build_detect(args, cfg, coco)
            (ap50, ap), coco_s = timed(lambda: COCOEvaluator(
                coco, batch_size=EVAL_CPU_IMAGES).evaluate(detect))
        runs.append(K.launch_counts_by_entry())
        if f"Mean AP: {voc_map:.4f}" not in out.getvalue().splitlines():
            raise AssertionError("9c: cli.eval -d mask printed no Mean AP")
        emit("eval_trees", images=EVAL_CPU_IMAGES, voc_argv=argv,
             voc_mean_ap=voc_map, voc_seconds=voc_s, coco_ap50=float(ap50),
             coco_ap50_95=float(ap), coco_seconds=coco_s, card=card)
    return runs


def phase_9(card):
    """Phase 9 (9a, 9b, 9c) -> every run's launches."""
    runs = phase_eval_slim(card)
    torch.cuda.empty_cache()
    runs += phase_eval_others(card)
    runs += phase_eval_clis(card)
    return runs


TRAIN_IMAGES, TRAIN_LOADER_BATCH = 64, 32
# (version, check batch against the CPU, timed batch)
TRAIN_MODELS = (("slim_yolo_v2", 4, 32), ("yolo_v3", 2, 16))
# each gradient leaf, card against CPU on the same branches: max abs
# error <= GRAD_BOUND x the leaf's largest |g|
GRAD_BOUND = 1e-3
# a branch the CPU would take otherwise (blocks.branch_context's flips)
# lies within FLIP_MARGIN x the layer's largest |x| of the leaky's zero or
# the pool window's maximum: float32 forwards on two devices part by a
# few ulps a layer (~1e-6 of the scale after 75 layers); a wrong branch
# (a sign error, a wrong argmax) by a share of the scale
FLIP_MARGIN = 1e-4


def train_raw(n):
    """``n`` synthetic-hard 416² samples, untransformed: (u8 BGR image,
    normalized boxes, labels)."""
    from yolo_tpu_torch.data.synthetic import SyntheticDetection

    ds = SyntheticDetection(size=(SIZE, SIZE), length=n, hard=True, seed=0)
    out = []
    for i in range(n):
        img, target, _, _ = ds.pull_item(i)
        out.append((img, target[:, :4], target[:, 4]))
    return out


def train_dataset(backend="auto"):
    """The synthetic-hard set at 416² through ``SSDAugmentation`` with
    uint8 output (normalized on the card), as ``cli.common`` builds a
    training set with ``u8``."""
    from yolo_tpu_torch.data import SSDAugmentation, SyntheticDetection

    return SyntheticDetection(
        size=(SIZE, SIZE), length=TRAIN_IMAGES, hard=True, seed=0,
        transform=SSDAugmentation((SIZE, SIZE), seed=0, normalize=False,
                                  backend=backend))


def phase_train_host(card):
    """10a: ``SSDAugmentation`` on the native and the numpy backend (float
    and uint8 output) over 64 synthetic-hard 416² images, the same boxes
    and labels, pixels within the JAX package's tolerances for the pair
    (5e-3 float, one uint8 level), ms per image each; then ``BatchLoader``
    at batch 32 in thread and process mode (forked after the CUDA context
    exists), equal batches for the same (seed, epoch), images/sec each."""
    from yolo_tpu_torch.data import BatchLoader, SSDAugmentation

    torch.zeros(1, device="cuda")  # the CUDA context exists before a fork
    start = time.perf_counter()
    raw = train_raw(TRAIN_IMAGES)
    fields = {}
    for normalize in (True, False):
        outs = {}
        for backend in ("native", "numpy"):
            aug = SSDAugmentation((SIZE, SIZE), seed=0, normalize=normalize,
                                  backend=backend)
            if aug._native_ok() != (backend == "native"):
                raise AssertionError(f"SSDAugmentation(backend={backend!r}) "
                                     f"did not run on {backend}")
            t0 = time.perf_counter()
            outs[backend] = [aug(*item) for item in raw]
            fields[f"{backend}_{'f32' if normalize else 'u8'}"
                   "_ms_per_image"] = (
                1e3 * (time.perf_counter() - t0) / TRAIN_IMAGES)
        err = 0.0
        for (i1, b1, l1), (i2, b2, l2) in zip(outs["native"], outs["numpy"]):
            if not (np.array_equal(b1, b2) and np.array_equal(l1, l2)):
                raise AssertionError("native and numpy augmentation drew "
                                     "different boxes or labels")
            if i1.dtype != i2.dtype or i1.shape != (SIZE, SIZE, 3):
                raise AssertionError(f"augmented images {i1.dtype} "
                                     f"{i1.shape} / {i2.dtype}")
            err = max(err, float(np.abs(i1.astype(np.float32)
                                        - i2.astype(np.float32)).max()))
        if err > (5e-3 if normalize else 1.0):
            raise AssertionError(f"native augmentation {err} off numpy's")
        fields[f"native_vs_numpy_{'f32' if normalize else 'u8'}"
               "_max_abs_diff"] = err

    batches = {}
    for workers, backend in (("thread", "auto"), ("process", "auto"),
                             ("process", "numpy")):
        loader = BatchLoader(train_dataset(backend), TRAIN_LOADER_BATCH,
                             num_workers=os.cpu_count() or 8, seed=0,
                             workers=workers)
        t0 = time.perf_counter()
        got = list(loader)
        fields[f"loader_{workers}_{backend}_images_per_s"] = (
            len(got) * TRAIN_LOADER_BATCH / (time.perf_counter() - t0))
        batches[workers, backend] = got
    for a, b in zip(batches["thread", "auto"], batches["process", "auto"]):
        if not (np.array_equal(a[0], b[0]) and all(
                np.array_equal(x, y) for x, y in zip(a[1], b[1]))):
            raise AssertionError("thread and process loaders gave "
                                 "different batches for one (seed, epoch)")
    images = batches["thread", "auto"][0][0]
    if images.dtype != np.uint8 or images.shape != (
            TRAIN_LOADER_BATCH, SIZE, SIZE, 3):
        raise AssertionError(f"loader batch {images.dtype} {images.shape}")
    emit("10a_train_host", seconds=time.perf_counter() - start,
         backend="native", images=TRAIN_IMAGES,
         loader_batch=TRAIN_LOADER_BATCH, loader_workers=os.cpu_count(),
         loader_modes_equal=True, cpu_threads=torch.get_num_threads(),
         card=card, **fields)
    return batches["thread", "auto"]


def train_model(version, device):
    """``version``'s float model with BN on ``device``, seeded weights
    (torch's conv bounds from ``Generator(0)``; BN from a second
    generator, away from the identity), pred for the mask config."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.ops import blocks
    from yolo_tpu_torch.quant.dispatch import init_float_model

    cfg = get_config(version, "mask", input_size=(SIZE, SIZE))
    model = init_float_model(version, cfg, device,
                             generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, blocks.Conv) and m.bn is not None:
                for t, lo, hi in ((m.bn.weight, 0.5, 1.5),
                                  (m.bn.bias, -0.2, 0.2),
                                  (m.bn.running_mean, -0.1, 0.1),
                                  (m.bn.running_var, 0.5, 1.5)):
                    t.copy_(torch.empty(t.shape).uniform_(lo, hi,
                                                          generator=g))
    return cfg, model


def train_step(model, cfg, images, gt, branches):
    """One training batch on the model's device (``images`` uint8, or
    normalized in the model's type), its forward inside
    ``branches`` (a ``blocks.branch_context``): loss_fn + backward ->
    ({component: value}, grads tree, params tree incl. BN stats)."""
    from yolo_tpu_torch.quant.convert import module_to_params
    from yolo_tpu_torch.train.trainer import TrainConfig, loss_fn

    dev = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    with branches:
        total, parts = loss_fn(model, cfg, TrainConfig(),
                               torch.as_tensor(images).to(dev), gt)
    total.backward()
    values = {k: v.item() for k, v in parts.items()}
    values["total"] = total.item()
    return (values, module_to_params(model, grads=True),
            module_to_params(model))


def tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k], f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}.{i}")
    else:
        yield path, tree


class conv_swap:
    """``with conv_swap(fn): ...`` runs the port's float convs through
    ``fn`` (``blocks.conv2d``'s signature) instead, then restores them."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from yolo_tpu_torch.ops import blocks

        self.plain = blocks.conv2d
        blocks.conv2d = self.fn
        return self

    def __exit__(self, *exc):
        from yolo_tpu_torch.ops import blocks

        blocks.conv2d = self.plain
        return False


def tf32_backward():
    """The float convs with the forward under ``fp32_precision`` and the
    backward on cuDNN's default TF32 (as the port ran them before it kept
    the backward in float32): the step's time beside float32's, and the
    control that the gradient check must fail."""
    from yolo_tpu_torch.ops import blocks

    def conv2d(x, w, b=None, stride=1, padding=0):
        with blocks.fp32_precision():
            out = torch.nn.functional.conv2d(x, w, None, stride=stride,
                                             padding=padding)
        return out if b is None else out + b.reshape(1, -1, 1, 1)

    return conv_swap(conv2d)


def gradient_errors(cpu, card):
    """[(max abs error / the leaf's largest |g|, path)] over the leaves
    with a nonzero CPU gradient, card against CPU; raises where a card
    leaf is not finite or every leaf is zero."""
    out = []
    for (path, want), (_, got) in zip(tree_leaves(cpu[1]),
                                      tree_leaves(card[1])):
        if not np.isfinite(got).all():
            raise AssertionError(f"gradient {path} not finite")
        scale = float(np.abs(want).max())
        if scale:
            out.append((float(np.abs(got - want).max()) / scale, path))
    if not out:
        raise AssertionError("every gradient is zero")
    return out


def check_flips(version, flips) -> dict:
    """The branches the CPU run would have taken otherwise
    (``blocks.branch_context(...).flips``): each within FLIP_MARGIN of
    the layer's scale, a tie broken by rounding. -> counts and the
    largest margin over the scale."""
    out = {"leaky_flips": 0, "pool_flips": 0, "flip_margin_worst": 0.0}
    for i, (kind, n, margin, scale) in enumerate(flips):
        if margin > FLIP_MARGIN * scale:
            raise AssertionError(
                f"{version} {kind} {i}: the card branched {n} elements off "
                f"the CPU by {margin} at a scale of {scale}")
        out[f"{kind}_flips"] = out.get(f"{kind}_flips", 0) + n
        if n:
            out["flip_margin_worst"] = max(out["flip_margin_worst"],
                                           margin / scale)
    return out


CONV_WORDS = ("conv", "xmma", "implicit", "wgrad", "dgrad", "fprop",
              "cudnn", "gemm", "winograd", "fft")


def step_breakdown(fn, n: int = 3) -> dict:
    """Device time of one ``fn()`` (a training step ending in a
    synchronize) by kernel class, from ``torch.profiler`` over ``n``
    calls after one warm-up: cuDNN's convs (fprop, dgrad, wgrad, by
    name), reductions (BN statistics, the loss's sums), everything else
    (elementwise: BN, leaky, pools, casts); the busy share of the host
    window, and the five kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / n
    classes = {"conv_ms": 0.0, "reduce_ms": 0.0, "other_ms": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("conv_ms" if any(w in low for w in CONV_WORDS) else
               "reduce_ms" if "reduce" in low or "welford" in low else
               "other_ms")
        classes[key] += ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_ms_per_step=device_ms, **classes,
                busy_share=device_ms / (wall_ms / n) if wall_ms else 0.0,
                distinct_kernels=len(by_name),
                top_kernels=[[name[:90], ms] for name, ms in top])


def phase_train_model(card, version, check_b, time_b, batch):
    """10b / 10c: ``version`` at 416² on one loader batch (uint8, to the
    card): ``build_targets``, the train forward under ``fp32_precision``,
    ``loss_fn``, ``backward()``; held to the CPU route in float64 on the
    same ``check_b`` images (the card's normalized floats) and weights
    (float32 sums over 416² images round off by ~1e-3 of a leaf's
    largest value on the CPU: conv1's weight gradient sums 692k
    products), the CPU's forward taking the card's branches (``blocks.branch_context``: each leaky's sign, each pool's
    argmax), and every branch it would take otherwise within FLIP_MARGIN
    (``check_flips``): the loss components within rtol 1e-4, each
    gradient leaf's max abs error within GRAD_BOUND of its largest |g|,
    the new BN running stats within rtol 1e-4 / atol 1e-5, all finite,
    the gradients not all zero. A control: the card's step with a TF32
    backward on the same branches must fail that gradient bound. Then
    forward + backward timed at ``time_b`` (median of 10 after 2
    warm-ups, CUDA events), float32 and the TF32 backward, with the
    card's peak memory and a ``torch.profiler`` breakdown."""
    from yolo_tpu_torch.detector import normalize_u8
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.ops import blocks
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import TrainConfig, loss_fn

    images, targets = batch
    t0 = time.perf_counter()
    cfg, card_model = train_model(version, "cuda")
    gt = build_targets(cfg, targets[:check_b])
    K.reset_launch_counts()
    card_branches = blocks.branch_context()
    card_run = train_step(card_model, cfg, images[:check_b], gt,
                          card_branches)
    launches = sum(K.launch_counts().values())
    t1 = time.perf_counter()
    # the reference: the CPU in float64 on the card's normalized input
    x64 = normalize_u8(torch.as_tensor(images[:check_b]).cuda()).cpu()
    cpu_branches = blocks.branch_context(card_branches.choices)
    cpu = train_step(train_model(version, "cpu")[1].double(), cfg,
                     x64.double(), gt, cpu_branches)
    t2 = time.perf_counter()
    flips = check_flips(version, cpu_branches.flips)
    for k, want in cpu[0].items():
        got = card_run[0][k]
        if not (math.isfinite(got) and abs(got - want) <= 1e-4 * abs(want)):
            raise AssertionError(f"{version} {k}: card {got}, cpu {want}")
    errs = gradient_errors(cpu, card_run)
    worst, path = max(errs)
    if worst > GRAD_BOUND:
        raise AssertionError(
            f"{version} gradient {path}: card-cpu max abs error {worst} of "
            f"the leaf's largest value > {GRAD_BOUND}")
    stats_err = 0.0
    for (path, want), (_, got) in zip(tree_leaves(cpu[2]),
                                      tree_leaves(card_run[2])):
        if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{version} {path} after the step: card "
                                 f"and cpu differ")
        stats_err = max(stats_err, float(np.abs(got - want).max()))
    with tf32_backward():
        control = train_step(train_model(version, "cuda")[1], cfg,
                             images[:check_b], gt,
                             blocks.branch_context(card_branches.choices))
    tf32_errs = gradient_errors(cpu, control)
    tf32_worst = max(tf32_errs)[0]
    if tf32_worst <= GRAD_BOUND:
        raise AssertionError(
            f"{version}: a TF32 backward passes the gradient check "
            f"(worst {tf32_worst} <= {GRAD_BOUND})")
    del control, card_branches, cpu_branches

    t3 = time.perf_counter()
    x = torch.as_tensor(images[:time_b]).cuda()
    gt_t = build_targets(cfg, targets[:time_b])

    def step():
        card_model.zero_grad(set_to_none=True)
        total, _ = loss_fn(card_model, cfg, TrainConfig(), x, gt_t)
        total.backward()

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, 10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with tf32_backward():
        tf32_ms = time_ms(step, 10)

    def synced_step():
        step()
        torch.cuda.synchronize()

    emit(f"10{'b' if version.startswith('slim') else 'c'}_train_{version}",
         check_batch=check_b, loss=card_run[0], loss_cpu=cpu[0],
         gradient_leaves=len(list(tree_leaves(cpu[1]))),
         nonzero_leaves=len(errs), grad_bound=GRAD_BOUND,
         grad_worst=worst, grad_worst_leaf=path,
         grad_median=statistics.median(e for e, _ in errs),
         tf32_backward_grad_worst=tf32_worst,
         tf32_backward_leaves_over_bound=sum(e > GRAD_BOUND
                                             for e, _ in tf32_errs),
         flip_margin_bound=FLIP_MARGIN, **flips,
         bn_stats_max_abs_diff=stats_err,
         kernel_launches=launches, timed_batch=time_b,
         fwd_bwd_ms=ms, images_per_s=1e3 * time_b / ms, peak_mem_gb=peak_gb,
         tf32_backward_ms=tf32_ms,
         breakdown=step_breakdown(synced_step), input=[SIZE, SIZE],
         seconds={"card_step": t1 - t0, "cpu_step": t2 - t1,
                  "checks_and_control": t3 - t2,
                  "timing": time.perf_counter() - t3},
         card=card)


def phase_10(card):
    """Phase 10: one training batch (10a host data, 10b slim_yolo_v2, 10c
    yolo_v3), with cuDNN's algorithm search off: earlier phases turn it
    on to time their yardsticks, and here it searched every conv's
    forward and backward for each new batch shape (phase 10 93.0 s with
    it, 37.2 s without, on the H100 machine)."""
    cudnn = torch.backends.cudnn
    search, cudnn.benchmark = cudnn.benchmark, False
    try:
        batches = phase_train_host(card)
        for (version, check_b, time_b), batch in zip(TRAIN_MODELS, batches):
            phase_train_model(card, version, check_b, time_b, batch)
            torch.cuda.empty_cache()
    finally:
        cudnn.benchmark = search


# 11a: slim at 416², the check batch; 11b: (version, batch, the forms
# timed); 11c: the guard recipe (tests/test_map_guard.py)
STEP_CHECK_B = 8
STEP_TIMES = (("slim_yolo_v2", 32, ("float32", "bf16", "remat",
                                    "fast_pool")),
              ("yolo_v3", 16, ("float32", "remat")))
STEP_FORMS = {"float32": {}, "bf16": {"compute_dtype": "bfloat16"},
              "remat": {"remat": True}, "fast_pool": {"fast_pool_cin": 32}}
GUARD_SIZE, GUARD_TRAIN, GUARD_BATCH, GUARD_EPOCHS = 64, 64, 16, 150
GUARD_VAL, GUARD_VAL_SEED, GUARD_HEAD_CLIP = 32, 99, 16.0
# the JAX package's guard (tests/test_map_guard.py:106-135): fp32 mAP
# above, the BN fold within, capped INT8 above fp32 less, capped above
# uncapped by
GUARD_FP32_MIN, GUARD_FOLD_TOL, GUARD_INT8_DROP, GUARD_CAP_GAIN = (
    0.30, 1e-9, 0.12, 0.05)
CLI_BATCH = 16  # 11e


def opt_leaves(model, state):
    """{path: float64 numpy} of a model's tree after a step (parameters
    and BN running stats) and of its optimizer's momentum trace."""
    from yolo_tpu_torch.quant.convert import module_to_params

    out = {f"params.{k}": np.asarray(v, np.float64)
           for k, v in tree_leaves(module_to_params(model))}
    trace = state.state_dict()["inner_state"]["1"]["0"]["trace"]
    out.update((f"trace.{k}", np.asarray(v, np.float64))
               for k, v in tree_leaves(trace))
    return out


def leaf_errors(got, want):
    """[(max abs error / the leaf's largest |value|, path)] over the
    leaves with a nonzero value; raises where one is not finite."""
    out = []
    for path, w in want.items():
        g = got[path]
        if not np.isfinite(g).all():
            raise AssertionError(f"{path} not finite")
        scale = float(np.abs(w).max())
        if scale:
            out.append((float(np.abs(g - w).max()) / scale, path))
    return out


def step_batch(n):
    """``n`` synthetic-hard 416² training images (uint8, SSDAugmentation)
    and their label lists."""
    ds = train_dataset()
    items = [ds.pull_item(i) for i in range(n)]
    return (np.stack([img for img, _, _, _ in items]),
            [np.asarray(t, np.float32).reshape(-1, 5) for _, t, _, _ in items])


def phase_step_check(card, images, targets):
    """11a: one ``make_train_step`` step of slim_yolo_v2 at 416², batch 8,
    on the card, held to the same step in float64 on the CPU on the
    card's normalized images and branches (``blocks.branch_context``):
    every parameter, running stat and momentum-trace leaf within
    GRAD_BOUND of its largest value; then the step with bf16 compute,
    its leaves against the float32 step's (reported only)."""
    from yolo_tpu_torch.detector import normalize_u8
    from yolo_tpu_torch.ops import blocks
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import TrainConfig, make_train_step

    version, lr = "slim_yolo_v2", 1e-3
    t0 = time.perf_counter()
    x = torch.as_tensor(images[:STEP_CHECK_B]).cuda()
    runs = {}
    for form in ("float32", "bf16"):
        cfg, model = train_model(version, "cuda")
        gt = build_targets(cfg, targets[:STEP_CHECK_B])
        opt, step = make_train_step(model, cfg,
                                    TrainConfig(**STEP_FORMS[form]))
        state = opt.init(model)
        with blocks.branch_context() as b:
            metrics = step(state, x, gt, lr)
        runs[form] = (opt_leaves(model, state),
                      {k: v.item() for k, v in metrics.items()}, b.choices)
    t1 = time.perf_counter()
    cfg, cpu_model = train_model(version, "cpu")
    cpu_model.double()
    opt, step = make_train_step(cpu_model, cfg, TrainConfig())
    state = opt.init(cpu_model)
    with blocks.branch_context(runs["float32"][2]) as b:
        cpu_metrics = step(state, normalize_u8(x).cpu().double(), gt, lr)
    flips = check_flips(version, b.flips)
    cpu = opt_leaves(cpu_model, state)
    t2 = time.perf_counter()
    card_leaves, card_metrics, _ = runs["float32"]
    for k, v in cpu_metrics.items():
        got = card_metrics[k]
        if not (math.isfinite(got) and abs(got - v.item()) <= 1e-4 * abs(
                v.item())):
            raise AssertionError(f"11a {k}: card {got}, cpu {v.item()}")
    errs = leaf_errors(card_leaves, cpu)
    worst, path = max(errs)
    if worst > GRAD_BOUND:
        raise AssertionError(f"11a {path}: card-cpu max abs error {worst} "
                             f"of the leaf's largest value > {GRAD_BOUND}")

    def kind(p):
        return ("trace" if p.startswith("trace") else
                "stats" if p.endswith((".mean", ".var")) else "weights")

    by_kind = {k: max(e for e, p in errs if kind(p) == k)
               for k in ("weights", "stats", "trace")}
    bf16 = leaf_errors(runs["bf16"][0], card_leaves)
    emit("11a_step_check", version=version, batch=STEP_CHECK_B,
         input=[SIZE, SIZE], lr=lr, leaves=len(cpu),
         bound=GRAD_BOUND, worst=worst, worst_leaf=path,
         worst_by_kind=by_kind,
         median=statistics.median(e for e, _ in errs),
         loss=card_metrics, loss_cpu={k: v.item()
                                      for k, v in cpu_metrics.items()},
         **flips,
         bf16_vs_float32=dict(
             worst=max(bf16)[0], worst_leaf=max(bf16)[1],
             median=statistics.median(e for e, _ in bf16),
             worst_by_kind={k: max(e for e, p in bf16 if kind(p) == k)
                            for k in ("weights", "stats", "trace")},
             loss=runs["bf16"][1]),
         seconds={"card": t1 - t0, "cpu": t2 - t1}, card=card)


def phase_step_times(card, images, targets):
    """11b: ``make_train_step`` steps at full width, 416²: slim_yolo_v2 at
    batch 32 in float32, bf16, remat and fast_pool_cin=32, yolo_v3 at
    batch 16 in float32 and remat: ms a step (median of 5 after 2
    warm-ups, CUDA events), images/sec, the card's peak memory."""
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import TrainConfig, make_train_step

    out = {}
    for version, batch, forms in STEP_TIMES:
        cfg, model = train_model(version, "cuda")
        x = torch.as_tensor(images[:batch]).cuda()
        gt = torch.as_tensor(build_targets(cfg, targets[:batch])).cuda()
        for form in forms:
            opt, step = make_train_step(model, cfg,
                                        TrainConfig(**STEP_FORMS[form]))
            state = opt.init(model)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: step(state, x, gt, 1e-4), 5)
            out[f"{version}.{form}"] = dict(
                batch=batch, ms_per_step=ms, images_per_s=1e3 * batch / ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model
        torch.cuda.empty_cache()
    emit("11b_step_times", input=[SIZE, SIZE], steps=out, card=card)


def guard_data():
    """The JAX package's guard data at 64²: the training set (64 easy
    synthetic images), the validation evaluator (32 images, seed 99) and
    two calibration batches of 16."""
    from yolo_tpu_torch.data import BaseTransform, BatchLoader
    from yolo_tpu_torch.data.synthetic import SyntheticDetection
    from yolo_tpu_torch.eval import VOCEvaluator

    size = (GUARD_SIZE, GUARD_SIZE)
    train = SyntheticDetection(size, num_classes=2, length=GUARD_TRAIN,
                               transform=BaseTransform(size))
    val = SyntheticDetection(size, num_classes=2, length=GUARD_VAL,
                             transform=BaseTransform(size),
                             seed=GUARD_VAL_SEED)
    calib = SyntheticDetection(size, num_classes=2, length=2 * GUARD_BATCH,
                               transform=BaseTransform(size))
    calib_batches = [imgs for imgs, _ in BatchLoader(
        calib, GUARD_BATCH, shuffle=False, num_workers=0)]
    return train, VOCEvaluator(val, 2, size, batch_size=GUARD_VAL), \
        calib_batches


class deterministic_algorithms:
    """torch's deterministic algorithms, cuDNN's included, inside the
    block (the flags as they were after it). The guard's 150 epochs are
    chaotic: one sum taken in another order moves its fp32 mAP by ~0.1.
    On an H100 cuDNN's default weight-gradient algorithms sum in an order
    that varies from run to run, so each run of one seed is another draw
    (``PERF.md`` §6, the trainer's findings); the JAX guard takes one
    draw, as XLA on the CPU is deterministic, and this takes one too."""

    def __enter__(self):
        self.was = (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled(),
                    torch.backends.cudnn.deterministic)
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        on, warn_only, cudnn = self.was
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
        torch.backends.cudnn.deterministic = cudnn


def state_digest(model) -> str:
    """sha256 of ``model``'s state dict (parameters and BN stats), in
    key order."""
    import hashlib

    h = hashlib.sha256()
    for key, value in sorted(model.state_dict().items()):
        h.update(key.encode())
        h.update(value.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def guard_train(device, seed=0, deterministic=True):
    """The guard's slim_yolo_v2 (mask config, 64², the port's init from
    ``seed``) trained by ``train_device_resident``, under
    ``deterministic_algorithms`` unless ``deterministic`` is false: 150
    epochs of 64 images at batch 16, lr 1e-3, warmup 2, cos. -> (cfg,
    model, seconds, last metrics)."""
    import contextlib

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant.dispatch import init_float_model
    from yolo_tpu_torch.train.trainer import (TrainConfig,
                                              train_device_resident)

    cfg = get_config("slim_yolo_v2", "mask",
                     input_size=(GUARD_SIZE, GUARD_SIZE), conf_thresh=0.01)
    model = init_float_model("slim_yolo_v2", cfg, device,
                             generator=torch.Generator().manual_seed(seed))
    train, _, _ = guard_data()
    tc = TrainConfig(base_lr=1e-3, wp_epoch=2, cos=True,
                     max_epoch=GUARD_EPOCHS)
    t0 = time.perf_counter()
    with (deterministic_algorithms() if deterministic
          else contextlib.nullcontext()):
        model, last = train_device_resident(model, cfg, tc, train,
                                            GUARD_BATCH, verbose=False)
        if model.conv1.conv.weight.is_cuda:
            torch.cuda.synchronize()
    return cfg, model, time.perf_counter() - t0, last


def guard_scores(cfg, model, device):
    """The guard's float stages on ``model``: the fp32 mAP and the
    BN-folded model's; and the port's PTQ of it, uncapped and with
    head_clip 16 on two calibration batches. -> ({stage: mAP}, {stage:
    INT8 model}, the evaluator)."""
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
    from yolo_tpu_torch.quant.convert import module_to_params, slim_from_params
    from yolo_tpu_torch.quant.int8_graph import quantize_pipeline

    _, ev, calib = guard_data()
    maps = {"fp32": ev.evaluate(Detector(cfg, model=model,
                                         device=device).detect_fn())}
    fused = slim_from_params(fold_batch_norm(module_to_params(model)),
                             device=device)
    maps["bn_fold"] = ev.evaluate(Detector(cfg, model=fused, batch_norm=False,
                                           device=device).detect_fn())
    int8 = {stage: quantize_pipeline(model, cfg, calib, head_clip=clip)
            for stage, clip in (("int8_uncapped", None),
                                ("int8_capped", GUARD_HEAD_CLIP))}
    return maps, int8, ev


def same_detections(ev_a, ev_b, where) -> int:
    """Two evaluators' detections of one pass (as 9a holds them): as many
    per class and image, boxes and scores within 1e-5 (the decode's float
    math on two devices). -> how many."""
    n = 0
    for cls_a, cls_b in zip(ev_a.raw[0], ev_b.raw[0]):
        for a, b in zip(cls_a, cls_b):
            if a.shape != b.shape:
                raise AssertionError(f"{where}: {a.shape} detections on the "
                                     f"card, {b.shape} on the CPU")
            np.testing.assert_allclose(a[:, 4], b[:, 4], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_allclose(
                a[:, :4] / np.float32(GUARD_SIZE),
                b[:, :4] / np.float32(GUARD_SIZE), atol=1e-5, rtol=1e-5)
            n += len(a)
    return n


def s2d_detect(m, cfg, device):
    """``make_int8_detect_fn`` on the s2d input, from normalized float
    NHWC images (quantized at the model's input scale and laid out on the
    device)."""
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    detect = make_int8_detect_fn(m, cfg, input_s2d=True, device=device)
    sa_in = int(m.sa["in"])

    def run(images):
        x = torch.as_tensor(images).to(device)
        return detect(fp.s2d_input(fp.quantize_input(x, sa_in)))

    run.captured = detect.captured
    return run


def guard_asserts(maps, where):
    """The JAX package's guard on ``maps``."""
    fails = []
    if not maps["fp32"] > GUARD_FP32_MIN:
        fails.append(f"fp32 mAP {maps['fp32']} <= {GUARD_FP32_MIN}")
    if not abs(maps["bn_fold"] - maps["fp32"]) < GUARD_FOLD_TOL:
        fails.append(f"BN fold {maps['bn_fold']} vs fp32 {maps['fp32']}")
    if not maps["int8_capped"] > maps["fp32"] - GUARD_INT8_DROP:
        fails.append(f"capped INT8 {maps['int8_capped']} vs fp32 "
                     f"{maps['fp32']}")
    if not maps["int8_capped"] - maps["int8_uncapped"] > GUARD_CAP_GAIN:
        fails.append(f"capped {maps['int8_capped']} - uncapped "
                     f"{maps['int8_uncapped']} <= {GUARD_CAP_GAIN}")
    if fails:
        raise AssertionError(f"{where}: " + "; ".join(fails))


def phase_guard(card):
    """11c / 11d: the JAX package's map guard recipe on the card, trained
    by the port twice (deterministically: both runs must land on the same
    state); its INT8 models scored through the kernels, then on the
    CPU route on the same images: detections and mAP equal. -> the runs'
    wrapper launches."""
    from yolo_tpu_torch.eval import VOCEvaluator
    from yolo_tpu_torch.kernels import int8_conv as K

    cfg, model, train_s, last = guard_train("cuda")
    # the draw is the code's, not the run's: a second run lands on the
    # same bits
    digest = state_digest(model)
    again = state_digest(guard_train("cuda")[1])
    if again != digest:
        raise AssertionError(f"11c: two deterministic runs of the recipe "
                             f"differ: {digest[:16]} {again[:16]}")
    t0 = time.perf_counter()
    maps, int8, ev = guard_scores(cfg, model, "cuda")
    runs, launches, replayed, cpu = [], {}, {}, {}
    for stage, m in int8.items():
        K.reset_launch_counts()
        detect = s2d_detect(m, cfg, "cuda")
        maps[stage] = ev.evaluate(detect)
        torch.cuda.synchronize()
        runs.append(K.launch_counts_by_entry())
        launches[stage] = runs[-1]
        replayed[stage] = check_replays(detect.captured, f"11c {stage}")
        for kernel, entry in (("int8_conv3x3_pool_requant", POOL_S2D),
                              ("int8_conv3x3_im2col", POOL3),
                              ("int8_conv3x3_requant", WGMMA3)):
            if not runs[-1].get(kernel, {}).get(entry):
                raise AssertionError(f"11c {stage}: no launch of {kernel} "
                                     f"on {entry}: {runs[-1]}")
        # 11d: the same model and images on the CPU route
        ev_cpu = VOCEvaluator(ev.dataset, 2, cfg.input_size,
                              batch_size=GUARD_VAL)
        map_cpu = ev_cpu.evaluate(s2d_detect(m, cfg, "cpu"))
        n = same_detections(ev, ev_cpu, f"11d {stage}")
        if abs(map_cpu - maps[stage]) > 1e-9 or n == 0:
            raise AssertionError(f"11d {stage}: mAP {maps[stage]} on the "
                                 f"card, {map_cpu} on the CPU ({n} "
                                 f"detections)")
        cpu[stage] = dict(detections=n, mean_ap_cpu=map_cpu)
    guard_asserts(maps, "11c")
    emit("11c_guard", version="slim_yolo_v2", input=[GUARD_SIZE, GUARD_SIZE],
         train_images=GUARD_TRAIN, batch=GUARD_BATCH, epochs=GUARD_EPOCHS,
         train_seconds=train_s, deterministic=True,
         state_sha256=digest, steps_per_s=GUARD_EPOCHS * (GUARD_TRAIN // GUARD_BATCH) / train_s,
         last_loss=last, val_images=GUARD_VAL, val_seed=GUARD_VAL_SEED,
         maps=maps, head_clip=GUARD_HEAD_CLIP,
         bounds=dict(fp32_min=GUARD_FP32_MIN, fold_tol=GUARD_FOLD_TOL,
                     int8_drop=GUARD_INT8_DROP, cap_gain=GUARD_CAP_GAIN),
         launches=launches, launches_per_replay=replayed,
         score_seconds=time.perf_counter() - t0, card=card)
    emit("11d_cpu_route", images=GUARD_VAL, stages=cpu, card=card)
    return runs, (cfg, model, maps)


def phase_train_cli(card):
    """11e: ``cli.train`` as a user runs it, on its default device (the
    card): slim_yolo_v2 on the synthetic set (128 images, SSDAugmentation
    with uint8 output, the loader's threads), batch 16, multi-scale, two
    epochs with the mAP after each and a checkpoint at the last; then a
    third epoch resumed from that checkpoint (parameters, BN stats,
    momentum). -> seconds and figures of both runs."""
    import tempfile

    from yolo_tpu_torch.cli import train as cli
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        common = ["-d", "synthetic", "-b", str(CLI_BATCH), "--num_workers",
                  "4", "--save_folder", tmp, "--eval_epoch", "1"]
        folder = os.path.join(tmp, "synthetic", "slim_yolo_v2")
        t0 = time.perf_counter()
        cli.train(cli.parse_args(common + ["-ms", "--max_epoch", "2"]))
        t1 = time.perf_counter()
        _, extra = load_checkpoint(os.path.join(folder,
                                                "slim_yolo_v2_2.msgpack"))
        cli.train(cli.parse_args(common + [
            "--resume", os.path.join(folder, "slim_yolo_v2_2.msgpack"),
            "--start_epoch", "2", "--max_epoch", "3"]))
        t2 = time.perf_counter()
        _, extra3 = load_checkpoint(os.path.join(folder,
                                                 "slim_yolo_v2_3.msgpack"))
        with open(os.path.join(folder, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    per_epoch = 128 // CLI_BATCH
    counts = [int(np.asarray(e["opt_state"]["count"]))
              for e in (extra, extra3)]
    maps = [r["mAP"] for r in records if "mAP" in r]
    if counts != [2 * per_epoch, 3 * per_epoch] or len(maps) != 3 or \
            not all(math.isfinite(r.get("total_loss", 0.0))
                    for r in records):
        raise AssertionError(f"11e: steps {counts}, mAPs {maps}, "
                             f"{len(records)} records")
    emit("11e_train_cli", version="slim_yolo_v2", batch=CLI_BATCH,
         multi_scale=True, epochs=[2, 1], steps=counts, maps=maps,
         seconds={"two_epochs": t1 - t0, "resumed_epoch": t2 - t1},
         card=card)


def phase_11(card):
    """Phase 11: the trainer (11a one step against the CPU, 11b step
    times at full width, 11c a training run and its INT8 models through
    the kernels, 11d those on the CPU route, 11e ``cli.train``), cuDNN's
    algorithm search off as in phase 10. -> (11c's wrapper launches, 11c's
    (cfg, trained model, mAPs))."""
    cudnn = torch.backends.cudnn
    search, cudnn.benchmark = cudnn.benchmark, False
    try:
        images, targets = step_batch(max(b for _, b, _ in STEP_TIMES))
        phase_step_check(card, images, targets)
        torch.cuda.empty_cache()
        phase_step_times(card, images, targets)
        torch.cuda.empty_cache()
        runs, guard = phase_guard(card)
        torch.cuda.empty_cache()
        phase_train_cli(card)
        return runs, guard
    finally:
        cudnn.benchmark = search


# phase 12: the rest of quantization
QAT_CHECK_B, QAT_TIME_B, QAT_LR = 8, 32, 1e-3  # 12a, 12b
QAT_STEPS, QAT_FT_LR = 100, 1e-5  # 12c: cli.quantize qat's defaults
# |engine mAP - its fake-quant sim's| (tests/test_map_guard.py:156)
ENGINE_SIM_TOL = 0.06
SCORE_TOL = 1e-3  # 12c: agreement scores, card against CPU
# 12d: one calibration batch of 8 (the CLI stops once more than
# --calib_images are seen)
CLI_QUANT = ["-d", "synthetic", "--input_size", str(SIZE), str(SIZE),
             "--calib_images", "7", "--batch_size", "8"]


def folded_train_model(device):
    """``train_model``'s slim with its BN folded (biased convs), on
    ``device``."""
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm

    cfg, model = train_model("slim_yolo_v2", device)
    return cfg, fold_batch_norm(model)


def qat_states(model, cfg, batches, head_clip=None):
    """The call-ordered tracker states of the fake-quantized ``model``
    calibrated on ``batches`` (normalized NHWC), as ``cli.quantize qat``
    calibrates them."""
    from yolo_tpu_torch.quant import generic

    return generic.calibrate_generic(
        generic.fake_quantize_all_convs(model), cfg, batches,
        head_clip=head_clip)


def phase_qat_step(card, images, targets):
    """12a: one QAT step (``QATModule`` through ``make_train_step``) of
    BN-folded slim_yolo_v2 at 416², batch 8, lr 1e-3 on the card, held to
    the same step in float64 on the CPU on the card's branches (leaky
    signs, pool argmaxes, each tap's clip mask and levels): every
    parameter and momentum-trace leaf within GRAD_BOUND of its largest
    value; then a step at lr 0: the masters bit-identical."""
    import copy

    from yolo_tpu_torch.detector import normalize_u8
    from yolo_tpu_torch.ops import blocks
    from yolo_tpu_torch.quant.convert import module_to_params
    from yolo_tpu_torch.quant.qat import QATModule
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import TrainConfig, make_train_step

    t0 = time.perf_counter()
    x = torch.as_tensor(images[:QAT_CHECK_B]).cuda()
    cfg, model = folded_train_model("cuda")
    gt = build_targets(cfg, targets[:QAT_CHECK_B])
    states = qat_states(model, cfg, [normalize_u8(x)])
    cpu_model = copy.deepcopy(model).cpu().double()
    qmod = QATModule(model, states)
    opt, step = make_train_step(qmod, cfg, TrainConfig())
    state = opt.init(qmod)
    with blocks.branch_context() as b:
        metrics = step(state, x, gt, QAT_LR)
    card_leaves = opt_leaves(model, state)
    card_metrics = {k: v.item() for k, v in metrics.items()}
    t1 = time.perf_counter()
    qcpu = QATModule(cpu_model, [{k: v.cpu() for k, v in st.items()}
                                 for st in states])
    opt, step_cpu = make_train_step(qcpu, cfg, TrainConfig())
    state_cpu = opt.init(qcpu)
    with blocks.branch_context([c.cpu() for c in b.choices]) as bc:
        cpu_metrics = step_cpu(state_cpu, normalize_u8(x).cpu().double(),
                               gt, QAT_LR)
    flips = check_flips("12a", bc.flips)
    margins = {}
    for kind, n, margin, scale in bc.flips:
        if n:
            margins.setdefault(kind, []).append(
                dict(elements=n, margin=margin, scale=scale))
    cpu = opt_leaves(cpu_model, state_cpu)
    t2 = time.perf_counter()
    for k, v in cpu_metrics.items():
        got = card_metrics[k]
        if not (math.isfinite(got) and abs(got - v.item()) <= 1e-4 * abs(
                v.item())):
            raise AssertionError(f"12a {k}: card {got}, cpu {v.item()}")
    errs = leaf_errors(card_leaves, cpu)
    worst, path = max(errs)
    if worst > GRAD_BOUND:
        raise AssertionError(f"12a {path}: card-cpu max abs error {worst} "
                             f"of the leaf's largest value > {GRAD_BOUND}")
    # lr 0: the update lands on the float32 masters, unchanged
    _, model0 = folded_train_model("cuda")
    before = module_to_params(model0)
    q0 = QATModule(model0, states)
    opt, step0 = make_train_step(q0, cfg, TrainConfig())
    state0 = opt.init(q0)
    step0(state0, x, gt, 0.0)
    after = module_to_params(model0)
    same = all(np.array_equal(a, before_leaf) for (_, a), (_, before_leaf)
               in zip(tree_leaves(after), tree_leaves(before)))
    if not same or state0.paths[0] != ("conv1", "w"):
        raise AssertionError(f"12a: masters moved at lr 0 ({same}) or the "
                             f"optimizer's tree is not the base model's "
                             f"({state0.paths[0]})")
    kinds = {k: bc.kinds.count(k) for k in ("leaky", "pool", "clip",
                                             "round")}
    emit("12a_qat_step", version="slim_yolo_v2 (BN folded)",
         batch=QAT_CHECK_B, input=[SIZE, SIZE], lr=QAT_LR,
         taps=len(states), choices=kinds, leaves=len(cpu),
         bound=GRAD_BOUND, worst=worst, worst_leaf=path,
         median=statistics.median(e for e, _ in errs),
         loss=card_metrics,
         loss_cpu={k: v.item() for k, v in cpu_metrics.items()},
         **flips, flip_margins=margins, masters_equal_at_lr0=True,
         seconds={"card": t1 - t0, "cpu": t2 - t1}, card=card)


def phase_qat_times(card, images, targets):
    """12b: ms a step at 416², batch 32, of BN-folded slim: the QAT step
    (STE weights and taps) beside a plain float32 step of the same
    model; images/sec, peak GB."""
    from yolo_tpu_torch.detector import normalize_u8
    from yolo_tpu_torch.quant.qat import QATModule
    from yolo_tpu_torch.train.targets import build_targets
    from yolo_tpu_torch.train.trainer import TrainConfig, make_train_step

    x = torch.as_tensor(images[:QAT_TIME_B]).cuda()
    out = {}
    for form in ("float32", "qat"):
        cfg, model = folded_train_model("cuda")
        gt = torch.as_tensor(build_targets(cfg, targets[:QAT_TIME_B])).cuda()
        run = (QATModule(model, qat_states(model, cfg, [normalize_u8(x)]))
               if form == "qat" else model)
        opt, step = make_train_step(run, cfg, TrainConfig())
        state = opt.init(run)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, x, gt, 1e-4), 5)
        out[form] = dict(ms_per_step=ms, images_per_s=1e3 * QAT_TIME_B / ms,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, run, state
    emit("12b_qat_times", version="slim_yolo_v2 (BN folded)",
         batch=QAT_TIME_B, input=[SIZE, SIZE], steps=out,
         qat_over_float32=out["qat"]["ms_per_step"]
         / out["float32"]["ms_per_step"], card=card)


def phase_qat_guard(card, guard):
    """12c: 11c's trained slim (``guard``: cfg, model, mAPs), folded:
    ``select_quant_config(greedy_rounds=1)`` on the guard's calibration
    batches through the kernels (a cap of DEFAULT_CAPS must bind) and on
    the CPU route (the same cap, percentile and flips, every score within
    SCORE_TOL); ``qat_finetune`` at the CLI's defaults (100 steps, lr
    1e-5) on the guard's training set at the chosen cap's states; the
    result served with those states through ``build_int8_detector(
    states=...)`` on the s2d input: mAP within ENGINE_SIM_TOL of its
    fake-quant sim's, detections and mAP equal on the CPU route, K2, K3,
    K1 and NMS launched, replays held to their graphs; beside it, the
    PTQ engine at QAT's own starting states (the chosen cap, abs-max
    trackers) and the search's PTQ engine, as found. -> the engines'
    wrapper launches."""
    import copy

    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.eval import VOCEvaluator
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import qsim
    from yolo_tpu_torch.quant.autoclip import (DEFAULT_CAPS,
                                               select_quant_config)
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
    from yolo_tpu_torch.quant.dispatch import build_int8_detector
    from yolo_tpu_torch.quant.generic import quantize_detector
    from yolo_tpu_torch.quant.qat import qat_finetune
    from yolo_tpu_torch.train.trainer import device_resident_batches

    version = "slim_yolo_v2_q_bf"  # the folded form
    cfg, trained, guard_maps = guard
    t0 = time.perf_counter()
    fused = fold_batch_norm(trained)
    train, ev, calib = guard_data()
    calib_dev = [torch.as_tensor(b).cuda() for b in calib]
    with deterministic_algorithms():
        best, info = select_quant_config(version, fused, cfg, calib_dev,
                                         greedy_rounds=1, device="cuda")
    t1 = time.perf_counter()
    caps = info["cap_scores"]
    binding = [c for c in DEFAULT_CAPS
               if c is not None and caps[c] != caps[None]]
    if not binding:
        raise AssertionError(f"12c: no cap of {DEFAULT_CAPS} binds: {caps}")
    best_cpu, info_cpu = select_quant_config(
        version, copy.deepcopy(fused).cpu(), cfg, calib, greedy_rounds=1,
        device="cpu")
    t2 = time.perf_counter()
    choice = (best["head_clip"], best["act_percentile"],
              [(r, k) for r, k, _ in info["greedy_flips"]])
    choice_cpu = (best_cpu["head_clip"], best_cpu["act_percentile"],
                  [(r, k) for r, k, _ in info_cpu["greedy_flips"]])
    score_err = max(
        [abs(info[d][k] - info_cpu[d][k]) for d in ("cap_scores",
                                                    "pct_scores")
         for k in info[d]]
        + [abs(a[2] - b[2]) for a, b in zip(info["greedy_flips"],
                                            info_cpu["greedy_flips"])]
        + [abs(best["score"] - best_cpu["score"])])
    if choice != choice_cpu or score_err > SCORE_TOL:
        raise AssertionError(f"12c: the search chose {choice} on the card, "
                             f"{choice_cpu} on the CPU (scores {score_err} "
                             f"apart)")

    # QAT at the chosen cap's states, as cli.quantize qat runs it
    cap = best["head_clip"]
    model = copy.deepcopy(fused)
    states = qat_states(model, cfg, calib_dev, head_clip=cap)
    named = dict(zip(qsim.TRACKER_NAMES, states))
    det = Detector(cfg, model=model, batch_norm=False, device="cuda")
    with deterministic_algorithms():
        _, last = qat_finetune(
            det, states, device_resident_batches(cfg, train, GUARD_BATCH,
                                                 "cuda"),
            base_lr=QAT_FT_LR, steps=QAT_STEPS)
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    maps = {}
    m, _ = build_int8_detector(version, model, cfg, calib_dev, states=named,
                               device="cuda")
    _, _, sim = quantize_detector(det, calib_dev, fold_bn=False,
                                  states=states)
    maps["qat_sim"] = ev.evaluate(sim)
    K.reset_launch_counts()
    detect = s2d_detect(m, cfg, "cuda")
    maps["qat_int8"] = ev.evaluate(detect)
    torch.cuda.synchronize()
    launches = K.launch_counts_by_entry()
    replayed = check_replays(detect.captured, "12c")
    for kernel, entry in (("int8_conv3x3_pool_requant", POOL_S2D),
                          ("int8_conv3x3_im2col", POOL3),
                          ("int8_conv3x3_requant", WGMMA3),
                          ("greedy_nms_keep", NMS_K)):
        if not launches.get(kernel, {}).get(entry):
            raise AssertionError(f"12c: no launch of {kernel} on {entry}: "
                                 f"{launches}")
    if abs(maps["qat_int8"] - maps["qat_sim"]) > ENGINE_SIM_TOL:
        raise AssertionError(f"12c: the QAT engine's mAP {maps['qat_int8']}"
                             f" is off its sim's {maps['qat_sim']} by more "
                             f"than {ENGINE_SIM_TOL}")
    ev_cpu = VOCEvaluator(ev.dataset, 2, cfg.input_size,
                          batch_size=GUARD_VAL)
    map_cpu = ev_cpu.evaluate(s2d_detect(m, cfg, "cpu"))
    n = same_detections(ev, ev_cpu, "12c")
    if abs(map_cpu - maps["qat_int8"]) > 1e-9 or n == 0:
        raise AssertionError(f"12c: QAT engine mAP {maps['qat_int8']} on the "
                             f"card, {map_cpu} on the CPU ({n} detections)")
    # PTQ without QAT: at QAT's own starting states (its baseline), and
    # the search's own configuration as found
    runs = [launches]
    for key, states_ptq in (("ptq_int8_qat_states", named),
                            ("autoclip_int8", best["states"])):
        m_ptq, _ = build_int8_detector(version, fused, cfg, calib_dev,
                                       states=states_ptq, device="cuda")
        K.reset_launch_counts()
        maps[key] = ev.evaluate(s2d_detect(m_ptq, cfg, "cuda"))
        torch.cuda.synchronize()
        runs.append(K.launch_counts_by_entry())
    emit("12c_autoclip_qat", version="slim_yolo_v2 (11c's run, folded)",
         input=[GUARD_SIZE, GUARD_SIZE], calib_images=2 * GUARD_BATCH,
         cap_scores={str(k): v for k, v in caps.items()},
         pct_scores={str(k): v for k, v in info["pct_scores"].items()},
         greedy_flips=info["greedy_flips"], binding_caps=binding,
         head_clip=cap, act_percentile=best["act_percentile"],
         score=best["score"], cpu_route_score_max_diff=score_err,
         qat_steps=QAT_STEPS, qat_lr=QAT_FT_LR,
         qat_last_loss={k: float(v) for k, v in last.items()},
         maps=maps, map_cpu=map_cpu, detections=n,
         ptq_capped_11c=guard_maps["int8_capped"],
         fp32_11c=guard_maps["fp32"], sim_bound=ENGINE_SIM_TOL,
         launches=launches, launches_per_replay=replayed,
         seconds={"search_card": t1 - t0, "search_cpu": t2 - t1,
                  "qat": t3 - t2, "score": time.perf_counter() - t3},
         card=card)
    return runs


def phase_quantize_cli(card, guard):
    """12d: ``cli.quantize`` on its default device (the card) as a user
    runs it on the synthetic set at 416²: bnfold from 11c's checkpoint,
    ``ptq --head_clip auto``, ``qat --steps 4 --no_eval``, ``export
    --header --artifact --artifact_input s2d``, then ``cli.serve
    --artifact`` on one batch (a smoke run: its rate is not kept); the
    export again with ``--device cpu``:
    weight.h byte-equal; the artifact's detections equal to the live
    detect fn's."""
    import tempfile

    from yolo_tpu_torch.cli import quantize as cli
    from yolo_tpu_torch.cli import serve
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.convert import module_to_params
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
    from yolo_tpu_torch.serving.export import load_artifact
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint

    _, trained, _ = guard
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = {k: os.path.join(tmp, f"{k}.msgpack")
                for k in ("guard", "fused", "ptq", "qat")}
        save_checkpoint(path["guard"], module_to_params(trained))

        def run(stage, *argv):
            t0 = time.perf_counter()
            out = cli.main(cli.parse_args([stage, *argv, *CLI_QUANT]))
            seconds[stage] = seconds.get(stage, 0.0) + (
                time.perf_counter() - t0)
            return out

        run("bnfold", "-r", path["guard"], "--out", path["fused"],
            "--no_eval")
        run("ptq", "-r", path["fused"], "--head_clip", "auto", "--out",
            path["ptq"])
        run("qat", "-r", path["fused"], "--steps", "4", "--no_eval",
            "--out", path["qat"])
        headers = {d: os.path.join(tmp, f"weight_{d}.h")
                   for d in ("cuda", "cpu")}
        blob = os.path.join(tmp, "slim_s2d.pt2")
        m = run("export", "-r", path["qat"], "--header", headers["cuda"],
                "--artifact", blob, "--artifact_input", "s2d", "--no_eval")
        m_cpu = run("export", "-r", path["qat"], "--header", headers["cpu"],
                    "--no_eval", "--device", "cpu")
        with open(headers["cuda"], "rb") as f, open(headers["cpu"],
                                                     "rb") as g:
            h_card, h_cpu = f.read(), g.read()
        if h_card != h_cpu:
            raise AssertionError(f"12d: weight.h differs on the card and on "
                                 f"the CPU (tables {m.sa} / {m_cpu.sa}, "
                                 f"retune {m.retune} / {m_cpu.retune})")
        t0 = time.perf_counter()
        serve.main(["--artifact", blob, "--iters", "1", "-d", "synthetic"])
        seconds["serve"] = time.perf_counter() - t0
        detect, meta = load_artifact(blob, with_meta=True)
        cfg = cli.build_cfg(cli.parse_args(["export", *CLI_QUANT]))
        x = torch.as_tensor(np.random.default_rng(12).random(
            (meta["batch"], SIZE, SIZE, 3), dtype=np.float32)).cuda()
        x_q = fp.s2d_input(fp.quantize_input(x, int(meta["sa_in"])))
        live = make_int8_detect_fn(m, cfg, input_s2d=True, device="cuda")
        got, want = detect(x_q), live(x_q)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("12d: the artifact's detections differ "
                                 "from the live detect fn's")
        header_bytes = len(h_card)
    emit("12d_quantize_cli", version="slim_yolo_v2", input=[SIZE, SIZE],
         argv=CLI_QUANT, weight_h_bytes=header_bytes,
         weight_h_equal_cpu=True, artifact_meta=meta,
         artifact_equal_live=True,
         detections=int(got[3].sum()), seconds=seconds, card=card)


def phase_12(card, guard):
    """Phase 12: the rest of quantization (12a one QAT step against the
    CPU, 12b its time, 12c the clip search and QAT on 11c's trained slim
    through the kernels, 12d ``cli.quantize``), cuDNN's algorithm search
    off as in phase 11. -> 12c's wrapper launches."""
    cudnn = torch.backends.cudnn
    search, cudnn.benchmark = cudnn.benchmark, False
    try:
        images, targets = step_batch(QAT_TIME_B)
        phase_qat_step(card, images, targets)
        torch.cuda.empty_cache()
        phase_qat_times(card, images, targets)
        torch.cuda.empty_cache()
        runs = phase_qat_guard(card, guard)
        torch.cuda.empty_cache()
        phase_quantize_cli(card, guard)
        return runs
    finally:
        cudnn.benchmark = search


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from yolo_tpu_torch.kernels import build

    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("header", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=card, device=name,
         conv2d_int8=conv2d_probe(torch.int8),
         conv2d_int32=conv2d_probe(torch.int32))

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib),
         compile_seconds=build.compile_seconds)

    max_err = dict.fromkeys(LINES, 0)
    phase_kernels(max_err)
    phase_v3_kernels(max_err)
    phase_pc_kernels(max_err)
    phase_parts_kernels(max_err)
    m, cfg = phase_golden()
    m3, cfg3 = phase_v3_golden()
    mpc, cfgpc = phase_pc_golden()
    launches = phase_serving(m, cfg, card)
    launches_nhwc = phase_serving(m, cfg, card, input_s2d=False)
    launches_v3 = phase_v3_serving(m3, cfg3, card)
    launches_pc, launches_diag = phase_pc_serving(mpc, cfgpc, card)
    # after the serving phases, so that they run as the parent tree's do
    # (phase 2d's batch-128 plain checks take ~20 GB of the card)
    mpcv3, pcv3, blocks = phase_pcv3_kernels(max_err)
    torch.cuda.empty_cache()
    m3d, cfg3d = phase_pcv3_golden()
    launches_pcv3 = phase_pcv3_serving(m3d, cfg3d, card)
    del m3d
    times = phase_layer_times(name, max_err)
    times.update(phase_v3_times(name, max_err))
    times.update(phase_pc_layer_times(name, max_err))
    times.update(phase_pcv3_times(name, max_err, mpcv3, pcv3, blocks))
    del mpcv3, pcv3, blocks
    torch.cuda.empty_cache()
    launches_ptq = phase_ptq(card)
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    phase_native(card)
    launches_6 = [phase_v3_s2d(m3, cfg3, card, launches_v3)]
    del m3
    torch.cuda.empty_cache()
    launches_6.append(phase_spp(card))
    torch.cuda.empty_cache()
    launches_6 += phase_serve_cli(card)
    emit("phase_6", seconds=time.perf_counter() - t6, **replay_tally())
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    launches_7, times_7 = phase_7(card, max_err)
    emit("phase_7", seconds=time.perf_counter() - t7, **replay_tally())
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    launches_8, times_8 = phase_8(card, max_err)
    times.update(times_8)
    emit("phase_8", seconds=time.perf_counter() - t8, **replay_tally())
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    launches_9 = phase_9(card)
    emit("phase_9", seconds=time.perf_counter() - t9, **replay_tally())
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    phase_10(card)
    emit("phase_10", seconds=time.perf_counter() - t10)
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    launches_11, guard = phase_11(card)
    emit("phase_11", seconds=time.perf_counter() - t11, **replay_tally())
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    launches_12 = phase_12(card, guard)
    emit("phase_12", seconds=time.perf_counter() - t12, **replay_tally())
    del guard
    # the two-part form's lines: tiny's conv_set_1 plus yolo_v2's
    # convsets_2.0, scalar (7a, 7b) and per column (7d), a forward of each
    for line in PARTS_LINES:
        times[line] = {}
        for tv in times_7.values():
            for field, v in tv.get(line, {}).items():
                times[line][field] = times[line].get(field, 0.0) + v

    shapes = {
        "slim": f"per slim_yolo_v2 forward: summed over its layers, batch "
                f"{BATCH_SERVE}, {SIZE}x{SIZE}; library_ms is cuDNN fp16 "
                f"conv2d",
        "int8_res_block": f"per yolo_v3 forward: its 5 stage shapes times "
                          f"their blocks, batch {V3_BATCH_SERVE}, "
                          f"{SIZE}x{SIZE}; library_ms is cuDNN fp16 "
                          f"conv2d 1x1 + 3x3",
        "int8_conv3x3_requant": f"per slim_yolo_v2 forward: summed over "
                                f"its 6 K1 layers, batch {BATCH_SERVE}, "
                                f"{SIZE}x{SIZE}; library_ms is cuDNN fp16 "
                                f"conv2d; mma_sync_ms the mma.sync conv "
                                f"kernel on the same layers",
        "int8_conv3x3_im2col": f"per slim_yolo_v2 forward: summed over its "
                               f"3 K3 layers (conv2, conv3_2, conv4_2), "
                               f"batch {BATCH_SERVE}, {SIZE}x{SIZE}; "
                               f"library_ms is cuDNN fp16 conv2d (without "
                               f"the pool); mma_sync_ms the mma.sync conv "
                               f"kernel on the same layers",
        "int8_conv_requant.conv3x3_wgmma": f"per yolo_v3 forward: the "
                                           f"head's 9 stride-1 3x3s (3 "
                                           f"shapes), batch "
                                           f"{V3_BATCH_SERVE}, "
                                           f"{SIZE}x{SIZE}; library_ms is "
                                           f"cuDNN fp16 conv2d; "
                                           f"mma_sync_ms the mma.sync conv "
                                           f"kernel on the same convs",
        "int8_conv_requant.conv3x3_s2_wgmma": f"per yolo_v3 forward: "
                                              f"darknet53's 5 stride-2 "
                                              f"3x3s, batch "
                                              f"{V3_BATCH_SERVE}, "
                                              f"{SIZE}x{SIZE}; library_ms "
                                              f"is cuDNN fp16 conv2d at "
                                              f"stride 2; mma_sync_ms the "
                                              f"mma.sync conv kernel on "
                                              f"the same convs",
        "int8_conv_requant.entry_conv3x3_wgmma": f"per yolo_v3 forward: "
                                                 f"the C_in = 3 entry conv "
                                                 f"(3 -> 32), batch "
                                                 f"{V3_BATCH_SERVE}, "
                                                 f"{SIZE}x{SIZE}; library_ms"
                                                 f" is cuDNN fp16 conv2d; "
                                                 f"mma_sync_ms the mma.sync "
                                                 f"conv kernel on the same "
                                                 f"conv",
        "int8_conv3x3_pool_requant": f"per slim_yolo_v2 forward: conv1 on "
                                     f"the s2d input (3 -> 16), batch "
                                     f"{BATCH_SERVE}, {SIZE}x{SIZE}; "
                                     f"library_ms is cuDNN fp16 conv2d "
                                     f"(without the pool); mma_sync_ms the "
                                     f"mma.sync pool_s2d kernel on the same "
                                     f"layer",
        "int8_conv_requant.conv1x1_wgmma": f"per yolo_v3 forward: its 14 "
                                           f"1x1s (nine 1x1s, two concat "
                                           f"1x1s, three preds) by "
                                           f"distinct shape, batch "
                                           f"{V3_BATCH_SERVE}, "
                                           f"{SIZE}x{SIZE}; library_ms is "
                                           f"torch._int_mm; mma_sync_ms "
                                           f"the mma.sync conv kernel on "
                                           f"the same convs",
        "int8_conv_requant.mma_sync": f"no served layer (0 launches on "
                                      f"every path): the general conv's "
                                      f"route for the shapes no wgmma "
                                      f"route takes, timed on yolo_v3's 14 "
                                      f"1x1s, batch {V3_BATCH_SERVE}, "
                                      f"{SIZE}x{SIZE}; library_ms is "
                                      f"torch._int_mm",
        **{line: f"per forward: tiny_yolo_v3's conv_set_1 (3x3 over [256, "
                 f"128] at 26², batch {FAMILY7['tiny_yolo_v3']['batch']}) "
                 f"plus yolo_v2's convsets_2.0 ([256, 1024] at 13², two "
                 f"scales, batch {FAMILY7['yolo_v2']['batch']}), {what}, "
                 f"{SIZE}x{SIZE}, on real activations; library_ms is cuDNN "
                 f"fp16 conv2d over the concat"
           for line, what in zip(PARTS_LINES, (
               "scalar sw (7a, 7b)", "per-channel sw (7d)"))},
        "greedy_nms_keep": f"one launch per detect call: slim_yolo_v2's "
                           f"candidates on the s2d layout, batch "
                           f"{BATCH_SERVE}, K = 128 (pre_nms_top_k), "
                           f"{SIZE}x{SIZE}, phase 8a; paths: K = 512 (the "
                           f"CLI's pre_nms_top_k) on slim s2d at batch "
                           f"{SERVE_CLI_BATCH} and tiny_yolo_v3 s2d at "
                           f"batch {BATCH_SERVE}; plain_ms is the Jacobi "
                           f"fixpoint the detect fns ran before (a host "
                           f"read a sweep); no library call computes "
                           f"greedy NMS",
        "int8_gemm": "the int8 GEMM probe at M = K = N = 8192, b "
                     "K-major, off the serving paths (0 launches there); "
                     "library_ms is torch._int_mm on the same operands",
        "int8_conv3x3_requant.cols": f"per slim_yolo_v2 forward with "
                                     f"per-channel sw, NHWC input: its 6 K1 "
                                     f"layers, batch {BATCH_SERVE}, "
                                     f"{SIZE}x{SIZE}; library_ms is cuDNN "
                                     f"fp16 conv2d",
        "int8_conv3x3_im2col.cols": f"per slim_yolo_v2 forward with "
                                    f"per-channel sw: conv2, conv3_2, "
                                    f"conv4_2, batch {BATCH_SERVE}, "
                                    f"{SIZE}x{SIZE}; library_ms is cuDNN "
                                    f"fp16 conv2d (without the pool)",
        "int8_conv3x3_im2col.pool_nhwc": f"per slim_yolo_v2 forward on "
                                          f"NHWC input (phase 4's second "
                                          f"serving run): conv1 (C_in 3 "
                                          f"-> 16, pooled), batch "
                                          f"{BATCH_SERVE}, {SIZE}x{SIZE}; "
                                          f"library_ms is cuDNN fp16 "
                                          f"conv2d (without the pool); "
                                          f"mma_sync_ms the mma.sync conv "
                                          f"on the same layer",
        "int8_conv3x3_im2col.pool_nhwc_cols": f"per slim_yolo_v2 forward "
                                               f"with per-channel sw: conv1"
                                               f" on NHWC input (C_in 3 -> "
                                               f"16, pooled), with its "
                                               f"shift table, batch "
                                               f"{BATCH_SERVE}, "
                                               f"{SIZE}x{SIZE}; library_ms "
                                               f"is cuDNN fp16 conv2d "
                                               f"(without the pool); "
                                               f"mma_sync_ms the mma.sync "
                                               f"conv with the same table",
        "int8_conv3x3_im2col.pool_nhwc_count": f"per "
                                                f"int8_forward_diagnostics "
                                                f"forward (launches from "
                                                f"its run): conv1 with its "
                                                f"counter, batch "
                                                f"{BATCH_SERVE}, "
                                                f"{SIZE}x{SIZE}; library_ms "
                                                f"is cuDNN fp16 conv2d "
                                                f"(without the pool); "
                                                f"mma_sync_ms the mma.sync "
                                                f"conv with the counter",
        "int8_conv3x3_requant.count": f"per int8_forward_diagnostics "
                                      f"forward (launches from its run, "
                                      f"not serving): the 6 K1 layers, "
                                      f"batch {BATCH_SERVE}, "
                                      f"{SIZE}x{SIZE}; library_ms is cuDNN "
                                      f"fp16 conv2d",
        "int8_conv3x3_im2col.count": f"per int8_forward_diagnostics "
                                     f"forward (launches from its run): "
                                     f"conv2, conv3_2, conv4_2, batch "
                                     f"{BATCH_SERVE}, {SIZE}x{SIZE}; "
                                     f"library_ms is cuDNN fp16 conv2d "
                                     f"(without the pool)",
        **{k: f"per yolo_v3 forward with per-channel sw (launches from "
              f"phase 4d's serving): {what}, with the model's shift "
              f"tables, batch {V3_BATCH_SERVE}, {SIZE}x{SIZE}; library_ms "
              f"is {lib}" for k, what, lib in (
                  ("int8_res_block.cols",
                   "K4's 5 stage shapes times their blocks (23)",
                   "cuDNN fp16 conv2d 1x1 + 3x3"),
                  ("int8_conv_requant.conv3x3_cols_wgmma",
                   "the head's 9 stride-1 3x3s", "cuDNN fp16 conv2d"),
                  ("int8_conv_requant.conv3x3_s2_cols_wgmma",
                   "darknet53's 5 stride-2 3x3s",
                   "cuDNN fp16 conv2d at stride 2"),
                  ("int8_conv_requant.entry_conv3x3_cols_wgmma",
                   "the C_in = 3 entry conv (3 -> 32)", "cuDNN fp16 conv2d"),
                  ("int8_conv_requant.conv1x1_cols_wgmma",
                   "its 14 1x1s (two concats)", "torch._int_mm"))},
    }
    from yolo_tpu_torch.utils.capture import replayed_launches

    # what the CUDA graphs' replays ran, derived from the launches each
    # recorded at its capture and held to each graph's kernel nodes
    # (check_replays); ``launches`` counts only the wrappers' own
    replayed = replayed_launches()
    kernels = []
    for k, (wrapper, entry, source, replaces) in LINES.items():
        t = times[k]
        runs = ((launches_diag,) if k in DIAGNOSTICS_LINES
                else (launches, launches_nhwc, launches_v3, launches_pc,
                      launches_pcv3, *launches_ptq))
        per_run = [served.get(wrapper, {}).get(entry, 0) for served in runs]
        ran = sum(per_run)
        if k not in DIAGNOSTICS_LINES:
            ran += sum(served.get(wrapper, {}).get(entry, 0)
                       for served in launches_6 + launches_7 + launches_8
                       + launches_9 + launches_11 + launches_12)
        per_forward = max(per_run) // SERVE_ITERS
        # tiny_yolo_v3's and yolo_v2's launches per forward on each input
        # layout, and the times of their shapes (one NHWC forward; K2's on
        # the s2d layout)
        paths = {
            key: dict(
                launches_per_forward={
                    layout: family7_launches(
                        key.split(".")[0], layout == "s2d",
                        per_channel=key.endswith(".pc")).get(
                        wrapper, {}).get(entry, 0)
                    for layout in (("nhwc",) if key.endswith(".pc")
                                   else ("nhwc", "s2d"))},
                **{f: tv[k][f] for f in ("ms", "device_ms", "plain_ms",
                                         "library_ms", "bound_ms")
                   if f in tv[k]})
            for key, tv in times_7.items() if k in tv}
        paths.update(t.get("paths", {}))
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": ran,
            "replayed_launches": replayed.get(wrapper, {}).get(entry, 0),
            "launches_per_forward": per_forward,
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["t_ops"] >= t["t_bytes"]
                         else "bytes"),
            "library_ms": t["library_ms"],
            **({"mma_sync_ms": t["mma_sync_ms"]} if "mma_sync_ms" in t
               else {}),
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {}),
            **({"paths": paths} if paths else {}),
            "entry": entry, "shapes": shapes.get(k, shapes["slim"]),
        })
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

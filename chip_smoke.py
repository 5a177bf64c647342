#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``kernels/csrc/`` with
``nvcc`` (one process per source, all at once), checks in ptxas's report
that the wgmma forward has 168 registers a thread at entry and no spills,
that the wgmma backward's and the wgmma and tf32 K3's kernels, every
instantiation of the mma.sync flash forward and backward, of K4a and of
K4w spill nothing, and that no wgmma source has its products serialized
(C7514/C7512), then:

1. kernel phase — holds each flash-attention kernel (the wgmma kernel for
   bf16 at d 64/128, the simple kernel for f32 and the other head dims, any
   d % 8 == 0 in [8, 256]) against its plain PyTorch version on the card,
   at the main path's shapes and layouts (the strided fused-QKV views, the
   batch bucket, the ragged ``apply`` length, block edges, non-causal with
   Tq != Tk, d 128; in f32 the f32 model's prefill and training layer; bf16
   at d 32, 80, 96, 256; d 8, 40, 136 and 256 in both types), and times
   each: ``ms`` (20 back-to-back wrapper calls between CUDA
   events, host included), ``device_ms`` (20 launches captured in a CUDA
   graph, replays timed with CUDA events: device only), the plain
   version, SDPA (``library_ms`` and ``library_device_ms``, timed the same
   two ways) and the card's bound (f32 at 165 TFLOP/s, three TF32 products
   at the 495 TFLOP/s peak, with the 67 TFLOP/s FMA bound beside);
2. backward phase — holds each backward kernel (K2: dq, dk, dv; the wgmma
   backward for bf16 at d 64/128, the ``mma.sync`` one for f32 and the
   other head dims) against its plain version at the training layer (fused
   QKV views, batch 8), ragged and block-edge lengths, Tq != Tk, d 128, f32
   and the other head dims, and times it as the forward is, plus the
   forward and backward together (K1 + K2) against SDPA's forward and
   backward, and SDPA's backward alone (its forward and backward less its
   forward); each gradient is held by its largest error and by the
   relative L2 error of each 64-row tile;
   then the training step's tied LM head (bf16 product into f32 logits,
   bf16 dlogits in its backward) against autograd through the f32 product
   at the training layer;
   then K3 (chunked cross-entropy: the forward K3f and one chunk's dlogits
   K3b; the wgmma kernels for bf16, the tf32 kernels and their split pass
   for f32, and chunked_ce.cu's in turns against each at its training
   shape) and K7 (MoE dispatch K7d and
   combine K7c, each also in its gradient mode) against their plain
   versions at the training shapes and at ragged and small ones, timed the
   same two ways beside their bounds and the library calls they stand for
   (the unchunked head + CE and its backward; ``index_copy_`` /
   ``index_add_``); then K4 (K4a, the paged decode attention, over bf16,
   f32 and int8 pages and the dense cache's view, at the serving shapes and
   at edges: P 16, hd 16 and 128, a window past the span, a free slot, 64
   splits, W 16 at hd 128; K4w, the int8 quantize-and-scatter, bit-exact,
   for decode windows and a prefill insert) against their plain versions,
   timed the same two ways beside their bounds and, for K4a, the gather of
   the pages plus SDPA, which K4a must not lose to at 16 heads of 64; K4a
   must give the same bits on a second call and in every output of three
   CUDA-graph replays, and its split count is swept at the main decode
   step and the verify window (``decode_split_sweep``); then K4a+w (the
   decode step's store in K4a's launch, every decode path's kernel) on
   bf16, int8 and f32 pages and the dense cache, against its plain version
   (o at K4a's tolerance) and against the two-launch path it replaces (the
   store's own launch, then K4a: o and every pool byte the same, the trash
   page aside), timed in turns with that path at the decode step and B 8,
   W 5; K4w (the prefill insert's, first) beside its bound;
3. slice phase — serves generation from ``TransformerLM`` at the full
   width of the bench's large config (vocab 32768, 12 layers, 16 heads,
   d_model 1024, d_ff 4096, max_len 1024, bf16, fused QKV; random weights
   from a numpy seed through ``from_jax_params``) through ``DecodeEngine``
   in its default paged mode, checks the tokens and logits, and checks that
   every prefill and ``apply`` launched the wgmma kernel exactly once per
   layer and the simple kernel never, and every decode step K4a+w once per
   layer (K4a alone and K4w never);
4. profile phase — one ``torch.profiler`` window over a single prefill at
   bucket 1024, and one over 4 decode steps after a 960-token prompt on
   bf16 pages and one on int8 pages: the device's busy share, kernels a
   step and the top device kernels; then the serving modes
   at full width: int8 pages with plain decode, bf16 pages with speculative
   decoding (a 2-layer truncated draft with a dense cache, spec_k 4), and
   both: the int8 gate's record (the pool int8 if and only if it passed),
   the tokens against plain decode's up to its first near tie, the int8
   decode's logits against ``apply``, every kernel's launches per step and
   round, the accept ratio, prefill ms, ms per emitted token and the
   resident cache bytes, and an int8 pool through ``decode_window_paged``
   whatever the gate decided;
   then the continuous-batching ``GenerationPipeline`` on the same engine
   (``pipeline_phase``): 8 client threads (two prompts at each length,
   starts staggered over 0-30 ms, 32 greedy tokens) into 4 slots on bf16
   pages (fault-free; one request alone; one ``generation.step`` crash
   mid-run, whose journaled requests, re-prefilled, must finish with the
   fault-free run's tokens but for a flip at a near tie; a profiler window
   of 4 whole steps at 4 active slots) and on
   int8 pages with speculative decoding; each request's tokens against
   its prompt alone up to the first near tie, every page returned, no new
   step signature and no ``memory_allocated`` growth after warm-up, K1,
   K4a+w (and K4w on int8 pages) launched and nothing else; then a pool of
   half the slots' pages, which must shed ``CachePagesExhausted`` typed
   and admit again; time to first token, ms per emitted token, tokens/s,
   active slots and host ms a step, the snapshot and the cost model;
   then the serving plane on the same engine (``frontdoor_phase``):
   ``ModelRegistry.deploy_generative`` at 4 slots (its warm-up) behind
   ``FrontDoor`` on 127.0.0.1, one request at a time at each prompt
   length, plain JSON and SSE (the same tokens exactly, and the engine's
   greedy decode up to its first near tie), 8 concurrent SSE clients
   (time to first token, ms per emitted token, tokens/s) beside the same
   8 requests straight into the pipeline, an idempotent replay that runs
   no generation, the reference's statuses (404 for an unknown version
   and ``/v1/classify``, 504 for a 1 ms deadline, 400, 429 with
   ``Retry-After`` at a full in-flight gate, every reply with
   ``X-Dl4j-Trace-Id``), a canary of ``g2`` walked shadow → canary → ramp
   → full through ``/admin/rollout`` while a client keeps sending, and
   ``retire("g1")`` with no request dropped; K1 and K4a+w launched and
   nothing else; then ``fleet_phase``: the reference's session-failover
   drill (``benchmarks/http_load.py`` ``run_session_failover``) against
   two workers of ``python -m deeplearning4j_tpu_torch.tools.serve`` on
   the card (the demo model, f32, under the drill's fault spec), one
   SIGKILLed with every stream mid-flight: completion, gapless ids and
   the undisturbed run's greedy tokens for every stream, every live
   session of the killed worker adopted by the survivor, the resume
   latency reported, and the survivor's own launches after its warm-up
   (K1's simple forward and K4a+w, nothing else) as the fleet path's;
5. training phase — ``make_train_step(adamw(3e-4))`` at the same config on
   each of bench.py's rungs (batch, remat, ce_chunks) = (8, no, 0),
   (8, no, 8), (8, yes, 8), (4, yes, 8): 2 warm and 5 timed steps on one
   batch (ms per step, tokens/s, MFU by bench.py's count, peak memory), a
   falling finite loss, every kernel's launches a step as
   ``expected_per_step`` says (the wgmma forward twice per layer under
   remat), the first-step loss of the batch-8 rungs equal; one gradient on
   the kernels against one on their plain versions at (8, no, 8), and
   profiler windows over a step of each batch-8 rung;
6. MoE phase — the same config with a top-1 MoE FFN of 8 experts at
   capacity 1.25, (8, no, 8): the steps as above (K7 twice per layer a
   step), a profiled step, one gradient against K7's plain versions, and
   greedy generation from the trained model through ``DecodeEngine``;
7. f32 phase — the same config in f32, the model's default compute type:
   one request served on f32 pages (a bucket-1024 prefill through the
   simple forward, 32 greedy tokens through K4a, the decode logits held to
   ``apply``), then rungs (8, no, 0) and (8, no, 8) (2 warm and 3 timed
   steps, a profiled step each; the simple forward, the mma.sync / FMA
   backward and the tf32 K3 with its split pass on every step, no wgmma
   flash kernel and chunked_ce.cu's K3 never) and one full-width gradient
   on the kernels against the plain versions;
8. network phase — the DL4J network stack: zoo ResNet-50 through
   ``ComputationGraph`` at benchmarks/resnet_bench.py's config (224x224x3,
   1000 classes, batch 32, Nesterovs(0.1, 0.9), seeded N(0, 1) images and
   one-hot labels): (a) the f32 net on the card against the same net on
   the CPU at batch 4 (training-mode probabilities, loss, every gradient
   leaf, the params and BN statistics after one step) under
   TOL_NET_F32, with a control on TF32 convolutions that must read above
   it; (b) bf16 against f32 on the card (TOL_NET_BF16 from above,
   FLOOR_NET_BF16 from below); (c) 20 bf16 steps
   on one batch: the loss finite and falling, the BN statistics moving,
   ``evaluate``'s accuracy; (d) ``output()`` per-example on the running
   statistics; then host ms a step, images/s, device ms, busy share and
   kernels a step (a profiler window of 3 steps), own peak memory, bf16
   and f32, in turns with a plain-PyTorch ResNet-50 (``nn.Conv2d``,
   ``nn.BatchNorm2d``, ``SGD(nesterov=True)``); the 53 BatchNormalizations
   of that step (forward and backward) by the port's route and by the
   library's (``torch.native_batch_norm``, ``F.batch_norm``) in turns,
   with their agreement; then LeNet through
   ``MultiLayerNetwork`` at batch 64 over a ``ListDataSetIterator``
   through ``DevicePrefetchIterator`` (images/s, ``output``,
   ``evaluate``); then the zoo's VGG16 and Darknet19 at 224², batch 32:
   (a) f32 on the card against the CPU at batch 4 (the same dropout masks
   on both), (b) bf16 against f32, and their timings in turns with plain
   twins; VGG19 and AlexNet (a) only; Xception at 299² the same ((a) at
   batch 2, (b) and timings at batch 32, beside ``plain_xception``); and
   (a) of TinyYOLO, SqueezeNet, UNet, InceptionResNetV1, NASNet and
   FaceNetNN4Small2 at their zoo input sizes. No kernel of the port may
   launch on these paths.
9. recurrent phase — the char-RNNs (``RNN_*`` and R1-R4 below): K11f and
   K11b (the fused LSTM cell a step) against their plain versions at R1's
   and R2's cell shapes, bit-identical from launch to launch, timed beside
   their bound, the plain versions and aten's ``_thnn_fused_lstm_cell``;
   K11Lf and K11Lb (the persistent layer kernels: a layer over a chunk in
   one launch, in clusters of 8 CTAs) the same at R1's and R2's layer
   shapes over a 50-step chunk (TOL_K11L), timed beside their bound, the
   plain loop and one layer of cuDNN's ``nn.LSTM``; a layer past K11L's
   widest (H 512) over a chunk on K11 a step against the plain versions;
   then (a) R1 (the zoo ``TextGenerationLSTM``: 2 × LSTM(256), 47
   characters, batch 32, 1000 characters, TBPTT 50) and R2 (GravesLSTM
   200, BASELINE.json configs[2]) in f32 on the card against the same nets
   on the CPU over one fit (TOL_RNN_F32), a TF32 control failing; (c)
   ``rnnTimeStep`` one character at a time against ``output()``, and
   ``rnnClearPreviousState``; (d) R1 bf16 against f32 (TOL_RNN_BF16 from
   above, FLOOR_RNN_BF16 from below); (e) R3 (R1's layers as a
   ``ComputationGraph``) against R1, and R4 (Bidirectional LSTM →
   ``LastTimeStepVertex``, ragged masks) against each row alone; host ms
   and device ms a chunk, characters/s, busy share, kernels a chunk, K11's
   share and own peak memory of R1 (f32, bf16) and R2 in turns with a
   plain twin (cuDNN's ``nn.LSTM``); one layer over a chunk against
   cuDNN; ``rnnTimeStep`` sampling at batch 1. The recurrent path is one
   fit of R1: K11Lf and K11Lb 2 × 20 times each (a layer and chunk),
   nothing else; the wide layer's K11f and K11b 50 times each.
10. attention phase (before the network phase; ``--attention`` runs it
   alone after the build) — K1 and K2 with a key mask against their plain
   versions (MASKED_CASES: A1's shape and lengths, an interior gap with a
   masked first tile, an element with no key handed over as the op hands
   it, A2's widths, a query of one), masked keys' dk and dv exactly 0,
   timed at A1's shape beside the unmasked kernels, the bound of the kept
   pairs and SDPA with the additive -1e30 mask; then A1 (``A1_*``: an
   embedding of 32768 → 1024, two ``SelfAttentionLayer``s of 16 heads of
   64, masked mean, 10 classes, T 1024, key lengths 256-1024): (a) f32 on
   the card against the CPU, 3 masked fits and ``output`` in bf16 and f32
   at batch 8 with exactly a layer's K1 a forward and K2 a backward and
   the op's plain route never, (b) bf16 against f32; A2 (cross attention
   with and without a key input, learned queries, the three vertices in a
   graph; recurrent attention and a one-head self attention under a mask)
   f32 on the card against the CPU; A1's step timed in turns with a plain
   twin (``nn.Linear``, SDPA with the additive mask). The attention path
   is A1's runs, "attention_modules" A2's.
11. detection phase (after the network phase; ``--detection`` runs it
   alone, building no kernel) — YOLO2 (``DET_*``: 416², 20 classes, 5 VOC
   priors, batch 16, Adam 1e-3, seeded labels of 1-3 boxes an image): (a)
   f32 on the card against the CPU at batch 2 (the decoded confidences and
   class probabilities, the loss, every gradient leaf, one step's
   displacements and BN statistics), (b) bf16 against f32, the detections
   and NMS of the card's f32 activations against the CPU's on the same
   weights after 4 fits (objects within DET_MARGIN of the threshold left
   out), and host ms a step, images/s, device ms, busy share and kernels
   a step in bf16 and f32 in turns with the plain twin (``plain_yolo2``,
   the loss written plainly); then a Bernoulli VAE's ``pretrainLayer``
   (784 → 256 → latent 32, the same draws), a net under DropConnect (the
   same masks) and one with Deconvolution2D and bilinear Upsampling2D,
   each on the card against the CPU (TOL_SMALL). The detection path
   launches no kernel of the port and never the attention op's plain
   route.
12. transfer phase (after the detection phase; ``--transfer`` runs it
   alone, building no kernel) — DL4J's fine-tuning recipe (``TR_*``) on
   the zoo ResNet-50 at 224², batch 32, f32, full depth: a source net's 2
   Adam steps through ``save_pretrained`` / ``init_pretrained`` (every
   param, state and updater leaf bitwise); ``TransferLearning.GraphBuilder``
   frozen to "avgpool" under ``EarlyStoppingGraphTrainer`` with a
   ``LocalFileModelSaver`` and a ``CheckpointListener`` on seeded
   synthetic images of 5 classes (a fitted normalizer,
   ``AsyncDataSetIterator``): frozen params and updater state bitwise
   kept, the head and the frozen BN statistics moved; the best zip
   re-scored; the newest checkpoint resumed beside in-memory copies;
   ``evaluate`` and ``evaluateROCMultiClass``, the best zip on the CPU;
   LeNet on MNIST: ``nout_replace``, featurize, L-BFGS and CG card against
   CPU, a DL4J-format zip; the frozen-trunk step's images/s in f32 and
   bf16 in turns with a plain twin whose trunk takes no gradient, save and
   restore seconds, zip MB, the early-stopping run's seconds and epochs,
   L-BFGS ms an iteration. No kernel of the port, nor the attention op's
   plain route.
13. scoring phase (after the transfer phase; ``--scoring`` runs it alone,
   building no kernel) — the fine-tune → serve loop (``SC_*``) on the zoo
   ResNet-50 at 224², full depth, its trunk's BN statistics set from a
   batch of data (``calibrate_bn``): (1) the transfer recipe's fine-tuning
   (f32, frozen to "avgpool", batch 32, 12 seeded batches) under a
   ``ResilientTrainer`` (checkpoints every 4 iterations, keep 2) through
   a transient ``train.step`` error (retried in place), a crash (restore,
   fast-forward) and a batch that crashes twice (quarantined): restarts,
   restores and quarantines as counted, frozen leaves bitwise, params and
   updater leaves no further from an undisturbed run than two undisturbed
   runs are; (2) ``ModelRegistry.deploy`` of the healed net in f32 and
   bf16 (batch_limit 32, every bucket 1-32 warmed), 16 client threads of
   32 requests (every 4th of 3 images) of held-out images of every class
   through ``ParallelInference``, each request's probabilities (bf16: a
   sample's) held against ``net.output`` of its images alone, the f32
   references' images further apart than the row, a row shift planted in
   ``_distribute`` caught, no bucket miss after the warm-up; images/s,
   p50/p99 latency, occupancy, bucket fill, a profiler window (host and
   device ms, busy share and kernels a batch, the copies' time under
   kernels of other streams), ``inflight_limit`` 1, 2 (f32) and a
   direct batch-32 ``output`` loop in turns; (3) a ``FrontDoor`` over the
   scoring router: a plain JSON classify equal to the in-process
   ``ParallelInference.output``, the healed net's zip restored as v2 and
   canaried over ``/v1/classify`` to full (every shadow comparison a
   match, promoted), v3 under the ``serving.canary`` chaos point rolled
   back, no client request failed; (4) ``global_profile_capture()
   .capture(steps=8)`` under traffic: cuDNN convolution kernels in
   ``top_ops``, their device time within the capture's wall time. The
   fleet phase's workers deploy the demo scoring nets too, and each
   answers one ``/v1/classify`` with the demo net's probabilities. No
   kernel of the port, nor the attention op's plain route.
14. SameDiff phase (``--samediff`` runs it alone after building the
   flash kernels) — HuggingFace's BERT-base (``SD_*``), frozen to a TF
   GraphDef and shipped as a skeleton (its weights stripped;
   ``modelimport/skeletons/``), filled from SEED, imported by the port's
   ``TFGraphMapper``, its weights promoted to variables and a [CLS] head
   attached: (a) at (2, 128) on the card against the port's CPU on the
   same weights (f32, TF32 off): last_hidden_state under a ragged mask,
   the first gradient's every leaf, 3 Adam steps' losses (``TOL_SD``);
   (b) ``SameDiff.fit`` at (32, 128), Adam 2e-5, 2 warm-up and 10 timed
   steps: samples/s, host ms a step, a profiled step's device busy time,
   busy share and kernels, the import's seconds, peak memory, every loss
   finite; then the moments pass (``DL4J_TPU_GRAPH_OPT``) off and on in
   turns, host ms, device ms and kernels a step of each; (c) a SameDiff graph over ``sd.nn.multi_head_dot_product_
   attention`` at BERT-base's widths (32, 12 heads of 64, T 128, ragged key
   mask): ``output`` and ``calculate_gradients`` on K1/K2 against the same
   graph on the op's plain version (the f32 K1/K2 rows). The imported path
   launches no kernel of the port (its attention is BatchMatMulV2 +
   Softmax); (c) launches K1 and K2.
15. ONNX phase (``--onnx`` runs it alone after building the four
   flash sources) — the zoo's ResNet-50 (network_phase's configuration),
   its BatchNormalization statistics set from 32 images, authored as an
   ONNX model by ``tools/onnx_resnet.py`` and imported by the port's
   ``OnnxGraphMapper``: (a) at (2, 3, 224, 224) on the card against the
   port's CPU (logits, probabilities; imported trainable, the first
   gradient's every leaf and 3 Adam steps' losses in lock-step,
   ``TOL_ONNX``); (b) on the card against the port's NHWC
   ComputationGraph on the same weights, 32 images, the logits' spread
   above ``ONNX_SPREAD_FLOOR``; (c) served at batch 32, 224², f32 (2
   warm-up and 10 timed ``output`` calls) and fine-tuned (2 warm-up and 5
   timed ``fit`` steps): images/s, host and device ms, kernels and busy
   share of a call and a step, import and authoring seconds, peak memory,
   every loss finite; (d) the registry's fused attention ops
   (``multi_head_dot_product_attention``, ``dot_product_attention_v2``,
   the ``_bp`` op) at BERT-base's widths, f32 and bf16, key-masked and
   causal, on K1/K2 against the same graphs on the ops' plain versions.
   (a)-(c) launch no kernel of the port; every path of (d) launches K1
   and K2 and takes no plain route.
16. distributed phase (last; ``--distributed`` runs it alone after
   building threshold.cu and the flash sources) — data-parallel training
   over a one-rank NCCL process group: (a) K6 (K6e, K6d, K6s-enc, K6s-dec
   of ``threshold.cu``) against its plain versions at ResNet-50's bucket
   (23.9 M elements at 200 classes), BERT-base's 109.48 M and the edges
   (1, 33, 2^20 + 7 elements; no hits, every hit, a capacity below the
   hits, t = 0, NaN, ±inf, −0.0, malformed buffers): signs, counts,
   entries, n, sparse residuals and decodes exact (a NaN for a NaN), the
   scale terms and Σ residual'² relative ``TOL_K6_SCALAR``, a second
   launch bit-identical; each timed (``device_ms``, ``ms``, the plain
   version, the bound) beside NCCL's all-reduce of the int8 wire and of
   the f32 bucket at world size 1 (a device copy); (b) the path:
   ``SharedTrainingMaster`` (adaptive threshold) over
   ``SparkComputationGraph`` and the zoo ResNet-50 on
   ``TinyImageNetDataSetIterator`` (64², 200 classes, batch 32, f32),
   ``DIST_STEPS`` steps, each exchange against the plain one on the same
   captured g and residual, K6e and K6d launched once a step and nothing
   else, three all-reduces a step; (c) the kill switch
   (``DL4J_TPU_GRAD_COMPRESS=0``): the dense trainer against the net's own
   fit, within what two own fits differ by; (d) ``gradCompression.npz``:
   restore-resume against the in-memory continuation, within what two
   restored copies differ by; (e) SameDiff ``set_mesh`` on the BERT-base
   skeleton at (2, 128) against no mesh (``TOL_SD``'s loss row); then the
   net's own fit, the dense and the compressed trainer in turns, profiled
   (K6's share of the compressed step's device time).

Every phase must pass: any failure exits nonzero. Output is one JSON
object per line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or outside a checkout, it exits nonzero and prints no result.

``python3 chip_smoke.py --compare-bwd OTHER`` instead times K2 (and K1 at
its main shapes) in this tree and in the checkout at OTHER in turns
(OTHER, this, this, OTHER), each turn a subprocess running that tree's
``kernel_phase`` and ``bwd_phase`` on the bf16 d 64/128 cases, and prints
each case's device ms per turn; ``--compare-f32 OTHER`` does the same for
the simple forward and the mma.sync / FMA backward at F32_COMPARE_CASES.
``--precision-f32`` holds the f32 kernels and the plain versions against
f64 at the f32 shapes; ``--precision-ce-f32`` holds the f32 K3 (the scalar
FMA kernel of chunked_ce.cu and the tf32 one) and its plain versions
against f64 at the f32 training shape, and times both kernels in turns.
``--compare-decode OTHER`` profiles and times decode steps over bf16 and
int8 pages at the large config here and in the checkout at OTHER in turns
(kernels a step, device busy time a step, host ms a step).
``--compare-k11l OTHER...`` times K11Lf and K11Lb at R1's and R2's layer
shapes here and in each checkout at OTHER in turns.
``--network`` runs the network phase alone (it builds no kernel);
``--detection`` the detection phase alone (no kernel either);
``--transfer`` the transfer phase alone (no kernel either);
``--scoring`` the scoring phase alone (no kernel either);
``--readings [MODEL...]`` takes the CPU readings the new zoo models' and
the small paths' rows were set from (f32 against f64, bf16 against f32;
no card needed), printed and written to OUT_DIR/``zoo_readings.json``
(``--readings transfer``: the solver row's readings; ``--readings
scoring``: the scoring rows', OUT_DIR/``scoring_readings.json``);
``--distributed`` the distributed phase alone (it builds threshold.cu
and the flash sources); ``--ranks N`` trains data-parallel over N cards,
one process each over NCCL (the dense and the compressed trainer on
ResNet-50 at 64², the ranks' params held equal, NCCL's all-reduce timed);
``--attention`` the attention phase alone (after building every kernel);
``--recurrent`` the recurrent phase alone (it builds only rnn_cell.cu,
K11 and K11L); ``--samediff`` the SameDiff phase alone (it builds only the
flash sources); ``--onnx`` the ONNX phase alone (the four flash sources).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types
import zipfile
from pathlib import Path

import numpy as np

SEED = 0
N_NEW = 32
PROMPT_LENS = (960, 500, 200, 37)       # buckets 1024, 512, 256, 64
PROFILE_PROMPT = 960                    # bucket 1024
ROOT = Path(__file__).resolve().parent
# where the profile phase writes its Chrome trace (gitignored)
OUT_DIR = ROOT / "deeplearning4j_tpu_torch" / "_build"
# Kernel cases: (layout, B, H, Tq, Tk, d, dtype, causal). "fused" is the
# (B, H, T, d) views of one (B, T, 3·H·d) projection with o written into
# the (B, H, T, d) view of a (B, T, H, d) buffer, as TransformerLM._attn
# calls the wrapper; "3d" is contiguous (B·H, T, d) (H = 1).
KERNEL_CASES = [
    # the main path: prefill buckets (B 1, 16 heads, d 64) and the batch
    ("fused", 1, 16, 1024, 1024, 64, "bfloat16", True),
    ("fused", 1, 16, 512, 512, 64, "bfloat16", True),
    ("fused", 1, 16, 256, 256, 64, "bfloat16", True),
    ("fused", 1, 16, 64, 64, 64, "bfloat16", True),
    ("fused", 4, 16, 128, 128, 64, "bfloat16", True),
    ("fused", 1, 16, 991, 991, 64, "bfloat16", True),    # apply, ragged
    # block edges
    ("fused", 1, 16, 127, 127, 64, "bfloat16", True),
    ("fused", 1, 16, 129, 129, 64, "bfloat16", True),
    ("fused", 1, 16, 1, 1, 64, "bfloat16", True),
    # contiguous (B·H, T, d)
    ("3d", 16, 1, 1024, 1024, 64, "bfloat16", True),
    ("3d", 64, 1, 512, 512, 64, "bfloat16", True),
    ("3d", 16, 1, 1000, 1000, 64, "bfloat16", True),
    ("3d", 16, 1, 1024, 1024, 64, "bfloat16", False),
    # the training layer (bench large config, batch 8)
    ("fused", 8, 16, 1024, 1024, 64, "bfloat16", True),
    # non-causal with Tq != Tk
    ("3d", 16, 1, 512, 1024, 64, "bfloat16", False),
    ("fused", 2, 16, 300, 77, 64, "bfloat16", False),
    # d 128
    ("3d", 16, 1, 512, 512, 128, "bfloat16", True),
    ("fused", 1, 8, 1024, 1024, 128, "bfloat16", True),
    # the simple kernel: f32 (the table's shape, the f32 model's prefill and
    # its training layer), and bf16 at other head dims
    ("3d", 16, 1, 256, 256, 64, "float32", True),
    ("fused", 1, 16, 1024, 1024, 64, "float32", True),
    ("fused", 8, 16, 1024, 1024, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 80, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 96, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 256, "bfloat16", True),
    ("fused", 1, 8, 129, 129, 80, "bfloat16", True),
    # head dims the kernels took from PR 9 on: 8, 40 (d % 16 == 8), 136 and
    # 256 (tile width 192 and 256), both types
    ("fused", 2, 4, 130, 130, 8, "float32", True),
    ("fused", 2, 4, 130, 130, 8, "bfloat16", True),
    ("3d", 8, 1, 200, 200, 40, "float32", True),
    ("3d", 8, 1, 200, 200, 40, "bfloat16", False),
    ("fused", 1, 2, 150, 150, 136, "float32", True),
    ("3d", 4, 1, 300, 77, 256, "float32", False),
    # the serving fleet's demo model (f32, 2 heads of 16): a prefill in
    # each of its buckets (16, 32, 48; an adoption's re-prefill of prompt
    # and emitted tokens lands mostly in 32)
    ("fused", 1, 2, 16, 16, 16, "float32", True),
    ("fused", 1, 2, 32, 32, 16, "float32", True),
    ("fused", 1, 2, 48, 48, 16, "float32", True),
]
MAIN_CASE = {"wgmma": ("fused", 1, 16, 1024, 1024, 64, "bfloat16", True),
             "simple": ("3d", 16, 1, 256, 256, 64, "float32", True)}
SOURCES = {"wgmma": "flash_attention_fwd_wgmma.cu",
           "simple": "flash_attention_fwd.cu",
           "bwd_wgmma": "flash_attention_bwd_wgmma.cu",
           "bwd": "flash_attention_bwd.cu"}
# the launch counters of the four kernels, in the order counts() gives them
KERNELS = ("wgmma", "simple", "bwd_wgmma", "bwd")
# every kernel of the port, in the order all_counts() gives their launches:
# the four flash kernels, then K3f and K3b of chunked_ce.cu (bf16 at other
# d; its f32 kernel, on no path since the tf32 one), K7d and K7c, then the
# wgmma K3f and K3b (bf16 at d % 64 == 0), then K4a (paged decode attention)
# and K4w (int8 quantize-and-scatter), then the tf32 K3f and K3b (f32) and
# their operands' split pass, then K4a+w (the decode store in K4a's launch),
# then K11f and K11b (the fused LSTM cell a step), then K11Lf and K11Lb
# (the persistent LSTM layer kernels), then K6e, K6d, K6s-enc and K6s-dec
# (the threshold codec); last the one count that is no
# kernel's: ``attention_plain``, calls of the attention op on the card that
# took its plain version by its stated rule (0 on every path)
ALL_KERNELS = KERNELS + ("ce_fwd", "ce_dlogits", "moe_dispatch",
                         "moe_combine", "ce_fwd_wgmma", "ce_dlogits_wgmma",
                         "paged_attention", "kv_quant_write", "ce_fwd_tf32",
                         "ce_dlogits_tf32", "ce_split_tf32",
                         "paged_attention_write", "rnn_cell_fwd",
                         "rnn_cell_bwd", "rnn_layer_fwd", "rnn_layer_bwd",
                         "k6_encode", "k6_decode", "k6s_encode",
                         "k6s_decode", "attention_plain")
SOURCES.update(ce_fwd="chunked_ce.cu", ce_dlogits="chunked_ce.cu",
               moe_dispatch="moe_route.cu", moe_combine="moe_route.cu",
               ce_fwd_wgmma="chunked_ce_wgmma.cu",
               ce_dlogits_wgmma="chunked_ce_wgmma.cu",
               paged_attention="paged_attention.cu",
               kv_quant_write="paged_attention.cu",
               ce_fwd_tf32="chunked_ce_tf32.cu",
               ce_dlogits_tf32="chunked_ce_tf32.cu",
               ce_split_tf32="chunked_ce_tf32.cu",
               paged_attention_write="paged_attention.cu",
               rnn_cell_fwd="rnn_cell.cu", rnn_cell_bwd="rnn_cell.cu",
               rnn_layer_fwd="rnn_cell.cu", rnn_layer_bwd="rnn_cell.cu",
               k6_encode="threshold.cu", k6_decode="threshold.cu",
               k6s_encode="threshold.cu", k6s_decode="threshold.cu")
# K2 (backward) cases, laid out as KERNEL_CASES: "fused" takes q, k, v from
# one (B, T, 3·H·d) projection, o from the forward written as TransformerLM
# writes it, dO as the (B, H, T, d) view of a (B, T, H·d) gradient, and
# writes dq, dk, dv into the views of (B, T, 3·H·d) gradient buffers
BWD_CASES = [
    ("fused", 8, 16, 1024, 1024, 64, "bfloat16", True),   # the training layer
    ("fused", 1, 16, 991, 991, 64, "bfloat16", True),     # ragged
    ("fused", 1, 16, 127, 127, 64, "bfloat16", True),     # block edges
    ("fused", 1, 16, 129, 129, 64, "bfloat16", True),
    ("fused", 1, 16, 1, 1, 64, "bfloat16", True),
    ("fused", 2, 16, 300, 77, 64, "bfloat16", False),     # Tq != Tk
    ("fused", 1, 8, 1024, 1024, 128, "bfloat16", True),   # d 128
    ("3d", 16, 1, 256, 256, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
    ("fused", 1, 8, 129, 129, 80, "bfloat16", True),
    # f32 at the f32 model's prefill shape and its training layer; bf16 at
    # d 80, 96 and 256; the head dims taken from PR 9 on
    ("fused", 1, 16, 1024, 1024, 64, "float32", True),
    ("fused", 8, 16, 1024, 1024, 64, "float32", True),
    ("3d", 16, 1, 512, 512, 80, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 96, "bfloat16", True),
    ("3d", 16, 1, 512, 512, 256, "bfloat16", True),
    ("fused", 2, 4, 130, 130, 8, "float32", True),
    ("fused", 2, 4, 130, 130, 8, "bfloat16", True),
    ("3d", 8, 1, 200, 200, 40, "float32", True),
    ("3d", 8, 1, 200, 200, 40, "bfloat16", False),
    ("fused", 1, 2, 150, 150, 136, "float32", True),
    ("3d", 4, 1, 300, 77, 256, "float32", False),
    # the serving fleet's demo model (f32, 2 heads of 16): a prefill in
    # each of its buckets (16, 32, 48; an adoption's re-prefill of prompt
    # and emitted tokens lands mostly in 32)
    ("fused", 1, 2, 16, 16, 16, "float32", True),
    ("fused", 1, 2, 32, 32, 16, "float32", True),
    ("fused", 1, 2, 48, 48, 16, "float32", True),
]
BWD_MAIN_CASE = {"bwd_wgmma": BWD_CASES[0], "bwd": BWD_CASES[7]}
# the bench's large config (bench.py, the "large" rung)
LARGE = dict(vocab_size=32768, n_layers=12, n_heads=16, d_model=1024,
             d_ff=4096, max_len=1024, dtype="bfloat16", fused_qkv=True)
# the model's default compute type: the same config in f32 (f32 pages when
# serving), the path of the simple forward and the mma.sync backward
LARGE_F32 = dict(LARGE, dtype="float32")
F32_RUNGS = ((8, False, 0), (8, False, 8))
F32_TIMED_STEPS = 3
# tolerances (PERF.md states the reasons): kernel vs plain version on the
# same inputs, and decode logits vs the full forward over the same tokens
TOL_O = {"bfloat16": 2e-2, "float32": 5e-5}
TOL_LSE = 1e-3
TOL_TEACHER_FORCED = 0.1
# the f32 model's decode logits against apply: set from readings on the
# H100 (PERF.md) between a sound run's (2.35e-5: f32 sums in another order
# through 12 layers, the split forward's o within ~6e-6 of the plain
# version's) and a control's whose forward rounds its operands to TF32
# alone (3.55e-4), 4x over the one and 3.5x under the other
TOL_TEACHER_FORCED_F32 = 1e-4
# K2 vs its plain version: max |dg| over max(1, max |g_plain|) per gradient,
# and the relative L2 error of each 64-row tile along T of each gradient
# (its norm floored at an rms of GRAD_RMS_FLOOR, so a tile that cancels to
# ~0 is held to an absolute error); one full-width gradient on the kernels
# vs on the plain versions: |dloss|, and each leaf's relative L2 error
TOL_GRAD = {"bfloat16": 1e-2, "float32": 1e-5}
TOL_GRAD_TILE_L2 = {"bfloat16": 1e-3, "float32": 5e-7}
GRAD_RMS_FLOOR = {"bfloat16": 1e-3, "float32": 1e-6}
TOL_STEP_LOSS = 5e-5
TOL_STEP_LEAF = 1.5e-2
# the same for the f32 model at (8, no, 8). The loss, near 9, is a mean
# whose own f32 rounding (an ulp is 9.5e-7 there) is all a run can read:
# sound runs read 2-3 ulps, the TF32-alone control 1, so its limit (5
# ulps) only catches gross faults. The leaves tell precision apart: set
# from readings on the H100 (PERF.md) between sound runs' (1.28e-5,
# 1.32e-5) and the control's (1.61e-4), 4x over the one and 3x under the
# other
TOL_STEP_LOSS_F32 = 5e-6
TOL_STEP_LEAF_F32 = 5e-5
# the same at the MoE phase with only K7 on its plain version: combine's f32
# sums (fused multiply-adds against rounded products) move a bf16 ulp here
# and there, and 12 layers carry it back to the first ones; set from the
# readings (|Δloss| 0, worst leaf 2.7e-3 at pos_emb; PERF.md)
TOL_MOE_STEP_LOSS = 5e-5
TOL_MOE_STEP_LEAF = 1e-2
# the tied LM head on the card (bf16 operands, f32 logits, bf16 dlogits in
# its backward) vs autograd through the f32 product, at the training layer:
# relative L2 error of the logits and of each gradient
TOL_HEAD = {"logits": 5e-6, "dx": 5e-3, "de": 5e-3}
# the training phase: bench.py's ladder for the large config, as (batch,
# remat, ce_chunks) (bench.py:323-324); the first rung is the one profiled
TRAIN_BATCH = 8
TRAIN_RUNGS = ((8, False, 0), (8, False, 8), (8, True, 8), (4, True, 8))
GRAD_RUNG = (8, False, 8)          # the rung of the kernels-vs-plain gradient
PROFILED_RUNGS = TRAIN_RUNGS[:3]   # a profiler window over one step of each
WARM_STEPS = 2
TIMED_STEPS = 5
LEARNING_RATE = 3e-4
# the MoE training phase: the large config with a top-1 MoE FFN of 8 experts
# (capacity factor 1.25), ce_chunks 8, batch 8, no remat
MOE_EXPERTS = 8
MOE_RUNG = (8, False, 8)
# K3 (chunked cross-entropy) cases: (rows N, vocab V, d, dtype, ce chunks);
# the first is the training layer (bench large config, batch 8), the last
# the same in f32 (the f32 model's training layer). The bf16 cases take the
# wgmma kernels, the f32 ones the tf32 kernels (the small one ragged-free
# but many splits)
CE_CASES = [
    (8192, 32768, 1024, "bfloat16", 8),
    (4096, 32768, 1024, "bfloat16", 8),      # batch 4
    (1000, 5000, 1024, "bfloat16", 4),       # ragged rows and vocab
    (1, 384, 64, "bfloat16", 3),
    (1024, 4096, 256, "float32", 4),
    (8192, 32768, 1024, "float32", 8),
]
# the case each K3 kernel's kernels-line numbers come from: the training
# shape of its type (chunked_ce.cu's, on no path for f32, from its
# turns against the tf32 kernels there)
CE_MAIN_CASE = {"ce_fwd_wgmma": CE_CASES[0], "ce_dlogits_wgmma": CE_CASES[0],
                "ce_fwd": CE_CASES[5], "ce_dlogits": CE_CASES[5],
                "ce_fwd_tf32": CE_CASES[5], "ce_dlogits_tf32": CE_CASES[5],
                "ce_split_tf32": CE_CASES[5]}
# where chunked_ce.cu's kernels are forced onto the operands and timed in
# turns against the kernels that take them: the bf16 and f32 training
# shapes
CE_TURN_CASES = (CE_CASES[0], CE_CASES[5])
# K7 (MoE dispatch / combine) cases: (tokens G, experts E, slots C, top_k,
# d, dtype); the first is the training layer (G 8192, cf 1.25 top-1)
MOE_CASES = [
    (8192, 8, 1280, 1, 1024, "bfloat16"),
    (8192, 8, 2560, 2, 1024, "bfloat16"),    # top-2 at cf 1.25
    (1000, 8, 100, 2, 512, "bfloat16"),      # drops
    (8, 2, 4, 1, 64, "bfloat16"),
    (300, 4, 100, 2, 96, "float32"),
]
# tolerances (PERF.md gives the reasons): K3f's lse and loss against the
# plain version; K3b's dlogits off the target entries by relative L2, and at
# the target entries by max |Δ| over g/N; K7's gathers exact, combine within
# one bf16 ulp of its largest output (1e-6 in f32), d_gate 1e-2 (1e-5)
TOL_CE_LSE = 1e-4
TOL_CE_DLOG_L2 = {"bfloat16": 5e-3, "float32": 1e-5}
TOL_CE_DLOG_TARGET = {"bfloat16": 2 ** -7, "float32": 1e-5}
TOL_MOE_COMBINE = {"bfloat16": 2 ** -8, "float32": 1e-6}
TOL_MOE_DGATE = {"bfloat16": 1e-2, "float32": 1e-5}
# K4a (paged decode attention) cases: (slots B, window W, heads H, head dim
# hd, page tokens P, pages a slot n_lp, q's dtype, pool ("same" as q or
# "int8"), each slot's context (its window ends at context − 1), slots whose
# table row is all trash). The first is the main path's decode step (bench
# large config: 16 heads of 64, pages of 64 over a 1024 span); W 5 is the
# speculative verify window (spec_k 4); P = S = 1024 is the dense cache.
DECODE_CASES = [
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (1024,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (37,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (500,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (960,), ()),
    (1, 5, 16, 64, 64, 16, "bfloat16", "same", (960,), ()),
    (8, 1, 16, 64, 64, 16, "bfloat16", "same", (1024,) * 8, ()),
    (8, 5, 16, 64, 64, 16, "bfloat16", "same", (1024,) * 8, ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "int8", (1024,), ()),
    (1, 5, 16, 64, 64, 16, "bfloat16", "int8", (500,), ()),
    (8, 1, 16, 64, 64, 16, "bfloat16", "int8", (1024,) * 8, ()),
    (8, 5, 16, 64, 64, 16, "bfloat16", "int8", (37, 500, 960, 1024) * 2,
     ()),
    (1, 1, 16, 64, 1024, 1, "bfloat16", "same", (1024,), ()),   # dense
    (1, 5, 16, 64, 1024, 1, "bfloat16", "same", (960,), ()),
    (2, 3, 16, 64, 16, 64, "bfloat16", "int8", (700, 33), ()),  # P 16
    (1, 4, 8, 128, 64, 8, "bfloat16", "same", (512,), ()),      # hd 128
    (2, 2, 4, 16, 32, 4, "bfloat16", "int8", (128, 5), ()),     # hd 16
    (2, 5, 16, 64, 64, 16, "float32", "same", (300, 1024), ()),
    # a window whose tail runs past S, and a free slot (all trash)
    (3, 5, 16, 64, 64, 4, "bfloat16", "int8", (258, 40, 300), (1,)),
    # 64 splits through the last block's merge; W 16 at hd 128, where q
    # and o take the most registers (two warps' worth of queries)
    (1, 1, 1, 64, 64, 64, "bfloat16", "same", (4096,), ()),
    (1, 16, 8, 128, 64, 16, "bfloat16", "same", (1024,), ()),
]
DECODE_MAIN_CASE = {"paged_attention": DECODE_CASES[0],
                    "paged_attention_int8": DECODE_CASES[7],
                    "paged_attention_dense": DECODE_CASES[11]}
# K4a's split counts timed at the main decode step and the verify window
# (B 8, W 5), beside key_splits' own choice
SPLIT_SWEEP = {DECODE_CASES[0]: (4, 8, 9, 12, 16, 24, 32, 64),
               DECODE_CASES[6]: (1, 2, 3, 4, 6, 8, 16)}
# every instantiation of K4a's kernel in ptxas's report: compute dtype /
# pool type, queries a warp, elements a lane's chunk
K4A_INSTANTIATIONS = sorted(
    [f"bf16/same w{w} e8" for w in (1, 5, 8)]
    + [f"f32/same w{w} e4" for w in (1, 5, 8)]
    + [f"f32/same w{w} e8" for w in (1, 5)]
    + [f"{t}/int8 w1 e16" for t in ("bf16", "f32")]
    + [f"{t}/int8 w{w} e8" for t in ("bf16", "f32") for w in (1, 5, 8)])
# K4w cases: (slots B, window W, layers, page tokens P, rows' dtype); B = 1
# with W > 1 layer is a prefill insert (rows of a T-token bucket into whole
# pages, zero-padded), else a decode or verify window (one layer). Each has
# an all-zero row. The first is the main path's, the insert at bucket 1024
# (since K4a+w stores the decode rows, K4w's only caller).
QUANT_CASES = [
    (1, 1024, 12, 64, "bfloat16"),      # the insert at bucket 1024
    (1, 32, 12, 64, "bfloat16"),        # bucket 32 into one padded page
    (1, 1, 1, 64, "bfloat16"),
    (1, 5, 1, 64, "bfloat16"),
    (8, 5, 1, 64, "bfloat16"),
    (2, 5, 1, 16, "float32"),
]
# K4a+w at the pipeline's shapes: 4 slots at the prompt lengths' contexts
# (each slot at its own position) in the decode step on bf16 pages, the
# verify window (spec_k 4) on int8 pages, and the draft's decode step on
# its dense cache
PIPE_FUSED_CASES = [
    (4, 1, 16, 64, 64, 16, "bfloat16", "same", (37, 200, 500, 960), ()),
    (4, 5, 16, 64, 64, 16, "bfloat16", "int8", (37, 200, 500, 960), ()),
    (4, 1, 16, 64, 1024, 1, "bfloat16", "same", (37, 200, 500, 960), ()),
]
# K4a+w cases (DECODE_CASES' shapes, the window's rows stored in the
# launch): bf16 pages, int8 pages and the dense cache at the decode step,
# the verify window at B 8, a window past S with a free slot, f32 pages,
# and the pipeline's shapes. The first three, and B 8 W 5 on bf16 pages,
# are timed in turns against the two-launch path (the store's own launch,
# then K4a).
# K4a+w at the serving fleet's demo model: 8 slots, 2 heads of 16, f32
# pages of 48 tokens (one a slot), contexts of a drill's streams
FLEET_FUSED_CASES = [
    (8, 1, 2, 16, 48, 1, "float32", "same", (4, 9, 12, 17, 6, 20, 22, 7),
     ()),
]
FUSED_CASES = [DECODE_CASES[0], DECODE_CASES[7], DECODE_CASES[11],
               DECODE_CASES[6], DECODE_CASES[10], DECODE_CASES[12],
               DECODE_CASES[17], DECODE_CASES[16], *PIPE_FUSED_CASES,
               *FLEET_FUSED_CASES]
FUSED_TURN_CASES = FUSED_CASES[:4]
FUSED_MAIN_CASE = {"paged_attention_write": DECODE_CASES[0],
                   "int8": DECODE_CASES[7], "dense": DECODE_CASES[11]}
# the serving modes at full width: int8 pages with plain decode, bf16 pages
# with speculative decoding (a 2-layer truncated draft with a dense cache,
# spec_k 4), and both
SPEC_K = 4
DRAFT_LAYERS = 2
# the first-step loss of a rung with ce_chunks (or remat) against the same
# batch and weights at (8, False, 0): f32 sums in another order
TOL_RUNG_LOSS = 5e-5
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA
# (the training step's f32 GEMMs run there: TF32 is off), device memory
# bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# the rate f32 products on the tensor cores could run at (attention's and
# K3's): three TF32 products (the split that keeps f32 accuracy) at the
# 495 TFLOP/s dense TF32 peak
ATTN_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
# the wgmma kernel's 384 threads: ptxas must budget 168 registers a thread
# at entry, which its setmaxnreg 24 / 240 split balances to the register
WGMMA_ENTRY_REGISTERS = 168
# the wgmma kernels' instantiations (the key mask a template parameter
# since PR 17): the forward at d 64 and 128, the backward's dQ and dK/dV
# kernels at each, each unmasked and masked
WGMMA_INSTANTIATIONS = (64, 128, "64 masked", "128 masked")
BWD_WGMMA_INSTANTIATIONS = tuple(
    f"d{d} {k}{m}" for d in (64, 128) for k in ("dq", "dkdv")
    for m in ("", " masked"))
# the profile phase fails when the trace holds no device work; only a CPU
# rehearsal of the phase sets this to False
TRACE_ON_DEVICE = True


def emit(**kv):
    print(json.dumps(kv), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, torch, iters=20, repeats=7):
    """Median over ``repeats`` of CUDA-event time per call of ``fn``, the
    host's work for each call included (back-to-back Python calls)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


_SIDE = []


def _warm_on_side(fn, torch):
    """One call of ``fn`` on a side stream before a capture, as CUDA graphs
    ask. One side stream serves every call: cuBLAS keeps a 32 MiB workspace
    for each stream a product ran on, for the life of the process."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def device_ms(fn, torch, launches=20, repeats=7):
    """Device time per call of ``fn``: ``launches`` calls captured into one
    CUDA graph, the median over ``repeats`` replays timed with CUDA events.
    The host's work runs once, at capture, so it is not in the time."""
    _warm_on_side(fn, torch)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(times)


def graph_outputs(fn, torch, launches=20, replays=3):
    """Copies of the outputs of ``launches`` calls of ``fn`` captured in one
    CUDA graph, taken after each of ``replays`` replays."""
    _warm_on_side(fn, torch)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(launches)]
    got = []
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        got.extend(o.clone() for o in outs)
    del graph
    return got


def exactness(first, second, replayed):
    """A kernel's run-to-run fields: ``deterministic`` (a second eager call
    gave the first's bits) and ``replay_exact`` (so did every output of
    every CUDA-graph replay)."""
    return {"deterministic": bool(first.equal(second)),
            "replay_exact": bool(replayed)
            and all(bool(first.equal(r)) for r in replayed)}


def _kept_pairs(t_q, t_k, causal):
    """(query, key) pairs attention computes: all of them, or causally
    only k_idx <= q_idx."""
    return (sum(min(i + 1, t_k) for i in range(t_q)) if causal
            else t_q * t_k)


def _bound(flops, nbytes, dtype, peaks=None):
    t_ops = flops / (PEAK_FLOPS if peaks is None else peaks)[dtype]
    t_mem = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def attention_bound_ms(bh, t_q, t_k, d, dtype, causal, peaks=None):
    """Least time for one call: the larger of its FLOPs over the peak
    rate of its type (``ATTN_PEAK_FLOPS``: f32 at a third of the TF32
    rate, or ``peaks``) and its bytes (q, k, v read once, o and lse
    written once) over the memory rate. Causal counts only the kept pairs
    (k_idx <= q_idx)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * bh * d * _kept_pairs(t_q, t_k, causal)
    nbytes = itemsize * bh * d * 2 * (t_q + t_k) + 4 * bh * t_q
    return _bound(flops, nbytes, dtype, peaks or ATTN_PEAK_FLOPS)


def attention_bwd_bound_ms(bh, t_q, t_k, d, dtype, causal, peaks=None):
    """Least time for one backward call: the five products of
    ``_bwd_blockwise`` (S = QKᵀ, dV = PᵀdO, dP = dO·Vᵀ, dQ = dS·K,
    dK = dSᵀQ), 2·d FLOPs per kept pair each, over the peak rate of the
    type (as :func:`attention_bound_ms`), against q, k, v, o, dO and lse
    read once and dq, dk, dv written once over the memory rate."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 10.0 * bh * d * _kept_pairs(t_q, t_k, causal)
    nbytes = itemsize * bh * d * 4 * (t_q + t_k) + 4 * bh * t_q
    return _bound(flops, nbytes, dtype, peaks or ATTN_PEAK_FLOPS)


def tile_rel_l2(x, ref, rms_floor, rows=64):
    """The largest relative L2 error of ``x`` against ``ref`` over tiles of
    ``rows`` rows along dim -2 (T for an attention gradient), each tile's
    norm floored at ``rms_floor`` times the root of its size."""
    worst = 0.0
    for a, b in zip(x.float().split(rows, dim=-2),
                    ref.float().split(rows, dim=-2)):
        den = max(b.norm().item(), rms_floor * math.sqrt(b.numel()))
        worst = max(worst, (a - b).norm().item() / den)
    return worst


def train_flops_per_token(n_params, n_layers, seq_len, d_model):
    """bench.py's count for a causal LM's training step: 6·N for the
    forward and backward through the params, plus 6·L·T·d for attention."""
    return 6 * n_params + 6 * n_layers * seq_len * d_model


def case_inputs(torch, case):
    """q, k, v, an output view (or None) and SDPA's 4-D q, k, v."""
    layout, b, h, t_q, t_k, d, dtype, _causal = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(
        b * 1000003 + h * 10007 + t_q * 101 + t_k + d)
    if layout == "3d":
        q = torch.randn((b, t_q, d), generator=g, device="cuda", dtype=dt)
        k, v = (torch.randn((b, t_k, d), generator=g, device="cuda",
                            dtype=dt) for _ in range(2))
        return q, k, v, None, (q[None], k[None], v[None])
    c = h * d
    xq = torch.randn((b, t_q, 3 * c), generator=g, device="cuda", dtype=dt)
    xk = (xq if t_k == t_q else
          torch.randn((b, t_k, 3 * c), generator=g, device="cuda", dtype=dt))
    q = xq[..., :c].reshape(b, t_q, h, d).transpose(1, 2)
    k = xk[..., c:2 * c].reshape(b, t_k, h, d).transpose(1, 2)
    v = xk[..., 2 * c:].reshape(b, t_k, h, d).transpose(1, 2)
    out = torch.empty((b, t_q, h, d), device="cuda", dtype=dt).transpose(1, 2)
    return q, k, v, out, (q, k, v)


def _ptxas(log, entry, key):
    """{key(match): {"registers": n, "spill_bytes": stores + loads}} for
    each kernel entry whose mangled name matches the regex ``entry`` in a
    ptxas report (``-Xptxas -v``)."""
    report, k = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(entry, line)
            k = key(m) if m else None
            if k is not None:
                report[k] = {}
            continue
        if k is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[k]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[k]["registers"] = int(m.group(1))
    return report


def k4a_ptxas(log):
    """{"bf16/same w1 e8": {"registers": n, "spill_bytes": n}, ...} for
    each instantiation of K4a's ``paged_attend_kernel<DT, KQ, WM, E>``."""
    return _ptxas(
        log, r"paged_attend_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d+)EE",
        lambda m: (("bf16" if m.group(1) == "1" else "f32") + "/"
                   + ("int8" if m.group(2) == "1" else "same")
                   + f" w{m.group(3)} e{m.group(4)}"))


K4W_INSTANTIATIONS = ["bf16", "f32"]


def k4a_readonly_loads(sass):
    """{function: 64- and 128-bit loads through the read-only path} for
    each K4a instantiation in ``cuobjdump -sass`` output. K4a+w reads back
    rows its block stored in the same launch, which that path need not
    see, so the pool loads must take the coherent one: every count 0."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "paged_attend_kernel" in name:
            out[name] = len(re.findall(
                r"LDG\.E\.(?:64|128)\.CONSTANT|LDG\.E\.CONSTANT\.(?:64|128)",
                fn))
    return out


def k4w_ptxas(log):
    """{"bf16": {...}, "f32": {...}}: K4w's ``quant_write_kernel<T>``."""
    return _ptxas(log, r"quant_write_kernelI(13__nv_bfloat16|f)E",
                  lambda m: "f32" if m.group(1) == "f" else "bf16")


def spill_free(report, want):
    """True when ``report`` (from :func:`_ptxas`) lists exactly the
    entries ``want``, each with its registers and no spilled bytes."""
    return sorted(report) == sorted(want) and all(
        "registers" in r and r.get("spill_bytes") == 0
        for r in report.values())


def wgmma_ptxas(log):
    """{head dim: {"registers": n, "spill_bytes": n}} for each
    instantiation of the wgmma forward, the key-masked ones as "64 masked"
    and "128 masked"."""
    return _ptxas(log, r"flash_fwd_wgmma_kernelILi(\d+)E(?:Lb([01])E)?",
                  lambda m: int(m.group(1)) if m.group(2) != "1"
                  else f"{m.group(1)} masked")


def serialized_wgmma(log):
    """ptxas's warnings that it serialized wgmma (C7514, C7512: issue or
    wait counts it cannot prove), which cost the overlap a kernel is built
    around."""
    return [ln.strip() for ln in log.splitlines()
            if "C7514" in ln or "C7512" in ln]


def ce_wgmma_ptxas(log):
    """{"fwd"|"dlogits": {"registers": n, "spill_bytes": n}} for the two
    instantiations of the wgmma chunked cross-entropy kernel."""
    return _ptxas(log, r"ce_wgmma_kernelILb([01])E",
                  lambda m: "dlogits" if m.group(1) == "1" else "fwd")


def ce_tf32_ptxas(log):
    """{"fwd"|"dlogits"|"split": {"registers": n, "spill_bytes": n}} for
    the kernels of ``chunked_ce_tf32.cu``: K3f and K3b
    (``ce_tf32_kernel<DLOGITS>``) and the split pass."""
    return _ptxas(
        log, r"ce_split_kernel|ce_tf32_kernelILb([01])E",
        lambda m: "split" if m.group(1) is None else
        "dlogits" if m.group(1) == "1" else "fwd")


CE_TF32_INSTANTIATIONS = ["dlogits", "fwd", "split"]


# every instantiation of the mma.sync / FMA flash kernels: the forward at
# each (dtype, tile width), the backward's dQ and dK/dV kernels at each, and
# its D pass at each dtype
SIMPLE_WIDTHS = (32, 64, 96, 128, 192, 256)
SIMPLE_INSTANTIATIONS = sorted(f"{t} w{w}" for t in ("f32", "bf16")
                               for w in SIMPLE_WIDTHS)
BWD_INSTANTIATIONS = sorted(
    [f"{k} {t} w{w}" for k in ("dq", "dkdv") for t in ("f32", "bf16")
     for w in SIMPLE_WIDTHS] + ["delta f32", "delta bf16"])
# since PR 17 each of them but the D pass also with the key mask, a
# template parameter: "f32 w64 masked", "dq bf16 w32 masked", ...
SIMPLE_MASKED_INSTANTIATIONS = [f"{k} masked" for k in SIMPLE_INSTANTIATIONS]
BWD_MASKED_INSTANTIATIONS = [f"{k} masked" for k in BWD_INSTANTIATIONS
                             if not k.startswith("delta")]


def _dtype_name(mangled):
    return "f32" if mangled == "f" else "bf16"


def _masked(flag):
    return " masked" if flag == "1" else ""


def simple_ptxas(log):
    """{"f32 w64": {"registers": n, "spill_bytes": n}, ...} for each
    instantiation of ``flash_attention_fwd.cu``'s kernel ("f32 w64
    masked" with the key mask)."""
    return _ptxas(log, r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                  r"(?:Lb([01])E)?",
                  lambda m: f"{_dtype_name(m.group(1))} w{m.group(2)}"
                  + _masked(m.group(3)))


def bwd_ptxas(log):
    """{"dq f32 w64": {...}, "delta bf16": {...}, ...} for each kernel of
    ``flash_attention_bwd.cu`` ("dq f32 w64 masked" with the key mask)."""
    return _ptxas(log, r"(dq|dkdv|delta)_kernelI(f|13__nv_bfloat16)"
                  r"(?:Li(\d+)E)?(?:Lb([01])E)?",
                  lambda m: f"{m.group(1)} {_dtype_name(m.group(2))}"
                  + (f" w{m.group(3)}" if m.group(3) else "")
                  + _masked(m.group(4)))


def bwd_wgmma_ptxas(log):
    """{"d64 dq": {"registers": n, "spill_bytes": n}, ...} for each
    instantiation of the wgmma backward: the dQ kernel and the dK/dV kernel
    at each head dim, unmasked and key-masked ("d64 dq masked", ...)."""
    return _ptxas(log, r"flash_bwd_wgmma_kernelILi(\d+)ELb([01])E"
                  r"(?:Lb([01])E)?",
                  lambda m: f"d{m.group(1)} "
                  + ("dkdv" if m.group(2) == "1" else "dq")
                  + (" masked" if m.group(3) == "1" else ""))


def kernel_phase(torch, fa):
    """Both flash kernels against their plain version at each case."""
    import torch.nn.functional as F
    # about a second of matmuls first, so the first case is not timed while
    # the card's clocks are still coming up
    x = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    end = time.perf_counter() + 1.0
    while time.perf_counter() < end:
        x @ x
        torch.cuda.synchronize()
    results = {}
    for case in KERNEL_CASES:
        layout, b, h, t_q, t_k, d, dtype, causal = case
        q, k, v, out, (q4, k4, v4) = case_inputs(torch, case)
        path = fa.kernel_for(q.dtype, d)
        fa.launches_wgmma = fa.launches_simple = 0
        o, lse = fa.flash_attention_fwd(q, k, v, causal, out=out)
        torch.cuda.synchronize()
        check((fa.launches_wgmma, fa.launches_simple)
              == ((1, 0) if path == "wgmma" else (0, 1)),
              f"{case}: launched ({fa.launches_wgmma}, "
              f"{fa.launches_simple}), want only the {path} kernel")
        check(out is None or o.data_ptr() == out.data_ptr(),
              f"{case}: o not written into the caller's view")
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err_o) and err_o <= TOL_O[dtype],
              f"flash_attention_fwd {case}: max |do| {err_o} > "
              f"{TOL_O[dtype]}")
        check(math.isfinite(err_lse) and err_lse <= TOL_LSE,
              f"flash_attention_fwd {case}: max |dlse| {err_lse} > "
              f"{TOL_LSE}")

        def kernel():
            fa.flash_attention_fwd(q, k, v, causal, out=out)

        def library():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

        ms = time_ms(kernel, torch)
        dev_ms = device_ms(kernel, torch)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal), torch,
            iters=5, repeats=5)
        library_ms = time_ms(library, torch)
        library_dev_ms = device_ms(library, torch)
        bound_ms, bound_by = attention_bound_ms(b * h, t_q, t_k, d, dtype,
                                                causal)
        row = {"path": path, "layout": layout, "b": b, "h": h, "t_q": t_q,
               "t_k": t_k, "d": d, "dtype": dtype, "causal": causal,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_device_ms": library_dev_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "device_vs_library": dev_ms / library_dev_ms,
               "device_vs_bound": dev_ms / bound_ms}
        if dtype == "float32":      # the bound at the f32 FMA rate beside
            row["bound_fma_ms"] = attention_bound_ms(
                b * h, t_q, t_k, d, dtype, causal, peaks=PEAK_FLOPS)[0]
        emit(kernel_case=row)
        results[case] = row
    return results


def bwd_case_inputs(torch, fa, case):
    """The forward's inputs and output (as :func:`case_inputs`, o and lse
    from the kernel), dO, three views that receive dq, dk, dv, and SDPA's
    4-D q, k, v and dO. "fused": dO is the (B, H, T, d) view of a (B, T,
    H·d) gradient and the views are the column blocks of (B, T, 3·H·d)
    gradient buffers, as ``fa.FlashAttention`` calls the wrapper."""
    layout, b, h, t_q, t_k, d, dtype, causal = case
    q, k, v, out, sdpa = case_inputs(torch, case)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out=out)
    g = torch.Generator(device="cuda").manual_seed(t_q * 7919 + t_k + d)
    if layout == "3d":
        do = torch.randn(q.shape, generator=g, device="cuda", dtype=q.dtype)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        return q, k, v, out, o, lse, do, grads, (*sdpa, do[None])
    c = h * d
    do = torch.randn((b, t_q, c), generator=g, device="cuda",
                     dtype=q.dtype).view(b, t_q, h, d).transpose(1, 2)
    gq = torch.empty((b, t_q, 3 * c), device="cuda", dtype=q.dtype)
    gk = gq if t_k == t_q else torch.empty((b, t_k, 3 * c), device="cuda",
                                           dtype=q.dtype)
    grads = tuple(x[..., i * c:(i + 1) * c].reshape(b, x.shape[1], h, d)
                  .transpose(1, 2) for i, x in enumerate((gq, gk, gk)))
    return q, k, v, out, o, lse, do, grads, (*sdpa, do)


def bwd_phase(torch, fa):
    """K2 against its plain version at each of BWD_CASES, timed as the
    forward is, plus the forward and backward together (K1 + K2) against
    SDPA's forward and backward on the same inputs, and SDPA's backward
    alone as the difference of its forward and backward and its forward
    (both device times of this call, the forward run as training runs it,
    on leaves that require grad)."""
    import torch.nn.functional as F
    results = {}
    for case in BWD_CASES:
        layout, b, h, t_q, t_k, d, dtype, causal = case
        (q, k, v, out, o, lse, do, grads,
         (q4, k4, v4, do4)) = bwd_case_inputs(torch, fa, case)
        path = ("bwd_wgmma" if fa.kernel_for(q.dtype, d) == "wgmma"
                else "bwd")
        fa.launches_bwd = fa.launches_bwd_wgmma = 0
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, out=grads)
        torch.cuda.synchronize()
        launched = (fa.launches_bwd_wgmma, fa.launches_bwd)
        check(launched == ((1, 0) if path == "bwd_wgmma" else (0, 1))
              and all(x is y for x, y in zip(got, grads)),
              f"bwd {case}: launched (wgmma, mma.sync) {launched}, want only "
              f"{path}, or did not write into the caller's views")
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        errs, tile_l2 = {}, {}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            err = (x.float() - r.float()).abs().max().item()
            limit = TOL_GRAD[dtype] * max(1.0, r.float().abs().max().item())
            check(math.isfinite(err) and err <= limit,
                  f"flash_attention_bwd {case}: max |d{name}| {err} > "
                  f"{limit}")
            errs[name] = err
            tile_l2[name] = tile_rel_l2(x, r, GRAD_RMS_FLOOR[dtype])
            check(tile_l2[name] <= TOL_GRAD_TILE_L2[dtype],
                  f"flash_attention_bwd {case}: a 64-row tile of {name} has "
                  f"relative L2 error {tile_l2[name]} > "
                  f"{TOL_GRAD_TILE_L2[dtype]}")
        del ref

        def kernel():
            fa.flash_attention_bwd(q, k, v, o, lse, do, causal, out=grads)

        def pair():
            o_, lse_ = fa.flash_attention_fwd(q, k, v, causal, out=out)
            fa.flash_attention_bwd(q, k, v, o_, lse_, do, causal, out=grads)

        def library():
            # fresh leaves each call, so autograd's accumulation nodes are
            # made on the stream being captured
            xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            y = F.scaled_dot_product_attention(*xs, is_causal=causal)
            torch.autograd.grad(y, xs, do4)

        def library_fwd():
            xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            F.scaled_dot_product_attention(*xs, is_causal=causal)

        bound_ms, bound_by = attention_bwd_bound_ms(b * h, t_q, t_k, d,
                                                    dtype, causal)
        row = {"path": path, "layout": layout, "b": b, "h": h, "t_q": t_q,
               "t_k": t_k, "d": d, "dtype": dtype, "causal": causal,
               "max_abs_err": errs, "max_tile_rel_l2": tile_l2,
               "ms": time_ms(kernel, torch),
               "device_ms": device_ms(kernel, torch),
               "plain_ms": time_ms(lambda: fa.flash_attention_bwd_reference(
                   q, k, v, o, lse, do, causal), torch, iters=3, repeats=3),
               "fwd_bwd_ms": time_ms(pair, torch),
               "fwd_bwd_device_ms": device_ms(pair, torch),
               "library_ms": time_ms(library, torch),
               "library_device_ms": device_ms(library, torch),
               "library_fwd_device_ms": device_ms(library_fwd, torch),
               "bound_ms": bound_ms, "bound_by": bound_by}
        # a difference of two device times, not a direct reading
        row["library_bwd_device_ms"] = (row["library_device_ms"]
                                        - row["library_fwd_device_ms"])
        row["device_vs_bound"] = row["device_ms"] / bound_ms
        if dtype == "float32":
            row["bound_fma_ms"] = attention_bwd_bound_ms(
                b * h, t_q, t_k, d, dtype, causal, peaks=PEAK_FLOPS)[0]
        row["device_vs_library_bwd"] = (row["device_ms"]
                                        / row["library_bwd_device_ms"])
        row["fwd_bwd_vs_library"] = (row["fwd_bwd_device_ms"]
                                     / row["library_device_ms"])
        emit(bwd_case=row)
        results[case] = row
    return results


def head_phase(torch):
    """The tied LM head of the training step (``_TiedHead``: bf16 x and e,
    f32 logits, bf16 dlogits in the backward) against autograd through the
    f32 product ``x.float() @ e.float().T`` on the same inputs: x (8, 1024,
    1024) at a LayerNorm's scale, e (32768, 1024) at the init's, and the
    cross-entropy gradient of random targets as dlogits. Also gives how far
    JAX's ``ce_chunks=0`` gradient arithmetic (f32 dlogits, f32 products,
    each gradient rounded to bf16) lies from the f32 one, beside the
    head's."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.models.transformer import _TiedHead
    resolve_device()            # TF32 off: the reference product is f32
    b, t, c, vocab = (TRAIN_BATCH, LARGE["max_len"], LARGE["d_model"],
                      LARGE["vocab_size"])
    n = b * t
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((b, t, c), generator=g, device="cuda").bfloat16()
    e = (0.02 * torch.randn((vocab, c), generator=g, device="cuda")
         ).bfloat16()
    xr, er = (a.float().requires_grad_() for a in (x, e))
    logits_ref = torch.matmul(xr, er.T)
    targets = torch.randint(0, vocab, (n,), generator=g, device="cuda")
    with torch.no_grad():
        dlogits = torch.softmax(logits_ref, -1)
        dlogits.view(n, vocab)[torch.arange(n, device="cuda"),
                               targets] -= 1.0
        dlogits /= n
    dx_ref, de_ref = torch.autograd.grad(logits_ref, (xr, er), dlogits)
    xk, ek = (a.detach().requires_grad_() for a in (x, e))
    logits = _TiedHead.apply(xk, ek)
    dx, de = torch.autograd.grad(logits, (xk, ek), dlogits)
    torch.cuda.synchronize()
    check(logits.dtype == torch.float32 and dx.dtype == de.dtype
          == torch.bfloat16, f"head dtypes {logits.dtype} {dx.dtype} "
          f"{de.dtype}")

    def rel(got, want):
        return ((got.float() - want).norm() / want.norm()).item()

    check(logits.shape == (b, t, vocab), f"head logits {logits.shape}")
    row = {"logits": rel(logits, logits_ref.detach()), "dx": rel(dx, dx_ref),
           "de": rel(de, de_ref)}
    row["jax_ce_chunks0_arithmetic"] = {
        "dx": rel(dx_ref.bfloat16(), dx_ref), "de": rel(de_ref.bfloat16(),
                                                        de_ref)}
    row["head_vs_jax_arithmetic"] = {"dx": rel(dx, dx_ref.bfloat16().float()),
                                     "de": rel(de, de_ref.bfloat16().float())}
    emit(head={"batch": b, "seq_len": t, "d_model": c, "vocab": vocab,
               "rel_l2": row, "tolerance": TOL_HEAD})
    for name, limit in TOL_HEAD.items():
        check(math.isfinite(row[name]) and row[name] <= limit,
              f"tied head: relative L2 error of {name} {row[name]} > {limit}")


def counts(fa):
    """Launches of each flash kernel, in the order of KERNELS: (wgmma
    forward, simple forward, wgmma backward, mma.sync backward)."""
    return (fa.launches_wgmma, fa.launches_simple, fa.launches_bwd_wgmma,
            fa.launches_bwd)


def reset_counts(fa):
    fa.launches_wgmma = fa.launches_simple = 0
    fa.launches_bwd_wgmma = fa.launches_bwd = 0


def all_counts():
    """Launches of every kernel of the port, in the order of ALL_KERNELS."""
    from deeplearning4j_tpu_torch.kernels import launch_counts
    named = launch_counts()
    return tuple(named[k] for k in ALL_KERNELS)


def reset_all_counts():
    from deeplearning4j_tpu_torch.kernels import reset_launch_counts
    reset_launch_counts()


def launch_counts(**named):
    """A launch tuple in ALL_KERNELS' order: the ``named`` kernels' counts,
    0 for every other kernel."""
    unknown = set(named) - set(ALL_KERNELS)
    if unknown:
        raise ValueError(f"no such kernels: {sorted(unknown)}")
    return tuple(named.get(k, 0) for k in ALL_KERNELS)


def delta(before):
    """Each kernel's launches since ``before`` (an ``all_counts()``)."""
    return tuple(a - b for a, b in zip(all_counts(), before))


def ce_fwd_bound_ms(n, v, d, dtype, peaks=None):
    """K3f's least time: 2·N·V·d FLOPs of the logits over the peak of the
    type (``ATTN_PEAK_FLOPS``: f32 as three TF32 products at a third of the
    TF32 rate, or ``peaks``), against x and E read once, targets read and
    lse written once."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(2.0 * n * v * d, item * (n + v) * d + 8 * n + 4 * n + 4,
                  dtype, peaks or ATTN_PEAK_FLOPS)


def ce_dlogits_bound_ms(n, c, d, dtype, peaks=None):
    """One K3b launch's least time: 2·N·C·d FLOPs (over the peak as in
    :func:`ce_fwd_bound_ms`) against x, the chunk of E, targets and lse
    read once and the (N, C) dlogits written once."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(2.0 * n * c * d,
                  item * (n + c) * d + 12 * n + item * n * c, dtype,
                  peaks or ATTN_PEAK_FLOPS)


def ce_split_bound_ms(n, v, d):
    """The split pass's least time: x (N, d) and E (V, d) in f32 read
    once and their two TF32 parts, rows of d rounded up to 32, written
    once, over the memory rate (no arithmetic to speak of)."""
    dp = -(-d // 32) * 32
    return _bound(0.0, 4 * (n + v) * (d + 2 * dp), "float32")


def moe_bound_ms(rows_read, rows_written, d, dtype, index_bytes):
    """A K7 launch's least time: the rows it must read and write, each
    once, and its index maps, over the memory rate (no arithmetic to
    speak of)."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(0.0, item * d * (rows_read + rows_written) + index_bytes,
                  dtype)


def dlogits_errors(got, ref, t_local, scale):
    """(relative L2 error off the targets, max |Δ| at the targets over
    ``scale``) of one chunk's dlogits; ``t_local`` holds each row's target
    column in the chunk, or −1. Held apart because the target entries
    (≈ −g/N) would hide a wrong softmax (≈ g/(N·V) each) in any norm over
    all entries."""
    import torch
    got, ref = got.float(), ref.float()
    on = torch.zeros_like(ref, dtype=torch.bool)
    rows = torch.nonzero(t_local >= 0)[:, 0]
    on[rows, t_local[rows]] = True
    off_ref = torch.where(on, 0.0, ref)
    off_err = torch.where(on, 0.0, got - ref)
    rel = (off_err.norm() / off_ref.norm().clamp_min(1e-30)).item()
    at = ((got - ref)[on].abs().max().item() / scale) if bool(on.any()) \
        else 0.0
    return rel, at


def ce_inputs(torch, case):
    """x (N, d), E (V, d) at the init's scale and targets for one of
    CE_CASES, the first three targets on vocab 0, the first chunk's edge
    and V − 1."""
    n, v, d, dtype, chunks = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(n * 7 + v + d)
    x = torch.randn((n, d), generator=g, device="cuda").to(dt)
    e = (0.02 * torch.randn((v, d), generator=g, device="cuda")).to(dt)
    t = torch.randint(0, v, (n,), generator=g, device="cuda")
    c = v // chunks
    t[: min(n, 3)] = torch.tensor([0, c, v - 1], device="cuda")[: min(n, 3)]
    return x, e, t


def ce_checked(torch, ce, case, x, e, t, lse_ref, cor, kernel=None):
    """Run K3f and the first chunk's K3b once through their wrappers (the
    kernel ``kernel`` names, or the one the wrappers choose), check that
    exactly that kernel launched and hold both against their plain
    versions. Returns (path, max |Δlse|, |Δloss|, max |Δdlogits|, relative
    L2 off the targets, max |Δ| at the targets over g/N)."""
    n, v, d, dtype, chunks = case
    path = kernel or ce.kernel_for("cuda", x.dtype, d, True)
    suffix = {"wgmma": "_wgmma", "tf32": "_tf32", "mma_sync": ""}[path]
    reset_all_counts()
    lse, loss = ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)
    torch.cuda.synchronize()
    want = [0] * len(ALL_KERNELS)
    want[ALL_KERNELS.index("ce_fwd" + suffix)] = 1
    if path == "tf32":              # the operands' split pass first
        want[ALL_KERNELS.index("ce_split_tf32")] = 1
    check(all_counts() == tuple(want), f"K3f {case} ({path}): launched "
          f"{all_counts()} {ALL_KERNELS}")
    err_lse = (lse - lse_ref).abs().max().item()
    err_loss = abs(loss.item() - (lse_ref - cor).mean().item())
    check(err_lse <= TOL_CE_LSE and err_loss <= TOL_CE_LSE,
          f"K3f {case} ({path}): max |dlse| {err_lse}, |dloss| {err_loss} > "
          f"{TOL_CE_LSE}")
    c = v // chunks
    gr = torch.ones((), device="cuda")
    dlog = ce.ce_dlogits(x, e[:c], t, lse_ref, 0, gr, n, kernel=kernel)
    ref = ce.ce_dlogits_reference(x, e[:c], t, lse_ref, 0, gr, n)
    torch.cuda.synchronize()
    check(all_counts()[ALL_KERNELS.index("ce_dlogits" + suffix)] == 1,
          f"K3b {case} ({path}): did not launch")
    local = torch.where(t < c, t, -1)
    rel, at = dlogits_errors(dlog, ref, local, 1.0 / n)
    check(rel <= TOL_CE_DLOG_L2[dtype] and at <= TOL_CE_DLOG_TARGET[dtype],
          f"K3b {case} ({path}): relative L2 off the targets {rel}, at the "
          f"targets {at} of g/N")
    err_dlog = (dlog.float() - ref.float()).abs().max().item()
    return path, err_lse, err_loss, err_dlog, rel, at


def ce_phase(torch):
    """K3f and K3b against their plain versions at each of CE_CASES (the
    wgmma kernels on the bf16 cases, the tf32 kernels and their split pass
    on the f32 ones), timed as the flash kernels are. K3f's library time is
    the unchunked path it replaces, two calls: the tied head's product into
    f32 logits (``_TiedHead``, or the f32 product with TF32 off) and
    logsumexp minus the gathered target logit; K3b's is that path's
    backward (the f32 dlogits, then the head's backward), as the
    difference of its forward + backward and its forward. K3b itself is
    timed per launch (one ce chunk, on parts split beforehand where the
    kernel is tf32, as the backward does) and as the whole chunked backward
    (the split, every chunk's K3b and its two products). At the two
    training shapes (CE_TURN_CASES) chunked_ce.cu's kernels also run on the
    same operands, held to the plain versions too, and both designs'
    device times are taken in turns (mma.sync, new, new, mma.sync). The
    split pass is held to its plain version bit for bit and timed at the
    f32 cases."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.models.transformer import _TiedHead
    # the yardstick's f32 products are f32 (the port's TF32 policy)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for case in CE_CASES:
        n, v, d, dtype, chunks = case
        dt = getattr(torch, dtype)
        x, e, t = ce_inputs(torch, case)
        c = v // chunks
        e0 = e[:c]
        gr = torch.ones((), device="cuda")
        lse_ref, cor = ce.chunked_ce_fwd_reference(x, e, t, chunks)
        path, err_lse, err_loss, err_dlog, rel, at = ce_checked(
            torch, ce, case, x, e, t, lse_ref, cor)
        tf32 = path == "tf32"
        parts = ce.split_tf32(x, e) if tf32 else None
        parts0 = parts[:2] + tuple(p[:c] for p in parts[2:]) if tf32 \
            else None

        def head_fwd(xs, es):
            if dt == torch.bfloat16:
                logits = _TiedHead.apply(xs, es)
            else:
                logits = xs @ es.T
            return (torch.logsumexp(logits, -1)
                    - logits.gather(-1, t[:, None])[:, 0]).mean()

        def library_fwd():
            xs, es = (a.detach().requires_grad_() for a in (x, e))
            head_fwd(xs, es)

        def library():
            xs, es = (a.detach().requires_grad_() for a in (x, e))
            torch.autograd.grad(head_fwd(xs, es), (xs, es))

        def fwd(kernel=None):
            ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)

        def dlogits(kernel=None):
            ce.ce_dlogits(x, e0, t, lse_ref, 0, gr, n, kernel=kernel,
                          parts=parts0 if kernel is None else None)

        def backward():
            ce.chunked_ce_bwd(x, e, t, lse_ref, gr, chunks)

        big = n * v >= 2 ** 26
        row = {"path": path, "n": n, "v": v, "d": d, "dtype": dtype,
               "ce_chunks": chunks,
               "max_abs_err_lse": err_lse, "abs_err_loss": err_loss,
               "max_abs_err_dlogits": err_dlog,
               "dlogits_rel_l2_off_target": rel,
               "dlogits_err_at_target_over_scale": at,
               "fwd_ms": time_ms(fwd, torch),
               "fwd_device_ms": device_ms(fwd, torch),
               "fwd_plain_ms": time_ms(
                   lambda: ce.chunked_ce_fwd_reference(x, e, t, chunks),
                   torch, iters=3, repeats=3),
               "dlogits_ms": time_ms(dlogits, torch),
               "dlogits_device_ms": device_ms(dlogits, torch),
               "dlogits_plain_ms": time_ms(
                   lambda: ce.ce_dlogits_reference(x, e0, t, lse_ref, 0, gr,
                                                   n), torch, iters=3,
                   repeats=3),
               "backward_ms": time_ms(backward, torch, iters=5, repeats=5),
               "backward_device_ms": device_ms(backward, torch, launches=5,
                                               repeats=5),
               "library": ("_TiedHead (torch.mm out_dtype=f32)"
                           if dt == torch.bfloat16 else
                           "f32 product (TF32 off)")
               + " + logsumexp - gather; its backward",
               "library_ms": time_ms(library_fwd, torch, iters=5,
                                     repeats=5),
               "library_device_ms": device_ms(library_fwd, torch,
                                              launches=5, repeats=5),
               "library_fwd_bwd_device_ms": device_ms(
                   library, torch, launches=2 if big else 5, repeats=5)}
        row["library_bwd_device_ms"] = (row["library_fwd_bwd_device_ms"]
                                        - row["library_device_ms"])
        row["library_bwd_ms"] = (time_ms(library, torch, iters=5, repeats=5)
                                 - row["library_ms"])
        row["fwd_bound_ms"], row["fwd_bound_by"] = ce_fwd_bound_ms(
            n, v, d, dtype)
        row["dlogits_bound_ms"], row["dlogits_bound_by"] = \
            ce_dlogits_bound_ms(n, c, d, dtype)
        if dtype == "float32":      # the bounds at the f32 FMA rate beside
            row["fwd_bound_fma_ms"] = ce_fwd_bound_ms(n, v, d, dtype,
                                                      PEAK_FLOPS)[0]
            row["dlogits_bound_fma_ms"] = ce_dlogits_bound_ms(
                n, c, d, dtype, PEAK_FLOPS)[0]
        row["fwd_device_vs_bound"] = row["fwd_device_ms"] / row[
            "fwd_bound_ms"]
        row["backward_device_vs_bound"] = row["backward_device_ms"] / (
            chunks * row["dlogits_bound_ms"])
        if tf32:
            want = ce.split_tf32_reference(x) + ce.split_tf32_reference(e)
            exact = all(torch.equal(a.view(torch.int32),
                                    b.view(torch.int32))
                        for a, b in zip(parts, want))
            check(exact, f"split pass {case}: not its plain version's bits")
            del want
            row["split"] = {
                "exact": exact, "ms": time_ms(lambda: ce.split_tf32(x, e),
                                              torch),
                "device_ms": device_ms(lambda: ce.split_tf32(x, e), torch),
                "plain_ms": time_ms(
                    lambda: (ce.split_tf32_reference(x),
                             ce.split_tf32_reference(e)), torch, iters=3,
                    repeats=3)}
            row["split"]["bound_ms"], row["split"]["bound_by"] = \
                ce_split_bound_ms(n, v, d)
        if case in CE_TURN_CASES:
            # chunked_ce.cu's kernels on the same operands: held to the
            # plain versions, then both designs timed in turns
            _p, *errs = ce_checked(torch, ce, case, x, e, t, lse_ref, cor,
                                   kernel="mma_sync")
            old = dict(zip(
                ("max_abs_err_lse", "abs_err_loss", "max_abs_err_dlogits",
                 "dlogits_rel_l2_off_target",
                 "dlogits_err_at_target_over_scale"), errs))
            old["fwd_ms"] = time_ms(lambda: fwd("mma_sync"), torch)
            old["dlogits_ms"] = time_ms(lambda: dlogits("mma_sync"), torch)
            turns = {"fwd": {"mma_sync": [], path: []},
                     "dlogits": {"mma_sync": [], path: []}}
            for kernel in ("mma_sync", path, path, "mma_sync"):
                for what, fn in (("fwd", fwd), ("dlogits", dlogits)):
                    turns[what][kernel].append(device_ms(
                        lambda: fn(None if kernel == path else kernel),
                        torch))
            for what in ("fwd", "dlogits"):
                old[f"{what}_device_ms"] = statistics.median(
                    turns[what]["mma_sync"])
            row["mma_sync"] = old
            row["turns_device_ms"] = turns
        emit(ce_case=row)
        results[case] = row
        del parts, parts0
        torch.cuda.empty_cache()
    return results


def moe_route_inputs(torch, case):
    """Routing of random router probabilities for one of MOE_CASES, and
    x, out_e and dy rows: (gates, slot, src, x, out_e, dy)."""
    from deeplearning4j_tpu_torch.parallel import moe as tmoe
    G, E, C, K, d, dtype = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(G * 31 + E * 7 + C + d)
    probs = torch.softmax(torch.randn((G, E), generator=g, device="cuda"), -1)
    cfg = tmoe.MoEConfig(d_model=d, d_ff=d, num_experts=E, top_k=K)
    _c, gates, slot, src, _oh = tmoe.route(probs, cfg, C)
    x, dy = (torch.randn((G, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    out_e = torch.randn((E * C, d), generator=g, device="cuda").to(dt)
    return gates.to(dt).contiguous(), slot, src, x, out_e, dy


def moe_phase(torch):
    """K7d (dispatch, and with gates combine's backward) and K7c (combine,
    and with unit gates dispatch's backward) against their plain versions
    at each of MOE_CASES, timed as the flash kernels are. The library times
    are index_copy_ into zeroed buffers (dispatch) and index_add_ of the
    weighted rows (combine)."""
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    results = {}
    for case in MOE_CASES:
        G, E, C, K, d, dtype = case
        gates, slot, src, x, out_e, dy = moe_route_inputs(torch, case)
        mr.launches_dispatch = mr.launches_combine = 0
        ei = mr.moe_dispatch(x, src, K)
        y = mr.moe_combine(out_e, slot, gates)
        dx = mr.moe_combine(ei, slot)
        d_out, d_gates = mr.moe_dispatch_grad(dy, src, K, gates, out_e)
        torch.cuda.synchronize()
        check((mr.launches_dispatch, mr.launches_combine) == (2, 2),
              f"K7 {case}: launched {(mr.launches_dispatch, mr.launches_combine)}")
        check(torch.equal(ei, mr.dispatch_reference(x, src, K)),
              f"K7d {case}: dispatch differs from its plain version")
        ref_out, ref_gates = mr.dispatch_grad_reference(dy, src, K, gates,
                                                        out_e)
        check(torch.equal(d_out, ref_out),
              f"K7d {case}: combine's backward rows differ")
        errs = {}
        for name, got, ref, tol in (
                ("combine", y, mr.combine_reference(out_e, slot, gates),
                 TOL_MOE_COMBINE[dtype]),
                ("dispatch_grad", dx, mr.combine_reference(ei, slot),
                 TOL_MOE_COMBINE[dtype]),
                ("d_gate", d_gates, ref_gates, TOL_MOE_DGATE[dtype])):
            top = max(ref.float().abs().max().item(), 1e-30)
            errs[name] = (got.float() - ref.float()).abs().max().item()
            check(errs[name] <= tol * top, f"K7 {case} {name}: max |Δ| "
                  f"{errs[name]} > {tol} × {top}")
        kept_choice = slot >= 0
        n_kept = int(kept_choice.sum())
        kept_slot = src >= 0
        slot_idx = torch.nonzero(kept_slot)[:, 0]
        tok_idx = (src[kept_slot] // K).long()
        flat = torch.nonzero(kept_choice.reshape(-1))[:, 0]
        add_tok = flat // K
        add_slot = slot.reshape(-1)[flat].long()
        add_w = gates.reshape(-1)[flat].float()[:, None]

        def dispatch():
            mr.moe_dispatch(x, src, K)

        def combine():
            mr.moe_combine(out_e, slot, gates)

        def library_dispatch():
            torch.zeros_like(out_e).index_copy_(0, slot_idx,
                                                x.index_select(0, tok_idx))

        def library_combine():
            torch.zeros((G, d), device="cuda").index_add_(
                0, add_tok, out_e.index_select(0, add_slot).float() * add_w)

        row = {"g": G, "e": E, "c": C, "top_k": K, "d": d, "dtype": dtype,
               "kept_choices": n_kept, "max_abs_err": errs,
               "dispatch_ms": time_ms(dispatch, torch),
               "dispatch_device_ms": device_ms(dispatch, torch),
               "dispatch_plain_ms": time_ms(
                   lambda: mr.dispatch_reference(x, src, K), torch, iters=5,
                   repeats=5),
               "dispatch_library_ms": time_ms(library_dispatch, torch),
               "dispatch_library_device_ms": device_ms(library_dispatch,
                                                       torch),
               "combine_ms": time_ms(combine, torch),
               "combine_device_ms": device_ms(combine, torch),
               "combine_plain_ms": time_ms(
                   lambda: mr.combine_reference(out_e, slot, gates), torch,
                   iters=5, repeats=5),
               "combine_library_ms": time_ms(library_combine, torch),
               "combine_library_device_ms": device_ms(library_combine,
                                                      torch),
               "library": "zeros + index_copy_ of index_select (dispatch); "
                          "zeros + index_add_ of weighted index_select "
                          "(combine)"}
        row["dispatch_bound_ms"], row["dispatch_bound_by"] = moe_bound_ms(
            n_kept, E * C, d, dtype, 4 * E * C)
        row["combine_bound_ms"], row["combine_bound_by"] = moe_bound_ms(
            n_kept, G, d, dtype, G * K * (4 + (2 if dtype == "bfloat16"
                                               else 4)))
        emit(moe_case=row)
        results[case] = row
    return results


@contextlib.contextmanager
def plain_kernels(fa, moe_only=False):
    """The plain versions in place of every kernel of the port (flash
    attention forward and backward, K3f, K3b and the split pass, K7d and
    K7c), or of K7's
    alone with ``moe_only``, each looked up at call time by its caller: a
    reference run of the same model on the card."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    saved = [(mr, "moe_dispatch", mr.moe_dispatch),
             (mr, "moe_combine", mr.moe_combine),
             (mr, "moe_dispatch_grad", mr.moe_dispatch_grad)]
    mr.moe_dispatch = mr.dispatch_reference
    mr.moe_combine = mr.combine_reference
    mr.moe_dispatch_grad = mr.dispatch_grad_reference
    if not moe_only:
        saved += [(ce, "chunked_ce_fwd", ce.chunked_ce_fwd),
                  (ce, "ce_dlogits", ce.ce_dlogits),
                  (ce, "split_tf32", ce.split_tf32)]

        def ce_fwd(x2, emb, targets, n_chunks):
            lse, correct = ce.chunked_ce_fwd_reference(x2, emb, targets,
                                                       n_chunks)
            return lse, (lse - correct).mean()

        def ce_dlogits(*args, parts=None, **kw):
            return ce.ce_dlogits_reference(*args, **kw)

        # no split pass: the backward then hands K3b no parts
        ce.chunked_ce_fwd, ce.ce_dlogits = ce_fwd, ce_dlogits
        ce.split_tf32 = lambda x2, emb: None
    try:
        with (contextlib.nullcontext() if moe_only
              else plain_attention(fa)):
            yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def leaf_paths(tree, prefix=""):
    """Names of a param tree's leaves in ``tree_leaves`` order (dict keys
    sorted, list items by index)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def expected_per_step(n_layers, remat, ce_chunks, moe=False, f32=False):
    """Launches of each kernel (ALL_KERNELS' order) in one training step of
    the large config: in bf16 the wgmma forward once per layer (twice
    under remat: the recompute), the wgmma backward once per layer, the
    wgmma K3f once and K3b once per ce chunk when ce_chunks (chunked_ce.cu's
    never: d 1024 is a multiple of 64); in f32 (``f32``) the simple forward
    and the mma.sync / FMA backward in their places, and the tf32 K3f once,
    K3b once per ce chunk and the split pass twice (once for the forward,
    once before the backward's chunks; chunked_ce.cu's K3 never); for a MoE
    model K7d and K7c twice per layer (the forward's dispatch and combine,
    and each one's backward in the other kernel; three times under remat);
    K4a, K4w and K4a+w (decode only) never."""
    L = n_layers
    k7 = (3 if remat else 2) * L if moe else 0
    fwd, k3f = (2 if remat else 1) * L, 1 if ce_chunks else 0
    if f32:
        return launch_counts(simple=fwd, bwd=L, moe_dispatch=k7,
                             moe_combine=k7, ce_fwd_tf32=k3f,
                             ce_dlogits_tf32=ce_chunks,
                             ce_split_tf32=2 if ce_chunks else 0)
    return launch_counts(wgmma=fwd, bwd_wgmma=L, moe_dispatch=k7,
                         moe_combine=k7, ce_fwd_wgmma=k3f,
                         ce_dlogits_wgmma=ce_chunks)


def slice_phase(torch, fa):
    """Full-width generation through the port's entry points. Returns the
    engine, the model and each kernel's launches in the run."""
    from deeplearning4j_tpu_torch.models.generation import (DecodeEngine,
                                                            SamplerConfig)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    from deeplearning4j_tpu_torch.tree import tree_leaves

    cfg = TransformerConfig(**LARGE)
    t0 = time.perf_counter()
    params = from_jax_params(init_jax_layout(cfg, SEED), cfg)
    model = TransformerLM(cfg)
    engine = DecodeEngine(model, params, max_len=1024)
    check(engine.paged and engine.page_tokens == 64,
          f"engine is not in its default paged mode ({engine.page_tokens})")
    engine.warm(1)
    torch.cuda.synchronize()
    emit(setup={"params": sum(p.numel() for p in tree_leaves(params)),
                "seconds": time.perf_counter() - t0,
                "page_tokens": engine.page_tokens})
    L, V = cfg.n_layers, cfg.vocab_size
    # the wgmma forward once per layer of a prefill or apply, K4a+w once
    # per layer of each decode step (bf16 pages: K4w never), nothing else
    per_forward = launch_counts(wgmma=L)
    per_generate = launch_counts(wgmma=L,
                                 paged_attention_write=(N_NEW - 1) * L)
    rng = np.random.default_rng(SEED + 1)

    def launched(fn):
        before = all_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, delta(before), 1e3 * (time.perf_counter() - t)

    def tokens_ok(toks, shape):
        check(toks.shape == shape, f"tokens shape {toks.shape} != {shape}")
        check(bool(((toks >= 0) & (toks < V)).all()), "token out of range")

    reset_all_counts()
    # the main path starts here
    for n in PROMPT_LENS:
        prompt = rng.integers(0, V, (1, n)).astype(np.int32)
        bucket = engine.prefill_bucket(n)
        (toks, steps), got, _ms = launched(
            lambda: engine.generate(prompt, N_NEW, return_logits=True))
        check(got == per_generate, f"prompt {n}: launched {got}, want "
              f"{per_generate} {ALL_KERNELS}")
        tokens_ok(toks, (1, N_NEW))
        pre = []
        for _ in range(3):
            _out, got, ms = launched(lambda: engine.prefill(prompt))
            check(got == per_forward, f"prefill {n}: launched {got}")
            pre.append(ms)
        toks2, got, gen_ms = launched(lambda: engine.generate(prompt, N_NEW))
        check(got == per_generate and np.array_equal(toks2, toks),
              f"prompt {n}: greedy rerun differs or launched {got}")
        # teacher forcing: the full forward (kernel path) over prompt +
        # generated tokens against each step's logits (prefill, then the
        # paged decode through K4a)
        full = np.concatenate([prompt, toks[:, :-1]], axis=1)
        ref, got, _ms = launched(lambda: model.apply(
            engine.params, torch.as_tensor(full, device=model.device)))
        check(got == per_forward, f"apply {n}: launched {got}")
        ref = ref[0, n - 1:].cpu().numpy()
        dec = np.concatenate(steps, axis=0)
        check(np.isfinite(dec).all() and np.isfinite(ref).all(),
              "non-finite logits")
        diff = float(np.abs(dec - ref).max())
        check(diff <= TOL_TEACHER_FORCED,
              f"prompt {n}: decode logits differ from apply by {diff}")
        prefill_ms = statistics.median(pre)
        emit(request={"prompt_len": n, "bucket": bucket,
                      "prefill_ms": prefill_ms, "generate_ms": gen_ms,
                      "decode_ms_per_token": (gen_ms - prefill_ms)
                      / (N_NEW - 1),
                      "teacher_forced_max_abs_diff": diff,
                      "argmax_agree": float(np.mean(
                          dec.argmax(-1) == ref.argmax(-1)))})

    batch = rng.integers(0, V, (4, 100)).astype(np.int32)
    toks, got, ms = launched(lambda: engine.generate(batch, N_NEW))
    check(got == per_generate, f"batch: launched {got}")
    tokens_ok(toks, (4, N_NEW))
    emit(batch={"batch": 4, "prompt_len": 100, "generate_ms": ms})

    topk = DecodeEngine(model, engine.params, max_len=1024, seed=7,
                        sampler=SamplerConfig("topk", top_k=40,
                                              temperature=0.8))
    prompt = rng.integers(0, V, (1, 300)).astype(np.int32)
    runs = []
    for _ in range(2):
        toks, got, ms = launched(lambda: topk.generate(prompt, N_NEW))
        check(got == per_generate, f"top-k: launched {got}")
        tokens_ok(toks, (1, N_NEW))
        runs.append(toks)
    check(np.array_equal(runs[0], runs[1]), "top-k runs differ")
    emit(topk={"top_k": 40, "temperature": 0.8, "seed": 7,
               "identical": True, "generate_ms": ms})
    return engine, model, all_counts()


def k4_inputs(torch, case):
    """q as the (B, W, H, hd) view of a fused projection (strided, as the
    model hands it over), pools of B·n_lp pages + trash (int8 from
    quantized random rows with their scales, or q's dtype), each slot's
    pages a random permutation (the trash slots' rows all trash), and
    window positions ending at each slot's context − 1."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 131 + W * 17 + hd + P)
    n_pages = B * n_lp + 1
    proj = torch.randn((B, W, 3 * H * hd), generator=g, device="cuda")
    q = proj.to(dt)[..., :H * hd].view(B, W, H, hd)
    rows = torch.randn((2, n_pages, P, H, hd), generator=g, device="cuda")
    if pool == "int8":
        k8, ks = pa.quantize_kv_rows_reference(rows[0])
        v8, vs = pa.quantize_kv_rows_reference(rows[1])
        pools = (k8, v8, ks, vs)
    else:
        rows = rows.to(dt)
        pools = (rows[0].contiguous(), rows[1].contiguous(), None, None)
    perm = torch.randperm(B * n_lp, generator=g, device="cuda")
    tables = perm.view(B, n_lp).to(torch.int32)
    for b in trash:
        tables[b] = n_pages - 1
    pos = (torch.tensor(ctx, device="cuda")[:, None] - W
           + torch.arange(W, device="cuda")[None, :]).clamp_min(0)
    return q, pools, tables, pos.to(torch.int32)


def k4a_bound_ms(case, pos):
    """K4a's least time on this run's positions: the keys each slot needs
    (positions up to its largest query's, capped at S), k and v rows read
    once (with their f32 scales for int8 pages), their page-table entries,
    q and the positions read and o written once; against 4·hd operations
    per (query, needed key, head) in f32, the kernel's arithmetic (scalar
    FMAs: the f32 peak)."""
    return _bound(*k4a_bound_parts(case, pos), "float32")


def k4a_bound_parts(case, pos):
    """(operations, bytes) of :func:`k4a_bound_ms`."""
    B, W, H, hd, P, n_lp, dtype, pool, _ctx, _trash = case
    S = P * n_lp
    item = 2 if dtype == "bfloat16" else 4
    kv_item = 1 if pool == "int8" else item
    pos = pos.cpu().numpy().astype(np.int64)
    keys = np.minimum(pos.max(axis=1) + 1, S)
    nbytes = (int(keys.sum()) * (2 * H * hd * kv_item
                                 + (8 if pool == "int8" else 0))
              + 4 * int(np.ceil(keys / P).sum()) + 4 * B * W
              + 2 * B * W * H * hd * item)
    flops = 4.0 * H * hd * float(np.minimum(pos + 1, S).sum())
    return flops, nbytes


def k4w_bound_ms(n_valid, n_rows, layers, c, dtype):
    """K4w's least time: the k and v rows read once, their int8 rows and
    f32 scales written once, and the (page, row) coordinates read (no
    arithmetic to speak of)."""
    item = 2 if dtype == "bfloat16" else 4
    return _bound(0.0, layers * (2 * n_valid * c * item + 2 * n_rows * c
                                 + 8 * n_rows) + 8 * n_rows, dtype)


def k4aw_inputs(torch, case):
    """K4a's inputs for one of DECODE_CASES (a P = S case as the dense
    cache: B pages of S tokens, no trash page), with q and the window's k
    and v rows as strided views of one projection, and each row's flat
    pool row ``dst``: through the table, past S to the trash page (paged)
    or dropped (-1, dense). Returns (q, k, v, pools, tables, pos, dst,
    dense)."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
    _q, pools, tables, pos = k4_inputs(torch, case)
    dense = n_lp == 1 and not trash and pool != "int8"
    C, S = H * hd, P * n_lp
    g = torch.Generator(device="cuda").manual_seed(B * 29 + W + hd + P)
    proj = torch.randn((B, W, 3 * C), generator=g, device="cuda").to(
        getattr(torch, dtype))
    q, k, v = (proj[..., i * C:(i + 1) * C].view(B, W, H, hd)
               for i in range(3))
    pos64 = pos.long()
    if dense:
        tables = pa.dense_tables(B, "cuda")
        pools = (pools[0][:B].contiguous(), pools[1][:B].contiguous(),
                 None, None)
        dst = torch.where(pos64 < S, torch.arange(
            B, device="cuda")[:, None] * S + pos64, -1)
    else:
        lp = (pos64 // P).clamp(max=n_lp - 1)
        page = torch.where(pos64 < S, tables.long().gather(1, lp),
                           pools[0].shape[0] - 1)
        dst = page * P + pos64 % P
    return q, k, v, pools, tables, pos, dst.to(torch.int32), dense


def two_launch_store(torch, k, v, pools, dst):
    """The store K4a+w folds in, as the decode path ran it before: K4w on
    int8 pools, else one ``index_put_`` of the rows into each pool (the
    kept rows gathered first where some are dropped; integer indices made
    here, once: CUDA-graph safe). Returns a function of no arguments doing
    it in place."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    kp, vp, ks, vs = pools
    if ks is not None:
        P = kp.shape[1]
        phys, off = dst // P, dst % P
        return lambda: pa.kv_quant_write(k, v, phys, off, kp, vp, ks, vs)
    flat_k = kp.view(-1, *kp.shape[2:])
    flat_v = vp.view(-1, *vp.shape[2:])
    if bool((dst >= 0).all()):
        at = dst.long()

        def store():
            flat_k[at] = k
            flat_v[at] = v
        return store
    bi, wi = torch.nonzero(dst >= 0, as_tuple=True)
    at = dst.long()[bi, wi]

    def store_kept():
        flat_k[at] = k[bi, wi]
        flat_v[at] = v[bi, wi]
    return store_kept


def k4aw_bound_ms(case, pos, dst):
    """K4a+w's least time: K4a's (:func:`k4a_bound_ms`) plus the window's k
    and v rows read once from the projection, the stored rows written once
    (int8 rows with their f32 scales) and their pool rows ``dst`` read."""
    B, W, H, hd, P, n_lp, dtype, pool, _ctx, _trash = case
    item = 2 if dtype == "bfloat16" else 4
    kv_item = 1 if pool == "int8" else item
    stored = int((dst >= 0).sum().item())
    flops, nbytes = k4a_bound_parts(case, pos)
    nbytes += (2 * B * W * H * hd * item + 4 * B * W
               + 2 * stored * (H * hd * kv_item + (4 if pool == "int8"
                                                   else 0)))
    return _bound(flops, nbytes, "float32")


def quant_inputs(torch, case):
    """Rows for one of QUANT_CASES (strided views of a fused projection for
    a window, a prefill's (L, 1, T, H, hd) k/v for an insert) with an
    all-zero row, their (page, row) coordinates, and zeroed int8 pools and
    scales of the large config's heads."""
    B, W, layers, P, dtype = case
    H, hd = LARGE["n_heads"], LARGE["d_model"] // LARGE["n_heads"]
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 7 + W + layers + P)
    if layers == 1:
        proj = torch.randn((B, W, 3 * H * hd), generator=g, device="cuda")
        proj[0, W - 1] = 0.0
        proj = proj.to(dt)
        k = proj[..., H * hd:2 * H * hd].view(B, W, H, hd)
        v = proj[..., 2 * H * hd:].view(B, W, H, hd)
        n_pages = -(-B * W // P) + 2
        flat = torch.randperm((n_pages - 1) * P, generator=g,
                              device="cuda")[:B * W].view(B, W)
        phys, off = (flat // P).to(torch.int32), (flat % P).to(torch.int32)
        phys[-1, -1], off[-1, -1] = n_pages - 1, 0          # the trash
        lead = ()
    else:
        kv = torch.randn((2, layers, 1, W, H, hd), generator=g,
                         device="cuda")
        kv[:, :, :, 0] = 0.0
        kv = kv.to(dt)
        k, v = kv[0], kv[1]
        npb = -(-W // P)
        n_pages = npb + 1
        ids = torch.randperm(npb, generator=g, device="cuda")
        t = torch.arange(npb * P, device="cuda")
        phys, off = ids[t // P][None].to(torch.int32), (t % P)[None].to(
            torch.int32)
        lead = (layers,)

    def pools():
        return [torch.zeros((*lead, n_pages, P, H, hd), dtype=torch.int8,
                            device="cuda") for _ in range(2)] + [
            torch.zeros((*lead, n_pages, P), device="cuda")
            for _ in range(2)]

    return k, v, phys, off, pools


def decode_kernel_phase(torch):
    """K4a against its plain version (the gather of each slot's pages and
    the reference attention) at each of DECODE_CASES, and K4w against its
    plain version (bit-exact) at each of QUANT_CASES, timed as the other
    kernels are: ``device_ms`` from CUDA-graph replays, ``ms`` with the
    host, the plain version, and for K4a the library call, the gather
    (dequantized for int8 pages) plus SDPA with a boolean mask."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    results = {}
    for case in DECODE_CASES:
        B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
        q, (k, v, ks, vs), tables, pos = k4_inputs(torch, case)
        pa.launches_attend = 0
        o = pa.paged_attention(q, k, v, tables, pos, ks, vs)
        torch.cuda.synchronize()
        check(pa.launches_attend == 1, f"K4a {case}: launched "
              f"{pa.launches_attend}")
        ref = pa.paged_attention_reference(q, k, v, tables, pos, ks, vs)
        err = (o.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= TOL_O[dtype],
              f"paged_attention {case}: max |do| {err} > {TOL_O[dtype]}")
        S = P * n_lp
        mask = (torch.arange(S, device="cuda")[None, None, None, :]
                <= pos.long()[:, None, :, None])

        def kernel():
            return pa.paged_attention(q, k, v, tables, pos, ks, vs)

        exact = exactness(o, kernel(), graph_outputs(kernel, torch))
        check(exact["deterministic"] and exact["replay_exact"],
              f"paged_attention {case}: not the same bits run to run "
              f"{exact}")

        def library():
            kk = pa.gather_pages(k, ks, tables, q.dtype).transpose(1, 2)
            vv = pa.gather_pages(v, vs, tables, q.dtype).transpose(1, 2)
            F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                           attn_mask=mask)

        bound_ms, bound_by = k4a_bound_ms(case, pos)
        row = {"b": B, "w": W, "h": H, "hd": hd, "page_tokens": P,
               "pages_a_slot": n_lp, "dtype": dtype, "pool": pool,
               "contexts": list(ctx), "trash_slots": list(trash),
               "splits": pa.attend_splits(q, k, v, tables)[0],
               "max_abs_err": err,
               "ms": time_ms(kernel, torch),
               "device_ms": device_ms(kernel, torch),
               "plain_ms": time_ms(lambda: pa.paged_attention_reference(
                   q, k, v, tables, pos, ks, vs), torch, iters=5, repeats=5),
               "library_ms": time_ms(library, torch),
               "library_device_ms": device_ms(library, torch),
               "bound_ms": bound_ms, "bound_by": bound_by, **exact}
        row["device_vs_bound"] = row["device_ms"] / bound_ms
        row["device_vs_library"] = (row["device_ms"]
                                    / row["library_device_ms"])
        emit(decode_case=row)
        results[case] = row
    for case, candidates in SPLIT_SWEEP.items():
        emit(decode_split_sweep=split_sweep(torch, case, candidates))
    slower = {str(c): r["device_vs_library"] for c, r in results.items()
              if c[2:4] == (16, 64) and r["device_vs_library"] > 1.0}
    check(not slower, f"K4a slower than the gather + SDPA at H 16, hd 64: "
          f"{slower}")
    for case in FUSED_CASES:
        results[("fused",) + case] = fused_decode_case(torch, case)
    for case in QUANT_CASES:
        B, W, layers, P, dtype = case
        k, v, phys, off, pools = quant_inputs(torch, case)
        got, want = pools(), pools()
        pa.launches_quant_write = 0
        pa.kv_quant_write(k, v, phys, off, *got)
        pa.kv_quant_write_reference(k, v, phys, off, *want)
        torch.cuda.synchronize()
        check(pa.launches_quant_write == 1, f"K4w {case}: launched "
              f"{pa.launches_quant_write}")
        for name, a, b in zip(("k", "v", "k_scale", "v_scale"), got, want):
            check(torch.equal(a, b), f"kv_quant_write {case}: {name} "
                  f"differs from its plain version")
        zero_scale = got[2][..., int(phys[0, W - 1]), int(off[0, W - 1])] \
            if layers == 1 else got[2][:, int(phys[0, 0]), int(off[0, 0])]
        check(bool((zero_scale == 1.0).all()), f"kv_quant_write {case}: "
              f"the all-zero row's scale is not 1")
        n_rows = phys.numel()
        n_valid = B * W
        C = LARGE["d_model"]

        def kernel():
            pa.kv_quant_write(k, v, phys, off, *got)

        bound_ms, bound_by = k4w_bound_ms(n_valid, n_rows, layers, C, dtype)
        row = {"b": B, "w": W, "layers": layers, "page_tokens": P,
               "dtype": dtype, "rows": n_rows, "max_abs_err": 0.0,
               "ms": time_ms(kernel, torch),
               "device_ms": device_ms(kernel, torch),
               "plain_ms": time_ms(lambda: pa.kv_quant_write_reference(
                   k, v, phys, off, *want), torch, iters=5, repeats=5),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by}
        row["device_vs_bound"] = row["device_ms"] / bound_ms
        emit(quant_write_case=row)
        results[("quant",) + case] = row
    return results


def fused_decode_case(torch, case):
    """K4a+w at one of FUSED_CASES: o of the live slots the same bits as
    the two-launch path's (the store's own launch, then K4a) and within
    TOL_O of the plain version's (the scatter, the gather and the
    reference attention); the pools and scales the same bytes as both,
    the trash page aside (free slots and rows past S write it in no fixed
    order); the same bits on a second call and across CUDA-graph replays.
    Times it (``device_ms`` from graph replays, ``ms`` with the host), the
    two-launch path in turns with it (fused, two, two, fused) at
    FUSED_TURN_CASES, and the plain version."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, trash = case
    q, k, v, pools, tables, pos, dst, dense = k4aw_inputs(torch, case)

    def clones():
        return tuple(None if x is None else x.clone() for x in pools)

    fused, two, plain = clones(), clones(), clones()
    reset_all_counts()
    o = pa.paged_attention_write(q, k, v, fused[0], fused[1], tables, pos,
                                 dst, fused[2], fused[3])
    torch.cuda.synchronize()
    check(all_counts() == launch_counts(paged_attention_write=1),
          f"K4a+w {case}: launched {all_counts()}")
    store = two_launch_store(torch, k, v, two, dst)

    def two_launches():
        store()
        return pa.paged_attention(q, two[0], two[1], tables, pos, two[2],
                                  two[3])

    o2 = two_launches()
    ref = pa.paged_attention_write_reference(q, k, v, *plain[:2], tables,
                                             pos, dst, *plain[2:])
    torch.cuda.synchronize()
    live = [b for b in range(B) if b not in trash]
    err = (o[live].float() - ref[live].float()).abs().max().item()
    check(math.isfinite(err) and err <= TOL_O[dtype],
          f"paged_attention_write {case}: max |do| {err} > {TOL_O[dtype]}")
    check(torch.equal(o[live], o2[live]), f"paged_attention_write {case}: "
          f"o differs from the two-launch path's")
    keep = slice(None) if dense else slice(0, -1)
    for name, a, b, c in zip(("k", "v", "k_scale", "v_scale"), fused, two,
                             plain):
        if a is not None:
            check(torch.equal(a[keep], b[keep])
                  and torch.equal(a[keep], c[keep]),
                  f"paged_attention_write {case}: the {name} pool differs "
                  f"from the two-launch path's or the plain version's")

    def kernel():
        return pa.paged_attention_write(q, k, v, fused[0], fused[1], tables,
                                        pos, dst, fused[2], fused[3])

    exact = exactness(o, kernel(), graph_outputs(kernel, torch))
    check(exact["deterministic"] and exact["replay_exact"],
          f"paged_attention_write {case}: not the same bits run to run "
          f"{exact}")
    bound_ms, bound_by = k4aw_bound_ms(case, pos, dst)
    row = {"b": B, "w": W, "h": H, "hd": hd, "page_tokens": P,
           "pages_a_slot": n_lp, "dtype": dtype,
           "pool": "dense" if dense else pool, "contexts": list(ctx),
           "trash_slots": list(trash),
           "splits": pa.attend_splits(q, fused[0], fused[1], tables)[0],
           "max_abs_err": err, "two_launch_exact": True,
           "ms": time_ms(kernel, torch),
           "two_launch_ms": time_ms(two_launches, torch),
           "plain_ms": time_ms(lambda: pa.paged_attention_write_reference(
               q, k, v, *plain[:2], tables, pos, dst, *plain[2:]), torch,
               iters=5, repeats=5),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           **exact}
    if case in FUSED_TURN_CASES:
        # the two-launch path's store is PyTorch's index_put_ on pages of
        # q's dtype: captured in the graph as the kernels are
        turns = [(label, device_ms(fn, torch)) for label, fn in (
            ("fused", kernel), ("two", two_launches), ("two", two_launches),
            ("fused", kernel))]
        row["device_ms_turns"] = turns
        row["device_ms"] = statistics.mean(t for lb, t in turns
                                           if lb == "fused")
        row["two_launch_device_ms"] = statistics.mean(
            t for lb, t in turns if lb == "two")
        row["fused_vs_two_launch"] = (row["device_ms"]
                                      / row["two_launch_device_ms"])
    else:
        row["device_ms"] = device_ms(kernel, torch)
    row["device_vs_bound"] = row["device_ms"] / bound_ms
    emit(fused_decode_case=row)
    return row


def split_sweep(torch, case, candidates):
    """K4a's device time at each split count of ``candidates`` and at
    key_splits' own, on one of DECODE_CASES, each held to the plain
    version (:func:`split_sweep_row` gives the line)."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, W, H, hd, P, n_lp, dtype, pool, ctx, _trash = case
    q, (k, v, ks, vs), tables, pos = k4_inputs(torch, case)
    ref = pa.paged_attention_reference(q, k, v, tables, pos, ks, vs)
    rule = pa.attend_splits(q, k, v, tables)[0]
    points = []
    for asked in sorted(set(candidates) | {rule}):
        splits, per = pa.attend_splits(q, k, v, tables, asked)

        def kernel():
            return pa.paged_attention(q, k, v, tables, pos, ks, vs,
                                      splits=asked)

        err = (kernel().float() - ref.float()).abs().max().item()
        check(err <= TOL_O[dtype], f"paged_attention {case} at {asked} "
              f"splits: max |do| {err} > {TOL_O[dtype]}")
        points.append({"splits": splits, "keys_per_split": per,
                       "blocks": splits * H * B, "max_abs_err": err,
                       "device_ms": device_ms(kernel, torch)})
    return split_sweep_row(case, rule, points)


def split_sweep_row(case, rule, points):
    """The ``decode_split_sweep`` line of one case: its shape, key_splits'
    choice (``rule_splits``), the fastest point and the rule's time over
    it, and every point (splits, keys a split, blocks, max |do|, device
    ms)."""
    B, W, H, hd, P, n_lp, dtype, pool, ctx, _trash = case
    best = min(points, key=lambda r: r["device_ms"])
    at_rule = [r["device_ms"] for r in points if r["splits"] == rule]
    return {"b": B, "w": W, "h": H, "hd": hd, "page_tokens": P,
            "pages_a_slot": n_lp, "dtype": dtype, "pool": pool,
            "contexts": list(ctx), "rule_splits": rule,
            "best_splits": best["splits"],
            "rule_vs_best": (at_rule[0] / best["device_ms"] if at_rule
                             else None),
            "points": points}


def near_tie_step(steps):
    """The first step whose plain-decode logits (1, V) have a top-2 gap of
    at most TOL_TEACHER_FORCED, or None: another matmul shape may round
    such a step's argmax either way under bf16."""
    for i, row in enumerate(steps):
        top = np.sort(np.asarray(row, np.float64)[0])[-2:]
        if top[1] - top[0] <= TOL_TEACHER_FORCED:
            return i
    return None


def flip_gap(torch, model, params, prompt, want, got, at):
    """Where two greedy streams of one prompt first differ (token ``at``):
    the gap between their two tokens' logits there, teacher-forced by
    ``apply`` over the prompt and ``want``'s tokens before it. At most
    TOL_TEACHER_FORCED is a near tie, which another rounding of the cache
    rows may flip."""
    full = np.concatenate([prompt, want[:at]])[None]
    with torch.inference_mode():
        row = model.apply(params, torch.as_tensor(full, device=model.device))
    logits = row[0, -1].float().cpu().numpy()
    return {"at": at, "want": int(want[at]), "got": int(got[at]),
            "gap": float(abs(logits[want[at]] - logits[got[at]]))}


def serve_phase(torch, model, engine):
    """The three serving modes at full width against the default engine
    (bf16 pages, plain decode): (a) int8 pages with plain decode, (b) bf16
    pages with speculative decoding by a DRAFT_LAYERS-layer truncation of
    the target (its embeddings shared) with a dense cache, spec_k SPEC_K,
    (c) both. Greedy, PROMPT_LENS, N_NEW tokens. Checks the gate's record
    (the pool is int8 if and only if it passed), the tokens against plain
    decode's up to its first near-tie step, (a)'s teacher-forced logits
    against ``apply``, and every kernel's launches; times prefill and ms per
    emitted token; and runs an int8 pool through ``decode_window_paged``
    whatever the gate decides. Returns each kernel's launches in the
    phase."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    cfg = model.config
    L, V, P = cfg.n_layers, cfg.vocab_size, engine.page_tokens
    params = engine.params
    dmodel = TransformerLM(TransformerConfig(**dict(LARGE,
                                                    n_layers=DRAFT_LAYERS)))
    dparams = {"tok_emb": params["tok_emb"], "pos_emb": params["pos_emb"],
               "ln_f": params["ln_f"],
               "blocks": params["blocks"][:DRAFT_LAYERS]}
    rng = np.random.default_rng(SEED + 6)
    prompts = {n: rng.integers(0, V, (1, n)).astype(np.int32)
               for n in PROMPT_LENS}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    def prefill_ms(eng, prompt):
        return statistics.median(timed(lambda: eng.prefill(prompt))[1]
                                 for _ in range(3))

    reset_all_counts()                   # the main path starts here
    draft = DecodeEngine(dmodel, dparams, max_len=cfg.max_len, page_tokens=0)
    base = {}
    for n, prompt in prompts.items():
        (toks, steps) = engine.generate(prompt, N_NEW, return_logits=True)
        _t, ms = timed(lambda: engine.generate(prompt, N_NEW))
        pre = prefill_ms(engine, prompt)
        base[n] = {"tokens": toks, "near_tie": near_tie_step(steps),
                   "prefill_ms": pre, "generate_ms": ms,
                   "ms_per_token": (ms - pre) / (N_NEW - 1)}
        emit(serve_base={"prompt_len": n, "pool": "bfloat16",
                         "near_tie_step": base[n]["near_tie"],
                         **{k: base[n][k] for k in ("prefill_ms",
                                                    "generate_ms",
                                                    "ms_per_token")}})
    modes = {"int8": dict(kv_quant=True),
             "spec": dict(draft=draft, spec_k=SPEC_K),
             "int8_spec": dict(kv_quant=True, draft=draft, spec_k=SPEC_K)}
    rows = {}
    for mode, kw in modes.items():
        eng = DecodeEngine(model, params, max_len=cfg.max_len, **kw)
        state = eng.new_state(1)
        gate = eng.quant_gate
        int8 = state.arrays["k"].dtype == torch.int8
        if "kv_quant" in kw:
            check(gate is not None and gate["checked"]
                  and int8 == bool(gate["passed"]) == eng.kv_quant,
                  f"{mode}: pool int8 {int8} but gate {gate}")
        else:
            check(gate is None and not int8, f"{mode}: gate {gate}")
        emit(quant_gate={"mode": mode, "record": gate, "int8_pool": int8})
        eng.warm(1)
        spec = eng.spec
        check(spec == ("draft" in kw), f"{mode}: spec {spec}")
        per = []
        for n, prompt in prompts.items():
            before, rounds0 = all_counts(), eng.spec_stats["rounds"]
            stats0 = dict(eng.spec_stats)
            toks, gen_ms = timed(lambda: eng.generate(prompt, N_NEW))
            got = delta(before)
            rounds = eng.spec_stats["rounds"] - rounds0
            steps = rounds if spec else N_NEW - 1
            # K4a+w a layer a step (the draft's dense steps too); K4w once,
            # the prefill's insert into int8 pages, and never on decode
            want = launch_counts(
                wgmma=L + (DRAFT_LAYERS if spec else 0),
                kv_quant_write=1 if int8 else 0,
                paged_attention_write=steps * (
                    L + (SPEC_K * DRAFT_LAYERS if spec else 0)))
            check(got == want, f"{mode} prompt {n}: launched {got}, want "
                  f"{want} {ALL_KERNELS}")
            check(toks.shape == (1, N_NEW) and bool(((toks >= 0)
                                                     & (toks < V)).all()),
                  f"{mode} prompt {n}: tokens {toks.shape}")
            tie = base[n]["near_tie"]
            upto = N_NEW if tie is None else tie
            check(np.array_equal(toks[:, :upto], base[n]["tokens"][:, :upto]),
                  f"{mode} prompt {n}: tokens differ from plain decode "
                  f"before step {upto} (its first near tie: {tie})")
            pre = prefill_ms(eng, prompt)
            dpre = prefill_ms(draft, prompt) if spec else 0.0
            row = {"mode": mode, "prompt_len": n, "int8_pool": int8,
                   "prefill_ms": pre, "draft_prefill_ms": dpre,
                   "generate_ms": gen_ms,
                   "ms_per_token": (gen_ms - pre - dpre) / (N_NEW - 1),
                   "plain_bf16_ms_per_token": base[n]["ms_per_token"],
                   "tokens_equal_plain": bool(np.array_equal(
                       toks, base[n]["tokens"])),
                   "plain_near_tie_step": tie,
                   "launches": dict(zip(ALL_KERNELS, got))}
            if spec:
                acc = eng.spec_stats["accepted"] - stats0["accepted"]
                prop = eng.spec_stats["proposed"] - stats0["proposed"]
                row.update(rounds=rounds, accept_ratio=acc / prop,
                           tokens_per_round=(N_NEW - 1) / rounds)
            else:
                (_t, steps_l) = eng.generate(prompt, N_NEW,
                                             return_logits=True)
                full = np.concatenate([prompt, toks[:, :-1]], axis=1)
                ref = model.apply(params, torch.as_tensor(
                    full, device=model.device))[0, n - 1:].cpu().numpy()
                dec = np.concatenate(steps_l, axis=0)
                diff = float(np.abs(dec - ref).max())
                check(np.isfinite(dec).all() and diff <= TOL_TEACHER_FORCED,
                      f"{mode} prompt {n}: decode logits differ from apply "
                      f"by {diff}")
                row["teacher_forced_max_abs_diff"] = diff
            emit(serve_mode=row)
            per.append(row)
        if spec:
            emit(spec_accept={"mode": mode,
                              "accept_ratio": eng.spec_accept_ratio(),
                              "stats": eng.spec_stats})
        rows[mode] = per
        _f, _l, kv, _t = eng.prefill(prompts[PROMPT_LENS[0]])
        st = eng.insert_slot(eng.new_state(1), kv, 0)
        bst = engine.insert_slot(engine.new_state(1), kv, 0)
        emit(resident_cache={"mode": mode, "prompt_len": PROMPT_LENS[0],
                             "bytes": eng.resident_cache_bytes(st),
                             "bf16_bytes": engine.resident_cache_bytes(bst),
                             "ratio": eng.resident_cache_bytes(st)
                             / engine.resident_cache_bytes(bst),
                             "page_bytes": eng.page_bytes()})
        del eng, state, st, bst
    # an int8 pool through decode_window_paged at full width, whatever the
    # gate decided: the prompt's rows written by K4w, a W = SPEC_K + 1
    # window (K4a+w), against the same window over bf16 pages
    n = PROMPT_LENS[0]
    _f, _l, kv, t = engine.prefill(prompts[n])
    npb = -(-kv["k"].shape[2] // P)
    n_lp = engine.pages_per_slot
    pools = {"int8": model.init_paged_cache(n_lp + 1, P, quant=True),
             "bf16": model.init_paged_cache(n_lp + 1, P)}
    tables = torch.full((1, n_lp), n_lp, dtype=torch.int32,
                        device=model.device)
    tables[0, :npb] = torch.arange(npb, device=model.device)
    pages = list(range(npb))
    for pool in pools.values():
        engine._write_pages(pool, kv, pages)
    win = torch.as_tensor(prompts[n][:, :SPEC_K + 1], device=model.device)
    pos = torch.tensor([t], device=model.device)
    before = all_counts()
    lq, _ = model.decode_window_paged(params, pools["int8"], tables, win,
                                      pos, P)
    torch.cuda.synchronize()
    got = delta(before)
    lb, _ = model.decode_window_paged(params, pools["bf16"], tables, win,
                                      pos, P)
    finite = bool(torch.isfinite(lq).all())
    check(got == launch_counts(paged_attention_write=L) and finite,
          f"int8 window: launched {got}, finite logits {finite}")
    emit(int8_window={"prompt_len": n, "w": SPEC_K + 1,
                      "max_abs_logit_diff_vs_bf16_pages":
                      (lq - lb).abs().max().item(),
                      "launches": dict(zip(ALL_KERNELS, got))})
    launches = all_counts()              # ... and ends here
    del pools, kv, lq, lb, draft, dmodel
    torch.cuda.empty_cache()
    return launches


PIPE_SLOTS = 4
PIPE_STAGGER_S = 0.030     # client starts spread over 0-30 ms
PIPE_FAULT_AT = 10         # the chaos point fires after request 0's 11th token
PIPE_SHED_PROMPT = 490     # bucket 512: 8 pages at admission, a 9th at 512
PIPE_PROFILE_STEPS = 4


class StepGate:
    """Holds a pipeline's decode thread at step boundaries. Inside the
    ``with`` block ``engine.decode`` is wrapped so that the thread waits at
    the start of each step until it is let through; :meth:`held` waits
    until it is held, and :meth:`run` lets ``steps`` whole steps through
    and returns once the thread is held at the start of the next, so a
    window around :meth:`run` holds those steps (their host work between
    decode calls too) and nothing else. Leaving the block releases it."""

    def __init__(self, engine, steps, timeout=120.0):
        self.engine, self.steps, self.timeout = engine, steps, timeout
        self._cv = threading.Condition()
        self._entered = 0          # decode calls begun inside the block
        self._allowed = 0          # decode calls let through

    def __enter__(self):
        real = type(self.engine).decode

        def decode(*args, **kwargs):
            with self._cv:
                self._entered += 1
                n = self._entered
                self._cv.notify_all()
                released = self._cv.wait_for(lambda: self._allowed >= n,
                                             self.timeout)
            if not released:
                raise RuntimeError("step gate: step never let through")
            return real(self.engine, *args, **kwargs)

        self.engine.decode = decode
        return self

    def __exit__(self, *exc):
        del self.engine.decode
        with self._cv:
            self._allowed = float("inf")
            self._cv.notify_all()

    def _held_now(self):
        return self._entered > self._allowed

    def held(self) -> bool:
        with self._cv:
            return self._cv.wait_for(self._held_now, self.timeout)

    def run(self):
        with self._cv:
            self._allowed += self.steps
            self._cv.notify_all()
            ok = self._cv.wait_for(self._held_now, self.timeout)
        check(ok, f"step gate: {self.steps} steps never ended")


def pipeline_phase(torch, model, engine):
    """The port's ``GenerationPipeline`` on the large-config engine: 8
    client threads (two prompts at each of PROMPT_LENS, starts staggered
    over 0-30 ms, greedy, N_NEW tokens each) into PIPE_SLOTS slots, on bf16
    pages with plain decode (fault-free, then with one ``generation.step``
    crash mid-run, then a profiled window of 4 steps at 4 active slots) and
    on int8 pages with speculative decoding (the DRAFT_LAYERS-layer draft,
    spec_k SPEC_K); then a pool of half the slots' pages, which must shed
    typed and admit again. Checks each request's tokens against its run's
    engine decoding the prompt alone (up to that run's first near tie),
    the fault drill's tokens against the fault-free run's (exact, but for
    a flip at a near tie: the survivors' emitted rows are re-prefilled
    through the prefill's matmul shapes, see :func:`flip_gap`), every
    page returned, no new step signature and no memory growth after
    warm-up, and each kernel's launches. Returns the launches of the
    pipeline runs."""
    from deeplearning4j_tpu_torch.models.generation import (
        DECODE_FN, PREFILL_FN, PROPOSE_FN, VERIFY_FN, DecodeEngine)
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.observability import (compile_watch,
                                                        cost_model)
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationPipeline, _GenMetrics)
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.policy import CachePagesExhausted
    cfg = model.config
    V, params = cfg.vocab_size, engine.params
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, V, (n,)).astype(np.int32)
               for _ in range(2) for n in PROMPT_LENS]
    dmodel = TransformerLM(TransformerConfig(**dict(LARGE,
                                                    n_layers=DRAFT_LAYERS)))
    draft = DecodeEngine(dmodel, {"tok_emb": params["tok_emb"],
                                  "pos_emb": params["pos_emb"],
                                  "ln_f": params["ln_f"],
                                  "blocks": params["blocks"][:DRAFT_LAYERS]},
                         max_len=cfg.max_len, page_tokens=0)
    int8 = DecodeEngine(model, params, max_len=cfg.max_len, kv_quant=True)
    spec = DecodeEngine(model, params, max_len=cfg.max_len, kv_quant=True,
                        draft=draft, spec_k=SPEC_K)
    watch = compile_watch.global_compile_watch()
    obs = _GenMetrics.get()

    def solo(eng):
        """Each prompt alone through ``eng``'s own greedy decode: tokens
        and the first step whose top-2 logit gap is at most
        TOL_TEACHER_FORCED."""
        out = []
        for p in prompts:
            toks, steps = eng.generate(p[None], N_NEW, return_logits=True)
            out.append((toks[0], near_tie_step(steps)))
        return out

    refs = {"bf16": solo(engine), "int8_spec": solo(int8)}
    check(int8.kv_quant and spec.new_state(1).arrays["k"].dtype
          == torch.int8, f"int8 gate: {int8.quant_gate} {spec.quant_gate}")

    def counters():
        return {fn: watch.count_for(fn)
                for fn in (PREFILL_FN, DECODE_FN, VERIFY_FN, PROPOSE_FN)}

    def warm(eng, gp):
        eng.warm(PIPE_SLOTS)
        gp.generate(prompts[3], max_new_tokens=4)   # the pool's first use
        torch.cuda.synchronize()
        return counters(), torch.cuda.memory_allocated()

    def drive(gp, label, idx, fault_at=None, stagger=PIPE_STAGGER_S):
        """One client thread a prompt; starts spread over ``stagger``
        seconds. Returns each request's tokens (or exception), time to
        first token and latency (ms), the run's wall seconds and its
        per-step books."""
        n = len(idx)
        res, ttft, lat = [None] * n, [None] * n, [None] * n
        plan = faults.FaultPlan([faults.FaultSpec(
            "generation.step", "crash", rate=1.0, count=1)])

        def client(j, t_go):
            def on_token(tok, k):
                if k == 0:
                    ttft[j] = 1e3 * (time.perf_counter() - t_go)
                if fault_at is not None and j == 0 and k == fault_at:
                    faults.install(plan)
            try:
                res[j] = gp.generate(prompts[idx[j]], max_new_tokens=N_NEW,
                                     on_token=on_token)
            except Exception as e:        # checked by the caller
                res[j] = e
            lat[j] = 1e3 * (time.perf_counter() - t_go)

        before, steps0 = all_counts(), (obs.step_latency.count,
                                        obs.step_latency.sum,
                                        obs.occupancy.sum)
        t0 = time.perf_counter()
        threads = []
        for j in range(n):
            go = t0 + stagger * j / max(1, n - 1)
            time.sleep(max(0.0, go - time.perf_counter()))
            th = threading.Thread(target=client,
                                  args=(j, time.perf_counter()))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=300)
        check(not any(th.is_alive() for th in threads),
              f"pipeline {label}: a request hung")
        wall = time.perf_counter() - t0
        faults.clear()
        torch.cuda.synchronize()
        st = gp._cache
        check(st.alloc.free_count == st.alloc.total,
              f"pipeline {label}: {st.alloc.in_use} pages still in use")
        steps = obs.step_latency.count - steps0[0]
        return {"results": res, "ttft_ms": ttft, "latency_ms": lat,
                "wall_s": wall, "launches": delta(before), "steps": steps,
                "host_ms_per_step": 1e3 * (obs.step_latency.sum - steps0[1])
                / max(1, steps),
                "mean_active_slots": PIPE_SLOTS * (obs.occupancy.sum
                                                   - steps0[2])
                / max(1, steps)}

    def tokens_ok(label, run, idx, ref):
        for j, i in enumerate(idx):
            got = run["results"][j]
            check(isinstance(got, np.ndarray) and got.shape == (N_NEW,),
                  f"pipeline {label} request {j} (prompt "
                  f"{prompts[i].size}): {got!r}")
            want, tie = ref[i]
            upto = N_NEW if tie is None else tie
            check(np.array_equal(got[:upto], want[:upto]),
                  f"pipeline {label} request {j}: tokens differ from the "
                  f"prompt alone before step {upto} (its first near tie: "
                  f"{tie})")

    def record(label, run, idx, gp):
        toks = sum(len(r) for r in run["results"]
                   if isinstance(r, np.ndarray))
        per_tok = [(lat - tt) / (N_NEW - 1) for lat, tt, r in zip(
            run["latency_ms"], run["ttft_ms"], run["results"])
            if isinstance(r, np.ndarray)]
        ttft = {}
        for j, i in enumerate(idx):
            ttft.setdefault(int(prompts[i].size), []).append(
                run["ttft_ms"][j])
        emit(pipeline_run={
            "run": label, "requests": len(idx), "slots": PIPE_SLOTS,
            "tokens": toks, "wall_s": run["wall_s"],
            "tokens_per_s": toks / run["wall_s"],
            "ms_per_emitted_token": statistics.mean(per_tok),
            "ttft_ms_by_prompt_len": ttft, "steps": run["steps"],
            "host_ms_per_step": run["host_ms_per_step"],
            "mean_active_slots": run["mean_active_slots"],
            "launches": dict(zip(ALL_KERNELS, run["launches"])),
            "spec_accept_ratio": gp.engine.spec_accept_ratio()})

    everyone = list(range(len(prompts)))
    launches = [0] * len(ALL_KERNELS)

    def add(run):
        for k, n in enumerate(run["launches"]):
            launches[k] += n

    # ---- bf16 pages, plain decode: fault-free, fault drill, profile
    gp = GenerationPipeline(engine, slots=PIPE_SLOTS, max_new_tokens=N_NEW)
    try:
        sig0, mem0 = warm(engine, gp)
        reset_all_counts()               # the main path starts here
        base = drive(gp, "bf16", everyone)
        tokens_ok("bf16", base, everyone, refs["bf16"])
        record("bf16", base, everyone, gp)
        check(base["launches"][ALL_KERNELS.index("kv_quant_write")] == 0,
              f"bf16 pipeline launched K4w: {base['launches']}")
        add(base)
        single = drive(gp, "bf16_one_request", [0])
        tokens_ok("bf16_one_request", single, [0], refs["bf16"])
        record("bf16_one_request", single, [0], gp)
        add(single)
        injected0 = faults.snapshot()["injected"].get(
            "generation.step:crash", 0)
        restore = {}
        replace = gp._replace_survivors

        def timed_replace(survivors, error):
            t = time.perf_counter()
            replace(survivors, error)
            torch.cuda.synchronize()
            restore.update(
                ms=1e3 * (time.perf_counter() - t),
                survivors=len(survivors),
                emitted_tokens=[len(req.out) for _slot, req in survivors],
                prompt_tokens=[int(req.x.size) for _slot, req in survivors])

        gp._replace_survivors = timed_replace
        drill = drive(gp, "bf16_fault", everyone, fault_at=PIPE_FAULT_AT)
        del gp._replace_survivors
        add(drill)
        fired = faults.snapshot()["injected"].get(
            "generation.step:crash", 0) - injected0
        check(fired == 1, f"fault drill: {fired} crashes fired, want 1")
        flips = {}
        for j in everyone:
            got, want = drill["results"][j], base["results"][j]
            check(isinstance(got, np.ndarray) and got.shape == want.shape,
                  f"fault drill request {j}: {got!r}")
            at = np.flatnonzero(got != want)
            if at.size:
                flips[j] = flip_gap(torch, model, params, prompts[j], want,
                                    got, int(at[0]))
        emit(pipeline_fault_restore={
            **restore, "ms_per_emitted_token": restore.get("ms", 0.0)
            / max(1, sum(restore.get("emitted_tokens", []))),
            "exact_requests": len(everyone) - len(flips),
            "flips": flips, "tolerance": TOL_TEACHER_FORCED})
        check(restore.get("survivors", 0) > 0,
              f"fault drill: no session restored {restore}")
        for j, flip in flips.items():
            check(flip["gap"] <= TOL_TEACHER_FORCED,
                  f"fault drill request {j}: differs from the fault-free "
                  f"run at token {flip['at']}, where its two tokens' "
                  f"logits are {flip['gap']} apart (not a near tie)")
        record("bf16_fault", drill, everyone, gp)
        # a profiler window of PIPE_PROFILE_STEPS whole steps with every
        # slot decoding: it starts and ends with the decode thread held at
        # a step's start
        prof_box = {}

        def longest():
            prof_box["run"] = drive(gp, "bf16_profile", [0, 1, 2, 3],
                                    stagger=0.0)

        th = threading.Thread(target=longest)
        th.start()
        deadline = time.monotonic() + 120
        while ((gp._n_active() < PIPE_SLOTS or gp._waiting is not None
                or gp._queue.qsize()) and time.monotonic() < deadline):
            time.sleep(0.0005)
        check(gp._n_active() == PIPE_SLOTS, "profile: slots never filled")
        with StepGate(engine, PIPE_PROFILE_STEPS) as gate:
            check(gate.held(), "profile: no step began")
            step0 = gp._step
            row = profile_window(torch, "pipeline", gate.run,
                                 "pipeline_decode_trace.json", top=12)
            steps = gp._step - step0
            full = gp._n_active() == PIPE_SLOTS
        check(steps == PIPE_PROFILE_STEPS and full,
              f"profile: {steps} steps in the window, slots full {full}")
        th.join(timeout=300)
        check(not th.is_alive(), "profile run hung")
        add(prof_box["run"])
        n = PIPE_PROFILE_STEPS
        emit(pipeline_profile={
            "steps": n, "slots": PIPE_SLOTS,
            "kernels_per_step": row.get("kernels", 0) / n,
            "device_busy_us_per_step": row.get("device_busy_us", 0.0) / n,
            "window_ms_per_step": row.get("window_us", 0.0) / 1e3 / n,
            **row})
        emit(pipeline_snapshot=gp.snapshot())
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check(counters() == sig0, f"bf16 pipeline: new step signatures "
              f"after warm-up {sig0} -> {counters()}")
        check(abs(mem1 - mem0) <= 0.01 * mem0,
              f"bf16 pipeline: memory_allocated {mem0} -> {mem1}")
        emit(pipeline_steady={"run": "bf16", "signatures": sig0,
                              "decode_compile_count":
                              engine.decode_compile_count(),
                              "allocated_after_warm": mem0,
                              "allocated_after_runs": mem1})
    finally:
        gp.shutdown()

    # ---- int8 pages, speculative decoding
    gp = GenerationPipeline(spec, slots=PIPE_SLOTS, max_new_tokens=N_NEW)
    try:
        sig0, mem0 = warm(spec, gp)
        run = drive(gp, "int8_spec", everyone)
        tokens_ok("int8_spec", run, everyone, refs["int8_spec"])
        record("int8_spec", run, everyone, gp)
        check(run["launches"][ALL_KERNELS.index("kv_quant_write")] > 0,
              f"int8 pipeline launched no K4w: {run['launches']}")
        add(run)
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check(counters() == sig0, f"int8 spec pipeline: new step "
              f"signatures after warm-up {sig0} -> {counters()}")
        check(abs(mem1 - mem0) <= 0.01 * mem0,
              f"int8 spec pipeline: memory_allocated {mem0} -> {mem1}")
        emit(pipeline_steady={"run": "int8_spec", "signatures": sig0,
                              "allocated_after_warm": mem0,
                              "allocated_after_runs": mem1})
        emit(pipeline_snapshot=gp.snapshot())
    finally:
        gp.shutdown()

    # ---- half the pages: typed sheds, then admission again
    pool = PIPE_SLOTS * engine.pages_per_slot // 2
    gp = GenerationPipeline(engine, slots=PIPE_SLOTS, max_new_tokens=N_NEW,
                            cache_pages=pool)
    try:
        shed_prompts = [rng.integers(0, V, (PIPE_SHED_PROMPT,)).astype(
            np.int32) for _ in range(PIPE_SLOTS)]
        prompts.extend(shed_prompts)
        idx = list(range(len(prompts) - PIPE_SLOTS, len(prompts)))
        run = drive(gp, "bf16_half_pool", idx, stagger=0.0)
        add(run)
        kinds = ["ok" if isinstance(r, np.ndarray) else
                 "shed" if isinstance(r, CachePagesExhausted) else repr(r)
                 for r in run["results"]]
        check(set(kinds) <= {"ok", "shed"} and "shed" in kinds,
              f"half pool: want typed CachePagesExhausted sheds, got "
              f"{kinds}")
        after = drive(gp, "bf16_half_pool_after", [0, 3])
        add(after)
        check(all(isinstance(r, np.ndarray) and r.shape == (N_NEW,)
                  for r in after["results"]),
              f"half pool: later requests failed {after['results']}")
        emit(pipeline_shed={"cache_pages": pool, "prompt_len":
                            PIPE_SHED_PROMPT, "outcomes": kinds,
                            "later_requests_finished": 2})
    finally:
        gp.shutdown()
    emit(pipeline_cost=cost_model.global_cost_model().snapshot())
    del spec, int8, draft, dmodel
    torch.cuda.empty_cache()
    return tuple(launches)


# ------------------------------------------------------------ serving plane
FD_SLOTS = 4
FD_STAGGER_S = 0.030       # the 8 SSE clients start over 0-30 ms
FD_CANARY_NEW = 8          # tokens a request during the rollout
FD_TIMEOUT_S = 120.0       # any one HTTP call of the phase
#: the reference's session-failover drill (benchmarks/http_load.py
#: ``run_session_failover``): its fault spec, streams and tokens
FLEET_FAULTS = ("generation.step:latency:1.0,generation.step:crash:0.02:2,"
                "generation.adopt:error:0.5:2")
FLEET_STREAMS = 8
FLEET_NEW = 16
FLEET_SPINUP_S = 240.0     # workers start, load the kernels and warm up
FLEET_STREAM_S = 180.0     # every stream's socket and join
#: a drill stream may differ from the undisturbed run only where the two
#: tokens' logits, teacher-forced, are this close (f32 demo model: the
#: adoption's re-prefill rounds its rows otherwise than decode steps did)
TOL_FLEET_FLIP = 1e-4


def http_call(addr, path, doc=None, headers=None, timeout=FD_TIMEOUT_S,
              raw=None):
    """(status, JSON body, headers) of one request: a POST of ``doc`` (or
    of the bytes ``raw``), a GET when both are None."""
    import urllib.error
    import urllib.request
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    data = raw if raw is not None else (
        json.dumps(doc).encode() if doc is not None else None)
    req = urllib.request.Request(addr + path, data=data, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}"), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            payload = {"raw": body.decode(errors="replace")}
        return e.code, payload, dict(e.headers)


class SseClient(threading.Thread):
    """One streamed ``/v1/generate`` of ``doc`` to ``addr`` (``http://host:
    port``) over a raw socket: the response's status and headers, every
    (event, data) pair in wire order, each token's ``id:`` and receive time
    (``time.monotonic``), the terminal ``done`` or ``error`` event, and the
    time the request was sent. Every read has a timeout. ``run()`` on the
    caller's thread is a blocking call; ``start()`` streams beside it."""

    def __init__(self, addr, doc, headers=None, timeout=FLEET_STREAM_S):
        super().__init__(daemon=True)
        host, port = addr.split("//", 1)[1].rsplit(":", 1)
        self.doc = dict(doc, stream=True)
        self._addr, self._headers = (host, int(port)), dict(headers or {})
        self.timeout = timeout
        self.ids, self.toks, self.at, self.events = [], [], [], []
        self.status, self.headers = None, {}
        self.done = self.error = self.exc = self.sent_at = None

    def _head(self, blob):
        lines = blob.decode("latin-1").split("\r\n")
        self.status = int(lines[0].split()[1])
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            self.headers[k.strip()] = v.strip()

    def _line(self, ln, state):
        if ln.startswith(b"id:"):
            state["id"] = int(ln[3:].strip())
        elif ln.startswith(b"event:"):
            state["event"] = ln[6:].strip().decode()
        elif ln.startswith(b"data:"):
            ev, data = state["event"], json.loads(ln[5:].strip())
            self.events.append((ev, data))
            if ev == "token":
                if state["id"] is not None:
                    self.ids.append(state["id"])
                state["id"] = None
                self.toks.append(data["token"])
                self.at.append(time.monotonic())
            elif ev == "done":
                self.done = data
            elif ev == "error":
                self.error = data

    def run(self):
        import socket
        try:
            body = json.dumps(self.doc).encode()
            extra = "".join(f"{k}: {v}\r\n"
                            for k, v in self._headers.items()).encode()
            s = socket.create_connection(self._addr, timeout=self.timeout)
            s.settimeout(self.timeout)
            self.sent_at = time.monotonic()
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n" + extra
                      + b"Content-Length: " + str(len(body)).encode()
                      + b"\r\nConnection: close\r\n\r\n" + body)
            buf, head, state = b"", True, {"id": None, "event": None}
            while True:
                try:
                    data = s.recv(65536)
                except OSError as e:
                    self.exc = e
                    break
                if not data:
                    break
                buf += data
                if head:
                    if b"\r\n\r\n" not in buf:
                        continue
                    blob, _, buf = buf.partition(b"\r\n\r\n")
                    self._head(blob)
                    head = False
                while b"\n" in buf:
                    ln, _, buf = buf.partition(b"\n")
                    self._line(ln.strip(), state)
            s.close()
        except Exception as e:          # graded by the caller
            self.exc = e


def _serve_stats(clients):
    """TTFT (request sent to the first token event), ms per emitted token
    after the first, and tokens/s over the whole wall, of finished
    streams."""
    done = [c for c in clients if c.at]
    t0 = min(c.sent_at for c in done)
    t1 = max(c.at[-1] for c in done)
    toks = sum(len(c.toks) for c in done)
    return {"ttft_ms": [1e3 * (c.at[0] - c.sent_at) for c in done],
            "ms_per_emitted_token": statistics.mean(
                1e3 * (c.at[-1] - c.at[0]) / max(1, len(c.at) - 1)
                for c in done),
            "tokens": toks, "wall_s": t1 - t0, "tokens_per_s": toks / (t1 - t0)}


def frontdoor_phase(torch, model, engine):
    """The serving plane in-process at full width: ``deploy_generative``
    of ``engine`` (the large config, bf16 pages) as ``g1`` at FD_SLOTS
    slots behind ``FrontDoor`` on 127.0.0.1. One request at a time at each
    of PROMPT_LENS, N_NEW greedy tokens, plain JSON and SSE (the same
    tokens exactly, and the engine's own greedy decode up to its first
    near tie); 8 concurrent SSE clients into FD_SLOTS slots (TTFT, ms per
    emitted token, tokens/s, the decode thread's host ms a step) in turns
    with the same 8 as plain JSON requests and straight into the
    pipeline; a canary of ``g2`` (the same weights) walked shadow → canary
    → ramp → full through ``/admin/rollout`` with ``/debug/frontdoor``
    read at each stage and ``serving.snapshot()`` (the ``/debug/deploy``
    payload) beside it, while a client keeps sending requests, then
    ``retire("g1")``, with no request dropped; an idempotent replay that
    runs no generation; the reference's status mapping. Returns every
    kernel's launches in the phase."""
    from deeplearning4j_tpu_torch import serving
    from deeplearning4j_tpu_torch.parallel.generation import _GenMetrics
    from deeplearning4j_tpu_torch.serving import (FrontDoor, ModelRegistry,
                                                  ServingRouter)
    from deeplearning4j_tpu_torch.serving import idempotency as idem
    V = model.config.vocab_size
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(0, V, (n,)).astype(np.int32)
               for _ in range(2) for n in PROMPT_LENS]
    solo = []
    for p in prompts:
        toks, steps = engine.generate(p[None], N_NEW, return_logits=True)
        solo.append((toks[0].tolist(), near_tie_step(steps)))

    def same_as_solo(i, got, label):
        want, tie = solo[i]
        upto = N_NEW if tie is None else tie
        check(len(got) == N_NEW and got[:upto] == want[:upto],
              f"frontdoor {label} (prompt {prompts[i].size}): tokens "
              f"differ from the engine's greedy decode before step {upto} "
              f"(its first near tie: {tie})")

    obs = _GenMetrics.get()
    reg = ModelRegistry()
    fd = fd_busy = None
    try:
        dv = reg.deploy_generative("g1", engine, slots=FD_SLOTS,
                                   max_new_tokens=N_NEW)
        emit(frontdoor_deploy={"version": "g1",
                               "warmup_seconds": dv.warmup_seconds,
                               "warmed_buckets": dv.warmed_buckets,
                               "slots": FD_SLOTS})
        router = ServingRouter(reg, "g1")
        fd = FrontDoor(gen_router=router, host="127.0.0.1", port=0).start()
        addr = fd.get_address()
        reset_all_counts()                   # this path starts here
        for i in range(len(PROMPT_LENS)):
            doc = {"prompt": prompts[i].tolist(), "max_new_tokens": N_NEW}
            code, plain, hdrs = http_call(addr, "/v1/generate", doc)
            check(code == 200 and hdrs.get("X-Dl4j-Trace-Id"),
                  f"frontdoor plain request: {code} {plain}")
            c = SseClient(addr, doc, timeout=FD_TIMEOUT_S)
            c.run()
            check(c.done is not None and c.error is None and c.exc is None,
                  f"frontdoor SSE request: {c.error} {c.exc}")
            check(c.toks == plain["tokens"] == c.done["tokens"]
                  and c.ids == list(range(N_NEW)),
                  f"frontdoor: SSE tokens {c.toks} ids {c.ids} against "
                  f"plain {plain['tokens']}")
            same_as_solo(i, c.toks, "single request")
        single = delta((0,) * len(ALL_KERNELS))

        # 8 concurrent SSE clients, and the same 8 straight into the
        # pipeline (its host cost without the HTTP layer), in turns
        gp = dv.gp

        def steps_books():
            return obs.step_latency.count, obs.step_latency.sum

        def host_ms(before):
            n = obs.step_latency.count - before[0]
            return 1e3 * (obs.step_latency.sum - before[1]) / max(1, n)

        def over_http():
            clients = [SseClient(addr, {"prompt": p.tolist(),
                                        "max_new_tokens": N_NEW},
                                 timeout=FD_TIMEOUT_S) for p in prompts]
            before = steps_books()
            t0 = time.monotonic()
            for j, c in enumerate(clients):
                time.sleep(max(0.0, t0 + FD_STAGGER_S * j
                               / (len(clients) - 1) - time.monotonic()))
                c.start()
            for c in clients:
                c.join(FD_TIMEOUT_S)
            for j, c in enumerate(clients):
                check(not c.is_alive() and c.done is not None
                      and c.error is None, f"frontdoor client {j}: "
                      f"{c.error} {c.exc}")
                same_as_solo(j, c.toks, f"concurrent client {j}")
            return {**_serve_stats(clients),
                    "host_ms_per_step": host_ms(before)}

        def over_http_json():
            """The same 8 as plain JSON requests: no per-token work on the
            handler threads (no TTFT: the tokens come at the end)."""
            out = [None] * len(prompts)

            def client(j):
                out[j] = http_call(addr, "/v1/generate",
                                   {"prompt": prompts[j].tolist(),
                                    "max_new_tokens": N_NEW})

            before = steps_books()
            threads = []
            t0 = time.monotonic()
            for j in range(len(prompts)):
                time.sleep(max(0.0, t0 + FD_STAGGER_S * j
                               / (len(prompts) - 1) - time.monotonic()))
                th = threading.Thread(target=client, args=(j,),
                                      daemon=True)
                th.start()
                threads.append(th)
            for th in threads:
                th.join(FD_TIMEOUT_S)
            wall = time.monotonic() - t0
            for j, r in enumerate(out):
                check(r is not None and r[0] == 200,
                      f"frontdoor JSON client {j}: {r}")
                same_as_solo(j, r[1]["tokens"], f"JSON client {j}")
            toks = sum(len(r[1]["tokens"]) for r in out)
            return {"tokens": toks, "wall_s": wall,
                    "tokens_per_s": toks / wall,
                    "host_ms_per_step": host_ms(before)}

        def in_process():
            done = [None] * len(prompts)
            sent, seen = [None] * len(prompts), [[] for _ in prompts]

            def client(j):
                def on_token(tok, k):
                    seen[j].append(time.monotonic())
                sent[j] = time.monotonic()
                done[j] = gp.generate(prompts[j], max_new_tokens=N_NEW,
                                      on_token=on_token)

            before = steps_books()
            threads = []
            t0 = time.monotonic()
            for j in range(len(prompts)):
                time.sleep(max(0.0, t0 + FD_STAGGER_S * j
                               / (len(prompts) - 1) - time.monotonic()))
                th = threading.Thread(target=client, args=(j,),
                                      daemon=True)
                th.start()
                threads.append(th)
            for th in threads:
                th.join(FD_TIMEOUT_S)
            check(all(d is not None for d in done),
                  "frontdoor: an in-process request did not finish")
            for j, d in enumerate(done):
                same_as_solo(j, d.tolist(), f"in-process request {j}")
            return {**_serve_stats([types.SimpleNamespace(
                at=seen[j], sent_at=sent[j], toks=done[j].tolist())
                for j in range(len(prompts))]),
                "host_ms_per_step": host_ms(before)}

        turns = [("http_sse", over_http()), ("in_process", in_process()),
                 ("http_json", over_http_json()),
                 ("http_json", over_http_json()),
                 ("in_process", in_process()), ("http_sse", over_http())]

        def mean_of(kind, key):
            vals = [r[key] if key != "ttft_ms" else statistics.mean(r[key])
                    for k, r in turns if k == kind and key in r]
            return statistics.mean(vals) if vals else None

        emit(frontdoor_serve={
            "requests": len(prompts), "slots": FD_SLOTS, "new": N_NEW,
            "turns": turns, **{f"{kind}_{key}": mean_of(kind, key)
                               for kind in ("http_sse", "http_json",
                                            "in_process")
                               for key in ("ttft_ms", "ms_per_emitted_token",
                                           "tokens_per_s",
                                           "host_ms_per_step")}})

        # idempotency: a repeated key replays and runs no generation
        key = {idem.IDEMPOTENCY_HEADER: "chip-smoke-K1"}
        doc = {"prompt": prompts[3].tolist(), "max_new_tokens": N_NEW}
        code, first, h1 = http_call(addr, "/v1/generate", doc, key)
        admitted, before = obs.requests.value, all_counts()
        code2, again, h2 = http_call(addr, "/v1/generate", doc, key)
        admitted2, after = obs.requests.value, all_counts()
        replays = idem.snapshot()
        check(code == code2 == 200 and again["tokens"] == first["tokens"]
              and h2.get(idem.REPLAY_HEADER) == "1"
              and idem.REPLAY_HEADER not in h1
              and replays["entries"]["chip-smoke-K1"]["executions"] == 1
              and admitted2 == admitted and after == before,
              f"idempotent replay: {code} {code2} {h2} {replays}, "
              f"admitted {admitted} -> {admitted2}, launches "
              f"{delta(before)}")
        same_as_solo(3, first["tokens"], "idempotent request")
        emit(frontdoor_idempotency={
            "tokens_equal": True, "executions": 1,
            "pipeline_admitted_during_replay": admitted2 - admitted,
            "launches_during_replay": sum(after) - sum(before)})

        # statuses, each with the trace header
        statuses = {}

        def status(label, code, body, hdrs):
            check(hdrs.get("X-Dl4j-Trace-Id"),
                  f"frontdoor {label}: no X-Dl4j-Trace-Id ({code})")
            statuses[label] = (code, body.get("error"))

        status("unknown_version", *http_call(
            addr, "/admin/rollout", {"lane": "generative",
                                     "candidate": "nope"}))
        status("classify", *http_call(addr, "/v1/classify",
                                      {"inputs": [[0.0] * 4]}))
        status("deadline_1ms", *http_call(
            addr, "/v1/generate", {"prompt": prompts[0].tolist(),
                                   "max_new_tokens": N_NEW,
                                   "deadline_ms": 1.0}))
        status("malformed", *http_call(addr, "/v1/generate", raw=b"{"))
        fd_busy = FrontDoor(gen_router=router, host="127.0.0.1", port=0,
                            max_inflight=0).start()
        code, body, hdrs = http_call(fd_busy.get_address(), "/v1/generate",
                                     {"prompt": [1, 2, 3]})
        status("inflight_full", code, body, hdrs)
        retry_after = hdrs.get("Retry-After")
        fd_busy.stop()
        fd_busy = None
        want = {"unknown_version": (404, "KeyError"),
                "classify": (404, "KeyError"),
                "deadline_1ms": (504, "DeadlineExceeded"),
                "malformed": (400, "BadRequest"),
                "inflight_full": (429, "ShedError")}
        emit(frontdoor_statuses={**{k: list(v) for k, v in
                                    statuses.items()},
                                 "retry_after": retry_after})
        check(statuses == want and retry_after == "1",
              f"frontdoor statuses {statuses}, Retry-After {retry_after}; "
              f"want {want} and 1")

        # canary of g2 (the same weights) walked to full while a client
        # keeps sending requests, then g1 retired: nothing dropped
        reg.deploy_generative("g2", engine, slots=FD_SLOTS,
                              max_new_tokens=N_NEW)
        stop = threading.Event()
        background = []

        def keep_sending():
            j = 0
            while not stop.is_set():
                p = prompts[3 + 4 * (j % 2)]
                code, body, _h = http_call(
                    addr, "/v1/generate", {"prompt": p.tolist(),
                                           "max_new_tokens": FD_CANARY_NEW,
                                           "request_key": f"bg-{j}"})
                background.append((code, body.get("tokens"), j % 2))
                j += 1

        policy = {"start_stage": "shadow", "shadow_fraction": 1.0,
                  "canary_fraction": 0.5, "ramp_fractions": [0.75],
                  "window_requests": 2, "healthy_windows": 1,
                  "min_requests": 2, "min_shadow": 1,
                  "latency_ratio_degraded": None,
                  "latency_ratio_failing": None,
                  "drain_timeout_s": FD_TIMEOUT_S}
        code, ro, _h = http_call(addr, "/admin/rollout",
                                 {"lane": "generative", "candidate": "g2",
                                  "policy": policy})
        check(code == 200 and ro["stage"] == "shadow",
              f"begin_rollout: {code} {ro}")
        bg = threading.Thread(target=keep_sending, daemon=True)
        bg.start()
        stages, deploys = ["shadow"], []
        deadline = time.monotonic() + FD_TIMEOUT_S
        while time.monotonic() < deadline:
            code, snap, _h = http_call(addr, "/debug/frontdoor")
            gen = snap["generative"]
            stage = (gen["rollout"] or {}).get("stage")
            if stage != stages[-1]:
                stages.append(stage)
                deploys.append({"stage": stage, "deploy": [
                    {v["version"]: v["state"] for v in r["versions"]}
                    for r in serving.snapshot()["registries"]
                    if any(v["version"] in ("g1", "g2")
                           for v in r["versions"])]})
            if stage in ("full", "rolled_back"):
                break
            time.sleep(0.05)
        check(stages[-1] == "full" and "canary" in stages
              and "ramp" in stages,
              f"canary walk: {stages}")
        retired = reg.retire("g1", drain_timeout_s=FD_TIMEOUT_S)
        stop.set()
        bg.join(FD_TIMEOUT_S)
        check(not bg.is_alive(), "the background client hung")
        dropped = [b for b in background if b[0] != 200]
        check(retired and not dropped and background
              and router.snapshot()["primary"] == "g2",
              f"retire g1: drained {retired}, dropped {dropped}, "
              f"primary {router.snapshot()['primary']}")
        for code, toks, which in background:
            want, tie = solo[3 + 4 * which]
            upto = FD_CANARY_NEW if tie is None else min(tie, FD_CANARY_NEW)
            check(toks[:upto] == want[:upto],
                  f"a request during the rollout: {toks} against the "
                  f"engine's {want[:FD_CANARY_NEW]} (first near tie {tie})")
        emit(frontdoor_canary={
            "stages": stages, "deploy_at_each_stage": deploys,
            "requests_during_rollout": len(background),
            "dropped": len(dropped), "g1_retired_drained": retired,
            "primary": router.snapshot()["primary"],
            "history": router.snapshot()["rollout"]["history"]})
        launches = delta((0,) * len(ALL_KERNELS))
        named = dict(zip(ALL_KERNELS, launches))
        emit(frontdoor_launches={"single_requests": dict(zip(
            ALL_KERNELS, single)), "phase": named})
        check(named["wgmma"] > 0 and named["paged_attention_write"] > 0
              and sum(n for k, n in named.items()
                      if k not in ("wgmma", "paged_attention_write")) == 0,
              f"the front door path launched kernels off its path: {named}")
        return launches
    finally:
        if fd_busy is not None:
            fd_busy.stop()
        if fd is not None:
            fd.stop()
        reg.shutdown(drain_timeout_s=FD_TIMEOUT_S)


def _announce(proc, timeout):
    """The fleet's announce line from ``tools.serve``'s stdout, read on a
    helper thread so the wait is bounded."""
    import queue
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError(f"no fleet announce within {timeout} s")
        try:
            line = lines.get(timeout=left)
        except queue.Empty:
            continue
        if line is None:
            raise RuntimeError("tools.serve exited before announcing")
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and "fleet" in doc:
            return doc


def session_failover_drill(device, state_dir, baseline_fn, gap_fn=None,
                           spinup_s=FLEET_SPINUP_S,
                           stream_s=FLEET_STREAM_S):
    """The reference's session-failover drill (``benchmarks/http_load.py``
    ``run_session_failover``) against the port's server: ``python -m
    deeplearning4j_tpu_torch.tools.serve --workers 2`` on ``device`` with
    FLEET_FAULTS in the workers' environment; FLEET_STREAMS SSE streams of
    FLEET_NEW tokens through its proxy; the worker with the highest id
    SIGKILLed once every stream has two tokens and every session a record
    in the store; every stream graded for completion, a gapless ``id:``
    sequence and tokens equal to ``baseline_fn(prompts, FLEET_NEW)`` (the
    undisturbed run). A differing stream is passed to ``gap_fn(i,
    want, got, at)`` for its teacher-forced top-2 gap. The record also
    says which sessions the killed worker owned live at the kill and which
    of them the survivor adopted (owner and a bumped fence in the store),
    and holds the survivor's own kernel launches after its warm-up
    (``survivor_launches``, written by the worker when the fleet stops;
    tools.serve's DL4J_TPU_LAUNCH_COUNTS_DIR). Every wait is bounded and
    the fleet is stopped in a ``finally``. Returns the drill's record,
    keyed as the reference's ``SESS_r01.json``."""
    import os
    import signal
    import subprocess
    from deeplearning4j_tpu_torch.serving import SharedStore
    from deeplearning4j_tpu_torch.tools.serve import LAUNCH_COUNTS_ENV
    n_streams, n_new = FLEET_STREAMS, FLEET_NEW
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, 61, (int(rng.integers(4, 8)),)).tolist()
               for _ in range(n_streams)]
    baselines = baseline_fn(prompts, n_new)
    counts_dir = Path(state_dir).with_name(Path(state_dir).name + "-launches")
    counts_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env.pop("DL4J_TPU_SESSIONS", None)        # the drill grades the ON path
    env["DL4J_TPU_SESSION_JOURNAL_STEPS"] = "1"
    env["DL4J_TPU_FAULTS"] = FLEET_FAULTS
    env[LAUNCH_COUNTS_ENV] = str(counts_dir)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.serve",
         "--workers", "2", "--port", "0", "--state-dir", str(state_dir),
         "--slots", str(n_streams), "--no-respawn", "--device", device,
         "--spinup-timeout-s", str(spinup_s)],
        stdout=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
    try:
        fleet = _announce(proc, spinup_s + 30)
        addr = fleet["address"]
        deadline = time.monotonic() + 60
        while True:
            try:
                code, _b, _h = http_call(addr, "/debug/frontdoor",
                                         timeout=5.0)
                if code == 200:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline, "the fleet never answered")
            time.sleep(0.5)
        store = SharedStore(str(state_dir))
        workers = store.read().get("workers") or {}
        classify = classify_workers(device, workers)
        victim = sorted(workers)[-1]             # spare the leader
        survivor = sorted(workers)[0]
        victim_pid = int(workers[victim]["pid"])
        streams = [SseClient(addr, {"prompt": p, "max_new_tokens": n_new},
                             timeout=stream_s) for p in prompts]
        for st in streams:
            st.start()
            time.sleep(0.05)
        # every stream two tokens in (the reference's moment) and every
        # session journaled once: a session with no record in the store
        # has nothing a survivor can adopt, in either package, and the
        # journal commits at most every DL4J_TPU_SESSION_FLUSH_MS
        deadline = time.monotonic() + stream_s
        while time.monotonic() < deadline and not (
                all(len(st.ids) >= 2 or st.done is not None
                    for st in streams)
                and len(store.read().get("sessions") or {}) >= n_streams):
            time.sleep(0.05)
        inflight_at_kill = [len(st.ids) for st in streams]
        at_kill = store.read().get("sessions") or {}
        os.kill(victim_pid, signal.SIGKILL)
        killed_at = time.monotonic()
        for st in streams:
            st.join(stream_s)
        orphans = {sid: int(r.get("fence") or 0) for sid, r in
                   at_kill.items() if r.get("owner") == victim
                   and r.get("status") == "live"}
        after = store.read().get("sessions") or {}
        adopted = sorted(
            sid for sid, fence in orphans.items()
            if (after.get(sid) or {}).get("owner") == survivor
            and int(after[sid].get("fence") or 0) > fence)
        complete = seq_exact = match = 0
        resume_lat, failures, flips = [], [], {}
        for i, (st, base) in enumerate(zip(streams, baselines)):
            gapless = st.ids == list(range(len(st.ids)))
            ok_done = st.done is not None and not st.is_alive()
            ok_match = st.toks == base
            complete += ok_done
            seq_exact += gapless and len(st.ids) == n_new
            match += ok_match
            if not (gapless and ok_done and ok_match):
                failures.append({"stream": i, "n": len(st.ids),
                                 "gapless": gapless, "done": ok_done,
                                 "match": ok_match, "error": st.error,
                                 "exc": repr(st.exc)})
                if (gap_fn is not None and len(st.toks) == len(base)
                        and not ok_match):
                    at = next(k for k, (a, b) in enumerate(
                        zip(base, st.toks)) if a != b)
                    flips[i] = gap_fn(prompts[i], base, st.toks, at)
            post = [t for t in st.at if t > killed_at]
            if inflight_at_kill[i] < n_new and post:
                resume_lat.append(post[0] - killed_at)
        try:
            sessions = http_call(addr, "/debug/sessions", timeout=10.0)[1]
        except OSError:
            sessions = {}
        rec = {
            "metric": "sess_failover", "device": device,
            "sess_completion": complete / n_streams,
            "sess_seq_exact": seq_exact / n_streams,
            "sess_greedy_match": match / n_streams,
            "sess_streams": n_streams, "inflight_at_kill": inflight_at_kill,
            "journaled_at_kill": len(at_kill),
            "victim_live_at_kill": len(orphans),
            "adopted_by_survivor": len(adopted),
            "resume_latency_ms": (1e3 * max(resume_lat)
                                  if resume_lat else None),
            "resume_latency_ms_all": sorted(1e3 * t for t in resume_lat),
            "resumed_streams": len(resume_lat),
            "survivor_sessions": len(sessions.get("sessions") or []),
            "survivor_worker": survivor,
            "killed_worker": victim, "failures": failures, "flips": flips,
            "session_faults": FLEET_FAULTS, "workers": 2,
            "classify": classify,
            "prompts": prompts, "baselines": baselines}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    counts = counts_dir / f"{survivor}.json"
    check(counts.exists(), f"the survivor {survivor} wrote no launch counts")
    rec["survivor_launches"] = json.loads(counts.read_text())
    return rec


def classify_workers(device, workers):
    """One ``POST /v1/classify`` of 3 seeded rows straight to each worker
    of the fleet (``workers``: the store's entries): its status and the
    largest |Δ| of its probabilities from the demo scoring net's (the
    workers' ``v1``) in this process on ``device``, by worker id."""
    from deeplearning4j_tpu_torch.tools.serve import (DEMO_SCORING_IN,
                                                      demo_scoring_net)
    xs = np.random.default_rng(SEED + 41).standard_normal(
        (3, DEMO_SCORING_IN)).astype(np.float32)
    want = demo_scoring_net(device).output(xs).float().cpu().numpy()
    out = {}
    for wid, w in sorted(workers.items()):
        code, body, _h = http_call(f"http://127.0.0.1:{int(w['port'])}",
                                   "/v1/classify", {"inputs": xs.tolist()},
                                   timeout=30.0)
        got = np.asarray(body.get("outputs", []), np.float32)
        out[wid] = {"status": code, "version": body.get("version"),
                    "max_abs": (float(np.abs(got - want).max())
                                if got.shape == want.shape else None)}
    return out


def check_classify(rec):
    """Every worker of the drill answered its classify request with 200
    and the demo net's probabilities within TOL_FLEET_CLASSIFY."""
    got = rec["classify"]
    check(len(got) == rec["workers"] and all(
        c["status"] == 200 and c["max_abs"] is not None
        and c["max_abs"] <= TOL_FLEET_CLASSIFY for c in got.values()),
        f"fleet classify: {got} (row {TOL_FLEET_CLASSIFY})")


def check_drill(rec):
    """What the drill must show besides the streams' grades: every stream
    still in flight at the kill, the killed worker owning at least one
    live session then, and the survivor adopting every one of them."""
    check(all(n < FLEET_NEW for n in rec["inflight_at_kill"]),
          f"fleet drill: a stream had ended before the kill: "
          f"{rec['inflight_at_kill']}")
    check(rec["victim_live_at_kill"] >= 1
          and rec["adopted_by_survivor"] == rec["victim_live_at_kill"],
          f"fleet drill: {rec['victim_live_at_kill']} live sessions of the "
          f"killed worker, {rec['adopted_by_survivor']} adopted by the "
          f"survivor")


def demo_baselines(device, slots=FLEET_STREAMS):
    """A ``baseline_fn`` for :func:`session_failover_drill`: the demo
    model the workers deploy, in this process on ``device``, each prompt
    through a ``GenerationPipeline`` undisturbed. Returns (the function,
    the engine)."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        GenerationPipeline)
    from deeplearning4j_tpu_torch.tools.serve import demo_engine
    engine = demo_engine(device)

    def baseline(prompts, n_new):
        with GenerationPipeline(engine, slots=slots,
                                max_new_tokens=n_new) as gp:
            return [gp.generate(np.asarray(p, np.int32),
                                max_new_tokens=n_new).tolist()
                    for p in prompts]

    return baseline, engine


def fleet_phase(torch):
    """The reference's session-failover drill on the card: two workers of
    the port's ``tools.serve`` (the demo ``g1``), one SIGKILLed with every
    stream mid-flight, under FLEET_FAULTS; completion, sequence exactness
    and greedy match against the same demo model's undisturbed run in
    this process must each be 1.0 (a differing stream only at a flip whose
    teacher-forced gap is at most TOL_FLEET_FLIP), and the survivor must
    adopt every live session of the killed worker. Returns the survivor's
    launches after its warm-up, in ALL_KERNELS' order: it served its own
    streams and re-prefilled and decoded every adopted one."""
    import tempfile
    baseline, engine = demo_baselines("cuda")
    model, params = engine.model, engine.params

    def gap(prompt, want, got, at):
        return flip_gap(torch, model, params, np.asarray(prompt, np.int32),
                        np.asarray(want), np.asarray(got), at)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dl4j-fleet-") as tmp:
        rec = session_failover_drill("cuda", Path(tmp) / "store", baseline,
                                     gap)
    rec["seconds"] = time.perf_counter() - t0
    rec["baseline_top2_gaps"] = baseline_gaps(torch, model, params,
                                              rec.pop("prompts"),
                                              rec.pop("baselines"))
    emit(fleet_drill=rec)
    for i, flip in rec["flips"].items():
        check(flip["gap"] <= TOL_FLEET_FLIP,
              f"fleet drill stream {i}: differs from the undisturbed run "
              f"at token {flip['at']}, gap {flip['gap']} (not a near tie)")
    check(rec["sess_completion"] == 1.0 and rec["sess_seq_exact"] == 1.0,
          f"fleet drill: completion {rec['sess_completion']}, seq exact "
          f"{rec['sess_seq_exact']}: {rec['failures']}")
    check(rec["sess_greedy_match"] == 1.0
          or len(rec["flips"]) == FLEET_STREAMS
          - round(rec["sess_greedy_match"] * FLEET_STREAMS),
          f"fleet drill: greedy match {rec['sess_greedy_match']} with "
          f"unexplained streams: {rec['failures']}")
    check_drill(rec)
    check_classify(rec)
    named = rec["survivor_launches"]
    return tuple(named[k] for k in ALL_KERNELS)


def baseline_gaps(torch, model, params, prompts, streams):
    """The readings behind TOL_FLEET_FLIP: teacher-forced over each
    undisturbed stream, the top-2 logit gap at every token (the margin a
    rounding of the re-prefilled rows would have to cross to flip it) —
    the smallest, and how many are at most TOL_FLEET_FLIP — and the
    largest |logit| gap between that whole-sequence apply and each
    stream's own prefix applies (the same rows at other lengths, so other
    rounding: what a restore's re-prefill perturbs)."""
    gaps, moved = [], 0.0
    with torch.inference_mode():
        for p, toks in zip(prompts, streams):
            full = np.asarray(list(p) + list(toks[:-1]), np.int32)[None]
            logits = model.apply(params, torch.as_tensor(
                full, device=model.device))[0].float()
            rows = logits[len(p) - 1:]
            top = torch.topk(rows, 2, dim=-1).values
            gaps += (top[:, 0] - top[:, 1]).cpu().tolist()
            for k in range(1, len(toks)):
                part = model.apply(params, torch.as_tensor(
                    full[:, :len(p) + k - 1], device=model.device))
                moved = max(moved, float((part[0, -1].float()
                                          - logits[len(p) + k - 2])
                                         .abs().max()))
    return {"min": min(gaps), "at_most_tol": sum(g <= TOL_FLEET_FLIP
                                                 for g in gaps),
            "tokens": len(gaps), "max_logit_shift": moved}


def decode_profile_phase(torch, engine):
    """One torch.profiler window over 4 decode steps of one slot after a
    960-token prompt, on bf16 pages (``engine``) and on int8 pages (an
    engine with ``kv_quant``, its gate passed): the device's busy share,
    the kernels a step and the device time by kernel, K4a+w's among them
    (one launch a layer a step, K4w none)."""
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    prompt = np.random.default_rng(SEED + 7).integers(
        0, LARGE["vocab_size"], (1, PROFILE_PROMPT)).astype(np.int32)
    L = LARGE["n_layers"]
    int8 = DecodeEngine(engine.model, engine.params, max_len=engine.max_len,
                        kv_quant=True)
    for pool, eng in (("bfloat16", engine), ("int8", int8)):
        first, _l, kv, t = eng.prefill(prompt)
        state = eng.insert_slot(eng.new_state(1), kv, 0)
        check((state.arrays["k"].dtype == torch.int8) == (pool == "int8"),
              f"decode profile: a {state.arrays['k'].dtype} pool for {pool}")
        toks, pos = first, np.full((1,), t, np.int32)
        toks, _l, state = eng.decode(state, toks, pos, 1)     # warm
        torch.cuda.synchronize()

        def steps():
            nonlocal toks, pos
            for i in range(4):
                pos = pos + 1
                toks, _lg, _st = eng.decode(state, toks, pos, 2 + i)

        reset_all_counts()
        name = "decode_960_trace.json" if pool == "bfloat16" else \
            "decode_960_int8_trace.json"
        row = profile_window(torch, "decode", steps, name, top=12)
        check(all_counts() == launch_counts(paged_attention_write=4 * L),
              f"profiled decode ({pool}) launched {all_counts()}")
        traced = {k["name"]: k["count"] for k in row.get("decode_kernels",
                                                         ())}
        fused = sum(n for k, n in traced.items()
                    if "paged_attend_kernel" in k)
        quant = sum(n for k, n in traced.items() if "quant_write" in k)
        check((fused == 4 * L and quant == 0) or not TRACE_ON_DEVICE,
              f"profiled decode ({pool}) traced {fused} K4a+w and {quant} "
              f"K4w kernels, not one K4a+w a layer a step ({4 * L})")
        emit(decode_profile={"prompt_len": PROFILE_PROMPT, "steps": 4,
                             "pool": pool,
                             "kernels_per_step": row.get("kernels", 0) / 4,
                             **row})
        del state, kv
    del int8
    torch.cuda.empty_cache()


def decode_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K4a ("paged_attention", its numbers at the
    decode step on bf16 pages; its int8 and dense-view cases beside them;
    since K4a+w no main path calls it alone), K4a+w
    ("paged_attention_write", the same shapes, with the two-launch path's
    times beside) or K4w ("kv_quant_write", at the bucket-1024 insert; no
    single library call computes it)."""
    group = {"paged_attention": lambda c: c[0] not in ("quant", "fused"),
             "paged_attention_write": lambda c: c[0] == "fused",
             "kv_quant_write": lambda c: c[0] == "quant"}[kind]
    key = {"paged_attention": DECODE_MAIN_CASE["paged_attention"],
           "paged_attention_write": ("fused",)
           + FUSED_MAIN_CASE["paged_attention_write"],
           "kv_quant_write": ("quant",) + QUANT_CASES[0]}[kind]
    main = cases[key]
    rows = [r for c, r in cases.items() if group(c)]
    entry = {
        "name": kind, "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}",
        "replaces": "deeplearning4j_tpu/models/transformer.py:" + {
            "paged_attention": "827", "paged_attention_write": "861",
            "kv_quant_write": "107"}[kind],
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": kind != "paged_attention",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main.get("library_device_ms")}
    if kind == "paged_attention":
        entry["library"] = "gather of the slot's pages + SDPA (bool mask)"
        entry["at"] = dict(zip(("b", "w", "h", "hd", "page_tokens",
                                "pages_a_slot", "dtype", "pool", "contexts",
                                "trash_slots"), DECODE_MAIN_CASE[kind]))
        for other in ("paged_attention_int8", "paged_attention_dense"):
            r = cases[DECODE_MAIN_CASE[other]]
            entry[other.split("_")[-1]] = {
                k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "library_ms", "library_device_ms")}
    elif kind == "paged_attention_write":
        entry["library"] = None
        entry["at"] = dict(zip(("b", "w", "h", "hd", "page_tokens",
                                "pages_a_slot", "dtype", "pool", "contexts",
                                "trash_slots"), FUSED_MAIN_CASE[kind]))
        entry["two_launch_device_ms"] = main["two_launch_device_ms"]
        entry["two_launch_ms"] = main["two_launch_ms"]
        for other in ("int8", "dense"):
            r = cases[("fused",) + FUSED_MAIN_CASE[other]]
            entry[other] = {k: r[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms",
                "two_launch_device_ms", "two_launch_ms")}
    else:
        entry["at"] = dict(zip(("b", "w", "layers", "page_tokens", "dtype"),
                               QUANT_CASES[0]))
    return entry


def _union_us(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_phase(torch, fa, engine):
    """One torch.profiler window over a single prefill at bucket 1024: the
    device's busy share of the window and the top device kernels by time.
    The Chrome trace goes to OUT_DIR/prefill_1024_trace.json."""
    prompt = np.random.default_rng(SEED + 2).integers(
        0, LARGE["vocab_size"], (1, PROFILE_PROMPT)).astype(np.int32)
    engine.prefill(prompt)
    torch.cuda.synchronize()
    reset_counts(fa)
    row = profile_window(torch, "prefill", lambda: engine.prefill(prompt),
                         "prefill_1024_trace.json")
    check(counts(fa) == (LARGE["n_layers"], 0, 0, 0),
          f"profiled prefill launched {counts(fa)}")
    emit(profile={"bucket": 1024, **row})


@contextlib.contextmanager
def plain_attention(fa):
    """The plain versions in place of the flash kernels, forward and
    backward, for ``fa.FlashAttention`` (which looks its functions up at
    call time): a reference run of the same model on the card."""
    kernels = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd(q, k, v, causal=False, scale=None, out=None, kmask=None):
        o, lse = fa.flash_attention_reference(q, k, v, causal, scale, kmask)
        return (o if out is None else out.copy_(o)), lse

    def bwd(q, k, v, o, lse, do, causal=False, scale=None, out=None,
            kmask=None):
        grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal, scale, kmask)
        return grads if out is None else tuple(
            dst.copy_(x) for dst, x in zip(out, grads))

    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = kernels


def _train_model(torch, rung, tree_cache, moe=False, base=None):
    """(model, fresh params on the card, n_params, tokens, targets) for one
    rung (batch, remat, ce_chunks) of the large config (``base``: LARGE or
    LARGE_F32): the weights of ``init_jax_layout(cfg, SEED)`` (drawn once
    per layout and kept in ``tree_cache``; f32 masters in either compute
    type), tokens from a numpy seed, targets rolled by −1."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    from deeplearning4j_tpu_torch.parallel.moe import MoEConfig
    from deeplearning4j_tpu_torch.tree import tree_leaves
    batch, remat, chunks = rung
    cfg = TransformerConfig(**(base or LARGE), remat=remat,
                            ce_chunks=chunks,
                            moe=MoEConfig(num_experts=MOE_EXPERTS)
                            if moe else None)
    model = TransformerLM(cfg)
    if moe not in tree_cache:
        tree_cache[moe] = init_jax_layout(cfg, SEED)
    params = from_jax_params(tree_cache[moe], cfg)
    n_params = sum(a.numel() for a in tree_leaves(params))
    tokens = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len)).astype(np.int32)[
        :batch], device=model.device)
    return model, params, n_params, tokens, torch.roll(tokens, -1, dims=1)


def active_params(n_params, moe):
    """Params a token's forward touches: all of them for the dense FFN;
    for the MoE FFN, top-1 of MOE_EXPERTS experts' W1, b1, W2, b2."""
    if not moe:
        return n_params
    d, f, L = LARGE["d_model"], LARGE["d_ff"], LARGE["n_layers"]
    per_expert = 2 * d * f + f + d
    return n_params - L * (MOE_EXPERTS - 1) * per_expert


def train_rung(torch, fa, rung, tree_cache, moe=False, base=None,
               timed=TIMED_STEPS):
    """WARM_STEPS + ``timed`` steps of ``make_train_step(adamw(3e-4))`` at
    one rung (batch, remat, ce_chunks) of the large config (``base``) on one
    batch, each step launching exactly ``expected_per_step`` of every
    kernel. Returns (row, the launches of the steps, what a profile window
    needs)."""
    from deeplearning4j_tpu_torch.optim.adamw import adamw
    batch, remat, chunks = rung
    base = base or LARGE
    f32 = base["dtype"] == "float32"
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated()
    model, params, n_params, tokens, targets = _train_model(
        torch, rung, tree_cache, moe, base)
    L, T = model.config.n_layers, model.config.max_len
    opt = adamw(LEARNING_RATE)
    state = opt.init(params)
    step = model.make_train_step(opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    losses, step_ms = [], []
    per_step = expected_per_step(L, remat, chunks, moe, f32)
    reset_all_counts()
    for i in range(WARM_STEPS + timed):          # the main path starts here
        before = all_counts()
        t = time.perf_counter()
        params, state, loss = step(params, state, tokens, targets)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        got = tuple(a - b for a, b in zip(all_counts(), before))
        check(got == per_step, f"rung {rung}{' MoE' if moe else ''} step "
              f"{i}: launched {got}, want {per_step} {ALL_KERNELS}")
        losses.append(loss)
    launches = all_counts()                      # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"rung {rung}: loss did not fall: "
          f"{losses}")
    ms = statistics.median(step_ms[WARM_STEPS:])
    tokens_per_s = batch * T / (ms / 1e3)
    flops_per_token = train_flops_per_token(active_params(n_params, moe), L,
                                            T, model.config.d_model)
    row = {"batch": batch, "remat": remat, "ce_chunks": chunks,
           "moe": moe, "dtype": base["dtype"], "seq_len": T,
           "params": n_params,
           "active_params": active_params(n_params, moe),
           "losses": losses, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens_per_s, "flops_per_token": flops_per_token,
           "mfu": tokens_per_s * flops_per_token
           / PEAK_FLOPS[base["dtype"]],
           "peak_memory_bytes": peak_bytes,
           # what earlier phases left allocated, and that plus the params
           # and AdamW's moments
           "allocated_at_start_bytes": allocated_at_start,
           "allocated_before_steps_bytes": allocated_before,
           "launches_per_step": dict(zip(ALL_KERNELS, per_step)),
           "launches": dict(zip(ALL_KERNELS, launches))}
    emit(train=row)
    return row, launches, (model, step, params, state, tokens, targets)


def grad_vs_plain(torch, fa, label, model, params, tokens, targets,
                  tol_loss, tol_leaf, moe_only=False):
    """One gradient on the kernels and one on their plain versions (K7's
    alone with ``moe_only``), same weights and batch: |Δloss| and each
    leaf's relative L2 error, the three worst leaves named."""
    from deeplearning4j_tpu_torch.tree import tree_leaves
    loss_k, grads_k = model.loss_and_grads(params, tokens, targets)
    leaves_k = tree_leaves(grads_k)
    check(all(bool(g.isfinite().all()) for g in leaves_k),
          f"{label}: a gradient leaf is not finite")
    with plain_kernels(fa, moe_only):
        loss_p, grads_p = model.loss_and_grads(params, tokens, targets)
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(leaves_k, tree_leaves(grads_p))]
    d_loss = abs(float(loss_k) - float(loss_p))
    worst = sorted(zip(rel, leaf_paths(grads_k)), reverse=True)[:3]
    emit(**{label: {"loss": float(loss_k), "plain_loss": float(loss_p),
                    "abs_diff_loss": d_loss, "max_leaf_rel_l2": max(rel),
                    "median_leaf_rel_l2": statistics.median(rel),
                    "worst_leaves": [[p, r] for r, p in worst],
                    "leaves": len(rel), "plain": "K7" if moe_only else "all",
                    "tolerance": [tol_loss, tol_leaf]}})
    check(d_loss <= tol_loss, f"{label}: loss on the kernels "
          f"{float(loss_k)} vs plain {float(loss_p)}")
    check(max(rel) <= tol_leaf, f"{label}: a gradient leaf's relative L2 "
          f"error {max(rel)} > {tol_leaf}")


def train_phase(torch, fa):
    """bench.py's ladder for the large config (TRAIN_RUNGS), each rung on
    fresh copies of the same weights: the first-step loss of every rung at
    batch 8 equals the (8, False, 0) rung's within f32 sum order; one
    gradient on the kernels held against the plain versions at GRAD_RUNG;
    a profiler window over one step of each of PROFILED_RUNGS.
    Returns each kernel's launches over the rungs' steps."""
    trees, total, first = {}, [0] * len(ALL_KERNELS), {}
    for rung in TRAIN_RUNGS:
        row, launches, (model, step, params, state, tokens, targets) = \
            train_rung(torch, fa, rung, trees)
        total = [a + b for a, b in zip(total, launches)]
        first[rung] = row["losses"][0]
        if rung[0] == TRAIN_BATCH:
            check(abs(first[rung] - first[TRAIN_RUNGS[0]]) <= TOL_RUNG_LOSS,
                  f"rung {rung}: first-step loss {first[rung]} vs "
                  f"{first[TRAIN_RUNGS[0]]} at {TRAIN_RUNGS[0]}")
        if rung in PROFILED_RUNGS:
            name = "train_step%s_trace.json" % "".join(
                s for s, on in (("_ce%d" % rung[2], rung[2]),
                                ("_remat", rung[1])) if on)
            train_profile_phase(torch, rung, row["ms_per_step"], step,
                                params, state, tokens, targets, name)
        if rung == GRAD_RUNG:
            grad_vs_plain(torch, fa, "train_vs_plain", model, params, tokens,
                          targets, TOL_STEP_LOSS, TOL_STEP_LEAF)
        del model, step, params, state
    emit(rung_first_losses={str(k): v for k, v in first.items()})
    return tuple(total)


def moe_train_phase(torch, fa):
    """Training at the large config with a top-1 MoE FFN (MOE_EXPERTS,
    capacity factor 1.25) at MOE_RUNG, then one gradient on the kernels
    against the plain versions, then greedy generation from the trained
    model through ``DecodeEngine``. Returns each kernel's launches over the
    training steps."""
    row, launches, (model, step, params, state, tokens, targets) = \
        train_rung(torch, fa, MOE_RUNG, {}, moe=True)
    train_profile_phase(torch, MOE_RUNG, row["ms_per_step"], step, params,
                        state, tokens, targets, "train_step_moe_trace.json",
                        moe=True)
    _loss, aux = model.loss_fn(params, tokens, targets, with_aux=True)
    emit(moe_aux={k: (v.tolist() if v.dim() else float(v))
                  for k, v in aux.items()})
    grad_vs_plain(torch, fa, "moe_train_vs_plain", model, params, tokens,
                  targets, TOL_MOE_STEP_LOSS, TOL_MOE_STEP_LEAF,
                  moe_only=True)
    # the trained MoE model serves through DecodeEngine (paged, greedy)
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    del step, state
    engine = DecodeEngine(model, params, max_len=LARGE["max_len"])
    prompt = np.random.default_rng(SEED + 5).integers(
        0, LARGE["vocab_size"], (2, 100)).astype(np.int32)
    before = all_counts()
    t = time.perf_counter()
    toks = engine.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    served = tuple(a - b for a, b in zip(all_counts(), before))
    check(toks.shape == (2, N_NEW) and bool(((toks >= 0) & (
        toks < LARGE["vocab_size"])).all()), f"MoE generate: {toks.shape}")
    check(served[6] > 0 and served[7] > 0 and served[4:6] == (0, 0)
          and served[8:10] == (0, 0)
          and served[10:16] == (0,) * 5 + ((N_NEW - 1) * LARGE["n_layers"],)
          and served[16:] == (0,) * (len(ALL_KERNELS) - 16),
          f"MoE generate launched {served} {ALL_KERNELS}")
    emit(moe_generate={"batch": 2, "prompt_len": 100, "new_tokens": N_NEW,
                       "generate_ms": ms,
                       "launches": dict(zip(ALL_KERNELS, served))})
    del model, params, engine
    torch.cuda.empty_cache()
    return launches


def f32_serve_phase(torch):
    """The f32 model (LARGE_F32, the model's default compute type) serving
    one request through ``DecodeEngine`` in its paged mode (f32 pages): a
    PROMPT_LENS[0]-token prompt (bucket 1024) and N_NEW greedy tokens, the
    simple forward once per layer of the prefill and K4a+w once per layer of
    each decode step, no wgmma flash kernel; the decode logits held to
    ``apply`` over the same tokens (TOL_TEACHER_FORCED_F32). Returns each
    kernel's launches in the run."""
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                         init_jax_layout)
    cfg = TransformerConfig(**LARGE_F32)
    params = from_jax_params(init_jax_layout(cfg, SEED), cfg)
    model = TransformerLM(cfg)
    engine = DecodeEngine(model, params, max_len=cfg.max_len)
    state = engine.new_state(1)
    check(engine.paged and state.arrays["k"].dtype == torch.float32,
          f"f32 engine: paged {engine.paged}, pool "
          f"{state.arrays['k'].dtype}")
    del state
    engine.warm(1)
    L, V, n = cfg.n_layers, cfg.vocab_size, PROMPT_LENS[0]
    prompt = np.random.default_rng(SEED + 8).integers(0, V, (1, n)).astype(
        np.int32)
    torch.cuda.synchronize()
    reset_all_counts()                   # the main path starts here
    t = time.perf_counter()
    toks, steps = engine.generate(prompt, N_NEW, return_logits=True)
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t)
    launches = all_counts()              # ... and ends here
    want = launch_counts(simple=L, paged_attention_write=(N_NEW - 1) * L)
    check(launches == want, f"f32 serving launched {launches}, want {want} "
          f"{ALL_KERNELS}")
    check(toks.shape == (1, N_NEW) and bool(((toks >= 0) & (toks < V))
                                            .all()), f"f32 tokens {toks}")
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.prefill(prompt)
        torch.cuda.synchronize()
        pre.append(1e3 * (time.perf_counter() - t))
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    ref = model.apply(engine.params, torch.as_tensor(
        full, device=model.device))[0, n - 1:].cpu().numpy()
    dec = np.concatenate(steps, axis=0)
    check(np.isfinite(dec).all() and np.isfinite(ref).all(),
          "f32: non-finite logits")
    diff = float(np.abs(dec - ref).max())
    prefill_ms = statistics.median(pre)
    emit(f32_request={"prompt_len": n, "bucket": engine.prefill_bucket(n),
                      "pool": "float32", "prefill_ms": prefill_ms,
                      "generate_ms": gen_ms,
                      "decode_ms_per_token": (gen_ms - prefill_ms)
                      / (N_NEW - 1),
                      "teacher_forced_max_abs_diff": diff,
                      "tolerance": TOL_TEACHER_FORCED_F32,
                      "argmax_agree": float(np.mean(
                          dec.argmax(-1) == ref.argmax(-1))),
                      "launches": dict(zip(ALL_KERNELS, launches))})
    check(diff <= TOL_TEACHER_FORCED_F32, f"f32 decode logits differ from "
          f"apply by {diff} > {TOL_TEACHER_FORCED_F32}")
    del engine, model, params
    torch.cuda.empty_cache()
    return launches


def f32_train_phase(torch, fa):
    """Training the f32 model at F32_RUNGS (WARM_STEPS + F32_TIMED_STEPS
    steps each, the launches of ``expected_per_step(..., f32=True)`` every
    step, one profiled step each); the first-step losses of the two rungs
    equal within TOL_RUNG_LOSS; one full-width gradient on the kernels
    against the plain versions at (8, no, 8) (TOL_STEP_LOSS_F32,
    TOL_STEP_LEAF_F32). Returns each kernel's launches over the steps."""
    trees, total, first = {}, [0] * len(ALL_KERNELS), {}
    for rung in F32_RUNGS:
        row, launches, (model, step, params, state, tokens, targets) = \
            train_rung(torch, fa, rung, trees, base=LARGE_F32,
                       timed=F32_TIMED_STEPS)
        total = [a + b for a, b in zip(total, launches)]
        first[rung] = row["losses"][0]
        check(abs(first[rung] - first[F32_RUNGS[0]]) <= TOL_RUNG_LOSS,
              f"f32 rung {rung}: first-step loss {first[rung]} vs "
              f"{first[F32_RUNGS[0]]}")
        train_profile_phase(torch, rung, row["ms_per_step"], step, params,
                            state, tokens, targets, "train_step_f32%s_trace"
                            ".json" % ("_ce%d" % rung[2] if rung[2] else ""),
                            f32=True)
        if rung == GRAD_RUNG:
            grad_vs_plain(torch, fa, "f32_train_vs_plain", model, params,
                          tokens, targets, TOL_STEP_LOSS_F32,
                          TOL_STEP_LEAF_F32)
        del model, step, params, state
        torch.cuda.empty_cache()
    emit(f32_rung_first_losses={str(k): v for k, v in first.items()})
    return tuple(total)


def train_profile_phase(torch, rung, step_ms, step, params, state, tokens,
                        targets, trace_name="train_step_trace.json",
                        moe=False, f32=False):
    """One torch.profiler window over one training step of ``rung`` (of
    the f32 model with ``f32``). The profiler's own host work stretches the
    window, so the device's busy time is also given over ``step_ms``, the
    median unprofiled step."""
    L = LARGE["n_layers"]
    reset_all_counts()
    row = profile_window(torch, "train_step",
                         lambda: step(params, state, tokens, targets),
                         trace_name, top=15)
    want = expected_per_step(L, rung[1], rung[2], moe, f32)
    check(all_counts() == want,
          f"profiled step launched {all_counts()}, want {want}")
    if "device_busy_us" in row:
        row["busy_over_unprofiled_step"] = (row["device_busy_us"]
                                            / (1e3 * step_ms))
    emit(train_profile={"rung": list(rung), "moe": moe,
                        "dtype": "float32" if f32 else "bfloat16", **row})


def _top(totals, n):
    return [{"name": name[:160], "us": us, "count": c}
            for name, (us, c) in sorted(totals.items(),
                                        key=lambda kv: -kv[1][0])[:n]]


def profile_window(torch, label, fn, trace_name, top=10):
    """One torch.profiler window over ``fn()`` (ending in a synchronise),
    its Chrome trace written to OUT_DIR/``trace_name``: the window's
    length, the device's busy time and share in it, and the device time
    by kernel and by the operator that launched each kernel (its
    "External id"; kernels launched outside any operator, as the port's
    ctypes kernels are, count under their own name). A window whose trace
    holds no device event is taken once more (the whole script, 41 windows
    into one process, once traced none for a single LSTM layer pass that
    launches cuBLAS and K11L kernels)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    window = f"chip_smoke.{label}"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace = OUT_DIR / trace_name
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(window):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t)
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        device = [e for e in events if e.get("ph") == "X" and e.get("cat")
                  in ("kernel", "gpu_memcpy", "gpu_memset")]
        windows = [e for e in events if e.get("ph") == "X"
                   and e.get("name") == window
                   and e.get("cat") == "user_annotation"]
        if device or not TRACE_ON_DEVICE:
            break
        emit(profile_window_retried={"label": label, "attempt": attempt,
                                     "device_events": 0})
    if not device or not windows:
        # only a rehearsal on the CPU, with TRACE_ON_DEVICE set to False,
        # gets here without failing
        check(not TRACE_ON_DEVICE,
              f"the profiler traced {len(device)} device events and "
              f"{len(windows)} {label} windows: busy share not measured")
        return {"wall_ms": wall_ms, "device_events": len(device),
                "busy_share": "not measured (the trace holds no device "
                "events or no window)"}
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in device], lo, hi)
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    by_name, by_op = {}, {}
    for e in device:
        if e.get("cat") != "kernel":
            continue
        for totals, key in ((by_name, e["name"]),
                            (by_op, ops.get(e.get("args", {}).get(
                                "External id"), e["name"]))):
            tot = totals.setdefault(key, [0.0, 0])
            tot[0] += float(e["dur"])
            tot[1] += 1
    copies = sum(n for name, (_us, n) in by_name.items()
                 if "copy" in name.lower())
    # every kernel of K1 and K2 (the D pass too), and of K3 (its merge and
    # split passes too), however small
    attention = {name: tot for name, tot in by_name.items() if re.search(
        r"flash|delta_kernel|dq_kernel|dkdv_kernel", name)}
    cross_entropy = {name: tot for name, tot in by_name.items() if re.search(
        r"ce_wgmma_kernel|ce_tf32_kernel|ce_split_kernel|ce_fwd_kernel"
        r"|ce_dlogits_kernel|ce_merge_kernel", name)}
    decode = {name: tot for name, tot in by_name.items() if re.search(
        r"paged_attend_kernel|quant_write_kernel", name)}
    rnn = {name: tot for name, tot in by_name.items() if re.search(
        r"lstm_(layer_)?(fwd|bwd)_kernel", name)}
    k6 = {name: tot for name, tot in by_name.items() if re.search(
        r"k6e_|k6d_|k6s_", name)}
    return {"wall_ms": wall_ms, "window_us": hi - lo,
            "device_busy_us": busy, "busy_share": busy / (hi - lo),
            "kernels": sum(n for _us, n in by_name.values()),
            "copy_kernels": copies, "trace": str(trace.relative_to(ROOT)),
            "top_kernels": _top(by_name, top), "top_ops": _top(by_op, top),
            "attention_kernels": _top(attention, len(attention)),
            "ce_kernels": _top(cross_entropy, len(cross_entropy)),
            "decode_kernels": _top(decode, len(decode)),
            "rnn_kernels": _top(rnn, len(rnn)),
            "k6_kernels": _top(k6, len(k6))}


def kernel_entry(path, cases, launches, masked=None):
    """The kernels-line entry of one forward kernel; ``launches`` maps each
    main path (serve, train) to its count; with ``masked`` (the attention
    phase's rows) the key-masked kernel's numbers at A1's shape."""
    rows = [r for r in cases.values() if r["path"] == path]
    main = cases[MAIN_CASE[path]]
    return {
        "name": f"flash_attention_fwd_{path}", "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[path]}",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:41",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": sum(launches.values()) > 0,
        "max_abs_err": max(r["max_abs_err_o"] for r in rows),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "at": dict(zip(("layout", "b", "h", "t_q", "t_k", "d", "dtype",
                        "causal"), MAIN_CASE[path])),
        **({"masked": masked_kernel_entry(path, masked)} if masked else {})}


def bwd_kernel_entry(path, cases, launches, masked=None):
    """The kernels-line entry of one K2 kernel ("bwd_wgmma" or "bwd"), its
    numbers at BWD_MAIN_CASE[path]. Its ``library_ms`` is SDPA's forward
    and backward, beside ``fwd_bwd_ms``: K1 + K2 on the same inputs (no
    one PyTorch call computes the backward alone; ``library_bwd_device_ms``
    is the difference of two device times)."""
    rows = [r for r in cases.values() if r["path"] == path]
    main = cases[BWD_MAIN_CASE[path]]
    return {
        "name": ("flash_attention_bwd_wgmma" if path == "bwd_wgmma"
                 else "flash_attention_bwd"), "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[path]}",
        "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:153",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": sum(launches.values()) > 0,
        "max_abs_err": max(e for r in rows
                           for e in r["max_abs_err"].values()),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_device_ms": main["library_device_ms"],
        "library_bwd_device_ms": main["library_bwd_device_ms"],
        "fwd_bwd_ms": main["fwd_bwd_ms"],
        "fwd_bwd_device_ms": main["fwd_bwd_device_ms"],
        "at": dict(zip(("layout", "b", "h", "t_q", "t_k", "d", "dtype",
                        "causal"), BWD_MAIN_CASE[path])),
        **({"masked": masked_kernel_entry(path, masked)} if masked else {})}


def ce_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K3f, K3b or the split pass, its numbers at
    CE_MAIN_CASE[kind]: "ce_fwd_wgmma" and "ce_dlogits_wgmma"
    (``chunked_ce_wgmma.cu``) at the bf16 training shape, "ce_fwd_tf32",
    "ce_dlogits_tf32" and "ce_split_tf32" (``chunked_ce_tf32.cu``) at the
    f32 one, and "ce_fwd" and "ce_dlogits" (``chunked_ce.cu``) from their
    forced run there. K3b's ``ms`` is one launch (one ce chunk);
    ``backward_ms`` is the whole chunked backward (the split, every chunk's
    K3b and its two products), the counterpart of ``library_ms``, the
    unchunked head's backward (a difference of two times). Each K3 entry
    also carries both designs' device times at its training shape, taken
    in turns; an f32 entry its bound at the FMA rate beside."""
    at = CE_MAIN_CASE[kind]
    main = cases[at]
    route = kind.rsplit("_", 1)[1] if kind.endswith(("_wgmma", "_tf32")) \
        else "mma_sync"
    source = f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}"
    if kind == "ce_split_tf32":
        sp = main["split"]
        return {
            "name": "chunked_ce_split_tf32", "route": "cuda",
            "source": source,
            # the f32 dots of _forward_pieces and _bwd, whose operands the
            # split pass prepares for the tensor cores
            "replaces": "deeplearning4j_tpu/kernels/chunked_ce.py:40",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "on_main_path": sum(launches.values()) > 0,
            "max_abs_err": 0.0 if all(r["split"]["exact"] for r in
                                      cases.values() if "split" in r)
            else None,
            "ms": sp["ms"], "device_ms": sp["device_ms"],
            "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
            "bound_by": sp["bound_by"], "library": None,
            "library_ms": None, "library_device_ms": None,
            "at": dict(zip(("n", "v", "d", "dtype", "ce_chunks"), at))}
    fwd = kind.startswith("ce_fwd")
    p = "fwd" if fwd else "dlogits"
    own = main if main["path"] == route else main[route]
    rows = [r for r in cases.values() if r["path"] == route] + [
        r[route] for r in cases.values() if route in r]
    entry = {
        "name": ("chunked_ce_fwd" if fwd else "chunked_ce_dlogits")
        + ("" if route == "mma_sync" else "_" + route),
        "route": "cuda", "source": source,
        "replaces": "deeplearning4j_tpu/kernels/chunked_ce.py:"
                    + ("40" if fwd else "85"),
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": sum(launches.values()) > 0,
        "max_abs_err": max(r["max_abs_err_lse" if fwd else
                             "max_abs_err_dlogits"] for r in rows),
        "ms": own[f"{p}_ms"], "device_ms": own[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"], "library": main["library"],
        "library_ms": main["library_ms" if fwd else "library_bwd_ms"],
        "library_device_ms": main["library_device_ms" if fwd
                                  else "library_bwd_device_ms"],
        "at": dict(zip(("n", "v", "d", "dtype", "ce_chunks"), at))}
    if f"{p}_bound_fma_ms" in main:
        entry["bound_fma_ms"] = main[f"{p}_bound_fma_ms"]
    turns = main.get("turns_device_ms")
    if turns is not None:
        entry["turns_device_ms_at_training_shape"] = turns[p]
    if not fwd and own is main:
        entry["backward_ms"] = main["backward_ms"]
        entry["backward_device_ms"] = main["backward_device_ms"]
    return entry


def moe_kernel_entry(kind, cases, launches):
    """The kernels-line entry of K7d ("moe_dispatch") or K7c
    ("moe_combine"), its numbers at MOE_CASES[0]."""
    main = cases[MOE_CASES[0]]
    p = "dispatch" if kind == "moe_dispatch" else "combine"
    return {
        "name": kind, "route": "cuda",
        "source": f"deeplearning4j_tpu_torch/kernels/csrc/{SOURCES[kind]}",
        "replaces": "deeplearning4j_tpu/parallel/moe.py:"
                    + ("132" if p == "dispatch" else "143"),
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": True,
        "max_abs_err": max(max(r["max_abs_err"][k] for k in
                               (("d_gate",) if p == "dispatch" else
                                ("combine", "dispatch_grad")))
                           for r in cases.values()),
        "ms": main[f"{p}_ms"], "device_ms": main[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"], "library": main["library"],
        "library_ms": main[f"{p}_library_ms"],
        "library_device_ms": main[f"{p}_library_device_ms"],
        "at": dict(zip(("g", "e", "c", "top_k", "d", "dtype"),
                       MOE_CASES[0]))}


# ---------------------------------------------------------------- network
# zoo ResNet-50 as benchmarks/resnet_bench.py configures it (:133-154,
# :186-190): 224x224x3, 1000 classes, batch 32, Nesterovs(0.1, 0.9),
# numpy-seeded N(0, 1) images and one-hot labels; bf16 and f32
NET_SHAPE = (224, 224, 3)
NET_CLASSES = 1000
NET_BATCH = 32
NET_LR, NET_MOMENTUM = 0.1, 0.9
NET_CHECK_BATCH = 4        # (a): the same net on the card and on the CPU
NET_FIT_STEPS = 20         # (c): bf16 steps on one fixed batch
NET_STATS_STEPS = 30       # (d): running statistics 1 - 0.9^30 = 0.96 in
NET_WARM, NET_TIMED, NET_PROFILED = 2, 5, 3
LENET_BATCH, LENET_BATCHES = 64, 20
# ResNet-50 at init is in the chaotic regime of deep BatchNormalization
# nets: its trunk gradients move far under rounding. On the CPU at 224²,
# batch 4, against f64 (PERF.md tolerance table): f32 reads |Δloss|
# 8.8e-6, probabilities 2.9e-5, the worst gradient leaf 0.032 (median
# 0.024); TF32 (conv operands rounded to 10 mantissa bits) 1.9e-4, 3.0e-2,
# 0.88; bf16 0.071, 0.115, and trunk gradients with no likeness left (1.32
# over all leaves) but the output layer's W at 0.098.
# (a) f32 on the card against the same net on the CPU, carried weights:
# two f32 computations, each that far from f64; the TF32 control must
# read above. "step" is each leaf's displacement after one step (∝ its
# gradient), "state" each BN statistic's (a forward quantity).
TOL_NET_F32 = {"probs": 1e-3, "loss": 1e-4, "grad": 0.2, "step": 0.2,
               "state": 1e-3}
# (b) bf16 against f32 on the card: the forward and the output layer's
# gradient, 3× the CPU readings (batch 32 here); the trunk's gradients
# are reported, not held (they decorrelate at init under any rounding
# coarser than f32's)
TOL_NET_BF16 = {"probs": 0.3, "loss": 0.2, "head_grad": 0.3}
# and from below: bf16 must read above (a)'s f32 rows, which two f32 runs
# meet (card vs CPU 2.56e-5 and 9.5e-7), so a bf16 policy that computed
# in f32 fails
FLOOR_NET_BF16 = {"probs": TOL_NET_F32["probs"], "loss": TOL_NET_F32["loss"]}
# (d) output() of 4 images alone against the same 4 within the batch of
# 32: inference normalizes by the running statistics, so each example's
# output is its own (f32 sums only); a forward on batch statistics is not
TOL_NET_INVARIANT = 1e-4


def rel_l2(got, want, floor=1e-30):
    """‖got − want‖ / ‖want‖ over float64 numpy copies."""
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), floor))


def tree_errors(got, want, base=None, floor=0.0):
    """{"layer/param": relative L2} over the leaves of two-level trees of
    numpy arrays; with ``base`` (the tree before a step), the errors of
    the displacements got − base against want − base. With ``floor``,
    each leaf's norm is floored at that share of the whole tree's norm (a
    leaf that is 0 in exact arithmetic reads its rounding against it)."""
    pairs = {}
    for k in sorted(want):
        for p in sorted(want[k]):
            g, w = got[k][p], want[k][p]
            if base is not None:
                g, w = g - base[k][p], w - base[k][p]
            pairs[f"{k}/{p}"] = (g, w)
    whole = math.sqrt(sum(float(np.sum(np.square(np.asarray(
        w, np.float64)))) for _, w in pairs.values()))
    return {name: rel_l2(g, w, floor=max(floor * whole, 1e-30))
            for name, (g, w) in pairs.items()}


def worst(errors):
    """(largest error, its leaf) of a ``tree_errors`` dict; (0.0, None)
    for an empty one (a net with no BN statistics)."""
    if not errors:
        return 0.0, None
    leaf = max(errors, key=errors.get)
    return errors[leaf], leaf


def rows_failed(report, rows):
    """The names of ``rows`` that ``report`` (same keys, each a number)
    reads above: an empty list passes."""
    return sorted(k for k, limit in rows.items() if not report[k] <= limit)


def floors_failed(report, floors):
    """The names of ``floors`` that ``report`` does not read above."""
    return sorted(k for k, floor in floors.items() if not report[k] > floor)


def train_mode_probs(net, x):
    """The output layer's probabilities in training mode (BatchNormalization
    on the batch's statistics; an untrained net's running statistics are
    their init, on which a deep net's outputs saturate): a graph's output
    node, a sequential net's last layer; a YOLO head's decoded
    confidences and class probabilities, flattened together."""
    acts = net.feedForward(x, train=True)
    if not isinstance(acts, dict):
        return acts[-1].float().cpu().numpy()
    name = net.conf.network_outputs[0]
    layer = net.conf.nodes[name].layer
    if hasattr(layer, "activate_detections"):
        import torch
        with torch.no_grad():
            _, _, conf, prob = layer.activate_detections(acts[name].float())
        return np.concatenate([conf.cpu().numpy().ravel(),
                               prob.cpu().numpy().ravel()])
    return acts[name].float().cpu().numpy()


def network_data(n, shape=None, classes=None, seed=SEED):
    """resnet_bench.py's data: N(0, 1) images, one-hot labels, from a
    numpy seed (default: NET_SHAPE, NET_CLASSES)."""
    shape = NET_SHAPE if shape is None else shape
    classes = NET_CLASSES if classes is None else classes
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + tuple(shape), dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def zoo_resnet(data_type):
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    return ResNet50(num_classes=NET_CLASSES, input_shape=NET_SHAPE,
                    updater=Nesterovs(NET_LR, momentum=NET_MOMENTUM),
                    data_type=data_type)


def carry_net(src, dst):
    """``dst`` gets ``src``'s params, BN states and updater state."""
    dst.set_param_tree(src.param_tree())
    dst.set_state_tree(src.state_tree())
    dst.set_updater_state(src.updater_state())


def plain_resnet50(torch, classes=None):
    """The yardstick: the same ResNet-50 (stride on the first 1x1 of a
    projection block, no conv bias, zero padding 3 before the 7x7/2 stem)
    in plain PyTorch modules: ``nn.Conv2d``, ``nn.BatchNorm2d``,
    ``nn.Linear``, channels-last memory. Never on the port's path."""
    nn = torch.nn

    def conv_bn(cin, cout, k, stride=1, pad=0):
        return [nn.Conv2d(cin, cout, k, stride, pad, bias=False),
                nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)]

    class Block(nn.Module):
        def __init__(self, cin, m, stride, project):
            super().__init__()
            self.body = nn.Sequential(
                *conv_bn(cin, m, 1, stride), nn.ReLU(inplace=True),
                *conv_bn(m, m, 3, 1, 1), nn.ReLU(inplace=True),
                *conv_bn(m, 4 * m, 1))
            self.short = (nn.Sequential(*conv_bn(cin, 4 * m, 1, stride))
                          if project else nn.Identity())

        def forward(self, x):
            return torch.relu(self.body(x) + self.short(x))

    layers = [nn.ZeroPad2d(3), *conv_bn(3, 64, 7, 2), nn.ReLU(inplace=True),
              nn.MaxPool2d(3, 2, 1)]
    cin = 64
    for m, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                              (512, 3, 2)):
        for i in range(blocks):
            layers.append(Block(cin, m, stride if i == 0 else 1, i == 0))
            cin = 4 * m
    layers += [nn.AdaptiveAvgPool2d(1), nn.Flatten()]

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = nn.Sequential(*layers)
            self.head = nn.Linear(2048, NET_CLASSES if classes is None
                                  else classes)

    return Net()


def plain_step(torch, model, opt, bf16):
    """One train step of the yardstick on NHWC batches: the trunk under
    bf16 autocast (the port's policy: hidden layers bf16, the head, loss,
    masters and updater f32), soft-label cross-entropy, SGD(Nesterov)."""
    import torch.nn.functional as F

    def step(x, y):
        xc = x.permute(0, 3, 1, 2)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            h = model.trunk(xc)
        loss = F.cross_entropy(model.head(h.float()), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss
    return step


def step_timing(torch, step):
    """Host ms per step: the median of NET_TIMED steps after NET_WARM, each
    ending in a synchronise."""
    for _ in range(NET_WARM):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(NET_TIMED):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times), times


def bn_route_inputs(torch, net, batch, dtype, dev, seed=SEED):
    """One case for each BatchNormalization of ``net`` at ``batch``: (the
    layer, an N(0, 1) NHWC input of its shape in ``dtype``, gamma and beta
    in ``dtype`` as the policy casts a hidden layer's params, its running
    statistics, an N(0, 1) upstream gradient)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, states = net.param_tree(), net.state_tree()
    cases = []
    for name in sorted(states):
        t = net.conf.activation_types[name]
        shape = (batch, t.height, t.width, t.channels)
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g, b = (params[name][p].detach().to(dtype).requires_grad_()
                for p in ("gamma", "beta"))
        cases.append((net.conf.nodes[name].layer, x.requires_grad_(), g, b,
                      states[name], dy))
    return cases


def bn_port(layer, x, g, b, state):
    """The port's route: ``BatchNormalization.apply`` in training."""
    return layer.apply({"gamma": g, "beta": b}, x, training=True,
                       state=state)


def bn_native(torch, layer, x, g, b, state):
    """The library route: ``torch.native_batch_norm`` in training with no
    running statistics (the batch's biased variance normalizes), on the
    NHWC tensor's channels-last NCHW view; the running statistics decay
    as the reference's do, from its saved mean and inverse std (var =
    invstd^-2 − eps)."""
    out, mean, invstd = torch.native_batch_norm(
        x.permute(0, 3, 1, 2), g, b, None, None, True, 0.0, layer.eps)
    var = invstd.detach().pow(-2) - layer.eps
    d = layer.decay
    return out.permute(0, 2, 3, 1), {
        "mean": d * state["mean"] + (1 - d) * mean.detach(),
        "var": d * state["var"] + (1 - d) * var}


def bn_dispatch(torch, layer, x, g, b, state):
    """``F.batch_norm`` in training with no running statistics, the
    dispatcher's choice of kernel (cuDNN's for f32); apply only, so it
    gives no running update."""
    import torch.nn.functional as F
    out = F.batch_norm(x.permute(0, 3, 1, 2), None, None, g, b, True, 0.0,
                       layer.eps)
    return out.permute(0, 2, 3, 1), state


def bn_route_agreement(torch, route, cases):
    """``route`` against the port's on the same cases: the worst relative
    L2 of the output, of dx, dgamma and dbeta, and (where ``route`` gives
    a running update) of the new running mean and var."""
    worst = {}
    for layer, x, g, b, state, dy in cases:
        res = []
        for fn in (bn_port, route):
            out, new = fn(layer, x, g, b, state)
            grads = torch.autograd.grad(out, (x, g, b), dy)
            res.append(dict(zip(("out", "dx", "dgamma", "dbeta"),
                                (out, *grads))))
            if new is not state:
                res[-1].update(mean=new["mean"], var=new["var"])
        for key, got in res[1].items():
            # on the tensors' device, in f64: 340 M activations at batch 32
            g, w = got.detach().double(), res[0][key].detach().double()
            err = float(torch.linalg.vector_norm(g - w)
                        / torch.linalg.vector_norm(w).clamp_min(1e-30))
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def bn_routes(torch, net, dtype, dev):
    """Every BatchNormalization of ResNet-50's step at NET_BATCH, forward
    and backward, by three routes in turns (port, native, dispatch,
    dispatch, native, port): ms by CUDA events (median of NET_TIMED after
    NET_WARM), device ms and kernels from a profiler window of one pass,
    and each library route's agreement with the port's."""
    tdtype = getattr(torch, dtype)
    cases = bn_route_inputs(torch, net, NET_BATCH, tdtype, dev)
    routes = {"port": bn_port,
              "native": lambda *a: bn_native(torch, *a),
              "dispatch": lambda *a: bn_dispatch(torch, *a)}

    def one_pass(fn):
        for layer, x, g, b, state, dy in cases:
            out, _new = fn(layer, x, g, b, state)
            torch.autograd.grad(out, (x, g, b), dy)

    timed = {k: [] for k in routes}
    for who in ("port", "native", "dispatch", "dispatch", "native", "port"):
        for _ in range(NET_WARM):
            one_pass(routes[who])
        for _ in range(NET_TIMED):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            one_pass(routes[who])
            end.record()
            torch.cuda.synchronize()
            timed[who].append(start.elapsed_time(end))
    out = {"dtype": dtype, "layers": len(cases), "batch": NET_BATCH}
    for who, fn in routes.items():
        p = profile_window(torch, f"bn_{who}_{dtype}",
                           lambda f=fn: one_pass(f),
                           f"bn_{who}_{dtype}_trace.json", top=4)
        out[who] = {"ms": statistics.median(timed[who]),
                    "device_ms": p.get("device_busy_us", 0) / 1e3,
                    "kernels": p.get("kernels"),
                    "top_kernels": p.get("top_kernels")}
    out["native_vs_port"] = bn_route_agreement(torch, routes["native"],
                                               cases)
    out["dispatch_vs_port"] = bn_route_agreement(torch, routes["dispatch"],
                                                 cases)
    return out


# The zoo models that with ResNet-50 make BASELINE.json's configs[1]:
# VGG16 and Darknet19 take (a), (b) and the timings; VGG19 and AlexNet (a)
# only, to keep the script inside its time limit. Each at 224², 1000
# classes, batch 32 (NET_*), its zoo updater (Nesterov; VGG and AlexNet
# lr 1e-2, Darknet19 1e-3). (a) uses ResNet-50's rows (TOL_NET_F32), (b)
# TOL_NET_BF16 and FLOOR_NET_BF16.
ZOO_FULL = ("VGG16", "Darknet19")
ZOO_CHECKED = ("VGG19", "AlexNet")
ZOO_LR = {"VGG16": 1e-2, "VGG19": 1e-2, "AlexNet": 1e-2, "Darknet19": 1e-3,
          "Xception": 1e-2, "YOLO2": 1e-3}
# The last layers' models. YOLO2 (the Darknet19 trunk, two more
# conv units, a 1x1 convolution to 5 × 25 channels and Yolo2OutputLayer
# over the VOC priors) at 416², 20 classes, batch DET_BATCH, its zoo Adam
# (1e-3), labels of 1-3 boxes an image on the 13 × 13 grid
# (``detection_data``); Xception at 299², batch XC_BATCH, its zoo
# Nesterovs(1e-2, 0.9); the other six at their zoo input sizes, check (a)
# only, at ZOO_CHECK_BATCH where the CPU side needs less than
# NET_CHECK_BATCH.
DET_SHAPE, DET_CLASSES = (416, 416, 3), 20
DET_BATCH, XC_BATCH = 16, 32
ZOO_INPUT = {"YOLO2": (DET_SHAPE, DET_CLASSES),
             "TinyYOLO": (DET_SHAPE, DET_CLASSES),
             "Xception": ((299, 299, 3), 1000),
             "SqueezeNet": ((227, 227, 3), 1000),
             "UNet": ((512, 512, 3), 1),
             "InceptionResNetV1": ((160, 160, 3), 1000),
             "NASNet": ((224, 224, 3), 1000),
             "FaceNetNN4Small2": ((96, 96, 3), 1000)}
ZOO_NEW_CHECKED = ("TinyYOLO", "SqueezeNet", "UNet", "InceptionResNetV1",
                   "NASNet", "FaceNetNN4Small2")
ZOO_CHECK_BATCH = {"YOLO2": 2, "TinyYOLO": 2, "Xception": 2, "UNet": 2}
# (a) rows of the new models and (b) rows of YOLO2 where ResNet-50's do
# not fit them; the rest take ResNet-50's (PERF.md's tolerance table). Set
# from CPU readings of ``zoo_readings`` (``--readings``, on the CPU of the
# H100's host machine). YOLO2's loss is ~120 an image
# and UNet's ~1e6 (a sum over 512² pixels), so their losses are held
# relatively. YOLO2 f32 against f64 at batch 2 read probabilities 1.7e-5,
# loss 9.5e-6 relative, worst gradient leaf 0.0036, worst step 0.18 (Adam
# turns a gradient element within rounding of 0 into a step of ±lr: its
# BN trunk's gammas), BN statistics 1.0e-5; TinyYOLO 3.4e-6, 9.5e-8,
# 0.0026, 0.051, 6.7e-6; UNet probabilities 2.0e-6, loss 1.3e-8 relative,
# gradients 2.7e-4, step 0.032. The rows sit >= 3× over two f32 runs'
# spread (2× a reading). bf16 against f32 (YOLO2, batch 2): probabilities
# 0.11, loss 5.6 % relative, the head's gradient 0.30: rows 2-3× them,
# floors at (a)'s rows.
#
# The models under Adam or RmsProp hold their step where
# ``agreed_step_errors`` says (the two gradients the steps applied agree
# within STEP_AGREE and clear STEP_CLEAR × the updater's eps): such a step
# is about ±lr for an element within rounding of 0, and lr·g / eps below
# eps, so there it magnifies rounding (UNet's every-element step read
# 0.27 card against CPU, above ResNet-50's 0.2 row, against 0.032 f32
# against f64; held where the gradients agree alone, 0.071). Masked by
# another backward pass than the step's, UNet's held step read
# 1.9e-6-3.2e-6 over four card runs, and one element of opposite sign
# alone reads 1.8e-3 in conv4_1/W. Readings of the held step, f32
# against f64: YOLO2 4.2e-6, TinyYOLO 3.1e-6, UNet 1.6e-6, NASNet
# 2.4e-5, FaceNetNN4Small2 3.0e-5 (rows 1e-3), InceptionResNetV1 6.4e-3
# (RmsProp's first step lr·g / (0.22·|g| + eps) keeps ~eps / (0.22·|g|)
# of the gradient's error: row 0.05); 0.5-5.7 % of the elements left out
# (UNet's most, below eps): at most 20 % may be. NASNet's BN statistics
# read 1.4e-3 with its floor.
_AGREED = {"step": 1e-3, "step_left_out": 0.2}
TOL_YOLO_F32 = {"probs": 1e-4, "loss_rel": 1e-4, "grad": 0.05,
                "state": 1e-4, **_AGREED}
TOL_ZOO_F32 = {"YOLO2": TOL_YOLO_F32, "TinyYOLO": TOL_YOLO_F32,
               "UNet": {**{k: v for k, v in TOL_NET_F32.items()
                           if k != "loss"}, "loss_rel": 1e-5, **_AGREED},
               "NASNet": {**TOL_NET_F32, "state": 1e-2, **_AGREED},
               "FaceNetNN4Small2": {**TOL_NET_F32, **_AGREED},
               "InceptionResNetV1": {**TOL_NET_F32, **_AGREED,
                                     "step": 0.05}}
TOL_ZOO_BF16 = {"YOLO2": {"probs": 0.3, "loss_rel": 0.2, "head_grad": 0.6}}
FLOOR_ZOO_BF16 = {"YOLO2": {"probs": TOL_YOLO_F32["probs"],
                            "loss_rel": TOL_YOLO_F32["loss_rel"]}}
# NASNet feeds each cell's output to the next cell's 1x1 convolution and
# BatchNormalization, which takes out any shift a channel has: the
# gradients of the BN shifts ahead of it (betas) and the displacement of
# such a BN's running mean are 0 in exact arithmetic, and f32 against f64
# read them at 7.6e8 relative (the median leaf 0.0029). Its
# leaves' norms are floored at 1e-5 of their tree's.
ZOO_FLOOR = {"NASNet": 1e-5}
# the gradients' agreement and the multiple of the updater's eps under
# which an element-scaled updater's step is held (``agreed_step_errors``)
STEP_AGREE, STEP_CLEAR = 0.1, 100


def zoo_model(name, data_type):
    """A zoo model at its input size and class count (``ZOO_INPUT``, else
    224² and 1000 classes)."""
    from deeplearning4j_tpu_torch.models import zoo
    shape, classes = ZOO_INPUT.get(name, (NET_SHAPE, NET_CLASSES))
    return getattr(zoo, name)(num_classes=classes, input_shape=shape,
                              data_type=data_type)


def detection_data(n, shape=DET_SHAPE, classes=DET_CLASSES, seed=SEED):
    """N(0, 1) images and YOLO labels (N, H/32, W/32, 4 + C) from a numpy
    seed: 1-3 boxes an image, each in a cell of its own with its center in
    that cell, 0.5-6 cells a side, x1, y1, x2, y2 in grid units, and a
    class one-hot."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + tuple(shape), dtype=np.float32)
    gh, gw = shape[0] // 32, shape[1] // 32
    y = np.zeros((n, gh, gw, 4 + classes), np.float32)
    for ex in range(n):
        for cell in rng.choice(gh * gw, size=int(rng.integers(1, 4)),
                               replace=False):
            i, j = divmod(int(cell), gw)
            cx, cy = j + rng.uniform(), i + rng.uniform()
            bw, bh = rng.uniform(0.5, 6.0, 2)
            y[ex, i, j, :4] = (cx - bw / 2, cy - bh / 2, cx + bw / 2,
                               cy + bh / 2)
            y[ex, i, j, 4 + int(rng.integers(0, classes))] = 1.0
    return x, y


def zoo_data(name, n, seed=SEED):
    """A zoo model's data at its input size: ``network_data``'s images and
    one-hot labels; YOLO labels (``detection_data``); UNet a binary mask
    a pixel."""
    shape, classes = ZOO_INPUT.get(name, (NET_SHAPE, NET_CLASSES))
    if name in ("YOLO2", "TinyYOLO"):
        return detection_data(n, shape, classes, seed)
    x, y = network_data(n, shape, classes, seed)
    if name == "UNet":
        rng = np.random.default_rng(seed + 1)
        y = (rng.uniform(size=(n,) + tuple(shape[:2]) + (1,)) < 0.5).astype(
            np.float32)
    return x, y


@contextlib.contextmanager
def shared_dropout():
    """The port's dropout drawing each mask from a CPU generator seeded
    afresh at every call (so a mask depends on its shape alone), moved to
    the activation's device: check (a)'s card and CPU nets drop the same
    units (VGG's and AlexNet's dense layers)."""
    import torch
    from deeplearning4j_tpu_torch.ops import standard
    plain = standard.dropout_inverted

    def same(x, gen, p=0.5):
        g = torch.Generator().manual_seed(SEED)
        keep = (torch.rand(x.shape, generator=g) < p).to(x.device)
        return torch.where(keep, x / p, torch.zeros_like(x))

    standard.dropout_inverted = same
    try:
        yield
    finally:
        standard.dropout_inverted = plain


def head_key(net):
    """The output layer's key in a net's param tree; for an output layer
    without params (a YOLO head, a LossLayer) the layer before it."""
    layers = getattr(net, "layers", None)
    if layers is not None:
        return str(len(layers) - 1)
    name = net.conf.network_outputs[0]
    if not net.param_tree().get(name):
        name = net.conf.nodes[name].inputs[0]
    return name


def elementwise(net):
    """The eps of ``net``'s updater where it scales each element's step by
    the element's own history (Adam, RmsProp and the like); None for plain
    SGD or Nesterov."""
    u = net.conf.updater
    if type(u).__name__ in ("Sgd", "Nesterovs", "NoOp"):
        return None
    return float(getattr(u, "epsilon", 0.0))


def zoo_run(net, x, y):
    """Check (a)'s readings of one net: training-mode probabilities, the
    loss and gradients, then the params and BN statistics after one step
    (numpy), and the gradients that step applied ("step_grads"): a second
    backward pass, which on the card may round otherwise than the first
    (atomic sums)."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    out = {"probs": train_mode_probs(net, x),
           "states0": tree_to_numpy(net.state_tree())}
    out["loss"], grads = net.computeGradientAndScore(x, y)
    out["grads"] = tree_to_numpy(grads)
    seen = []
    plain = net._value_and_grad

    def recorded(*a, **kw):
        res = plain(*a, **kw)
        seen.append(res)
        return res

    net._value_and_grad = recorded
    try:
        net.fit(x, y)
    finally:
        del net._value_and_grad
    (_, _, _, keys, _, step_grads), = seen
    out["step_grads"] = {k: {} for k in out["grads"]}
    for (k, p), g in zip(keys, step_grads):
        out["step_grads"][k][p] = g.detach().cpu().numpy()
    out["params"] = tree_to_numpy(net.param_tree())
    out["states"] = tree_to_numpy(net.state_tree())
    return out


def agreed_step_errors(got, want, base, eps):
    """{"layer/param": relative L2} of one step's displacements over the
    elements whose two gradients agree within STEP_AGREE and clear the
    updater's ``eps`` STEP_CLEAR times; and the share of the elements left
    out. An updater that scales each element (Adam's, RmsProp's first
    step: lr·g / (|g| + eps)) moves an element by ±lr whatever its size,
    so one within rounding of 0 moves ±lr on either side at random; and
    one below eps moves by lr·g / eps, its gradient's rounding magnified
    1/eps times. Where neither holds the step's relative error is at most
    STEP_AGREE / STEP_CLEAR. The gradients are those the step applied
    ("step_grads"). In a leaf of n elements that each move by about lr,
    one element that moves +lr on one side and −lr on the other reads
    2 / √n alone, over a 1e-3 row wherever n < 4e6 (UNet's conv4_1/W:
    1.18e6); so a mask taken from another backward pass, whose rounding
    may differ on the card (atomic sums), can let such an element in."""
    errs, out, total = {}, 0, 0
    for k in sorted(want["params"]):
        for p in sorted(want["params"][k]):
            gg, gw = got["step_grads"][k][p], want["step_grads"][k][p]
            keep = ((np.abs(gg - gw) <= STEP_AGREE * np.abs(gw))
                    & (np.abs(gw) >= STEP_CLEAR * eps))
            dg = (got["params"][k][p] - base[k][p])[keep]
            dw = (want["params"][k][p] - base[k][p])[keep]
            errs[f"{k}/{p}"] = rel_l2(dg, dw)
            out += int(keep.size - keep.sum())
            total += int(keep.size)
    return errs, out / max(total, 1)


def zoo_compare(got, want, base, floor=0.0, elementwise=None):
    """Check (a)'s rows of ``got`` against ``want`` (two ``zoo_run``s from
    the same params ``base``): the probabilities' relative L2, |Δloss| and
    its relative size, the worst gradient leaf (and the median), the
    worst param displacement and the worst BN statistic's, each leaf's
    norm floored at ``floor`` of its tree's (``tree_errors``). Under an
    updater that scales each element (``elementwise``: its eps, or None)
    the step is held where ``agreed_step_errors`` says, the step over
    every element reported as "step_all", and held where the gradients
    of the other backward pass agree as "step_other_pass"."""
    g_err = tree_errors(got["grads"], want["grads"], floor=floor)
    s_err = tree_errors(got["params"], want["params"], base=base,
                        floor=floor)
    st_err = tree_errors(got["states"], want["states"],
                         base=want["states0"], floor=floor)
    extra = {}
    if elementwise is not None:
        drift = worst(tree_errors(got["step_grads"], got["grads"]))
        extra = {"step_all": worst(s_err)[0], "step_all_leaf": worst(s_err)[1],
                 "step_grad_drift": drift[0],
                 "step_grad_drift_leaf": drift[1]}
        s_err, extra["step_left_out"] = agreed_step_errors(
            got, want, base, elementwise)
        # the same step masked by the other backward pass's gradients
        other = agreed_step_errors({**got, "step_grads": got["grads"]},
                                   {**want, "step_grads": want["grads"]},
                                   base, elementwise)[0]
        extra["step_other_pass"] = worst(other)[0]
    return {**extra, "probs": rel_l2(got["probs"], want["probs"]),
            "loss": abs(got["loss"] - want["loss"]),
            "loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad": worst(g_err)[0], "grad_leaf": worst(g_err)[1],
            "grad_median": float(np.median(list(g_err.values()))),
            "step": worst(s_err)[0], "step_leaf": worst(s_err)[1],
            "state": worst(st_err)[0], "state_leaf": worst(st_err)[1]}


def zoo_card_vs_cpu(torch, name, dev, xs, ys):
    """Check (a) of one zoo model: f32 on the card against the same net on
    the CPU (batch NET_CHECK_BATCH, or the model's ZOO_CHECK_BATCH),
    carried weights, the same dropout masks, under the model's rows
    (TOL_ZOO_F32, else TOL_NET_F32)."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    with shared_dropout():
        cpu = zoo_model(name, "float32").init_model(device="cpu")
        base = tree_to_numpy(cpu.param_tree())
        card = zoo_model(name, "float32").init_model(device=dev)
        carry_net(cpu, card)
        cpu_out = zoo_run(cpu, xs, ys)
        rep = zoo_compare(zoo_run(card, xs, ys), cpu_out, base,
                          ZOO_FLOOR.get(name, 0.0), elementwise(cpu))
    rows = TOL_ZOO_F32.get(name, TOL_NET_F32)
    failed = rows_failed(rep, rows)
    emit(zoo_card_vs_cpu={"model": name, "batch": len(xs), **rep},
         rows=rows, failed=failed)
    check(not failed, f"(a) {name} f32 card vs CPU above its rows: {failed}")
    del cpu, card
    torch.cuda.empty_cache()


def zoo_bf16_vs_f32(torch, name, dev, x, y):
    """Check (b) of one zoo model: bf16 against f32 on the card at
    NET_BATCH, the same weights and dropout masks."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    with shared_dropout():
        f32_net = zoo_model(name, "float32").init_model(device=dev)
        bf16_net = zoo_model(name, "bfloat16").init_model(device=dev)
        carry_net(f32_net, bf16_net)
        l32, g32 = f32_net.computeGradientAndScore(x, y)
        l16, g16 = bf16_net.computeGradientAndScore(x, y)
        head = head_key(f32_net)
        g32, g16 = tree_to_numpy(g32), tree_to_numpy(g16)
        rep = {"probs": rel_l2(train_mode_probs(bf16_net, x),
                               train_mode_probs(f32_net, x)),
               "loss": abs(l16 - l32), "loss_rel": abs(l16 - l32) / abs(l32),
               "head_grad": rel_l2(g16[head]["W"], g32[head]["W"]),
               "worst_grad_leaf": worst(tree_errors(g16, g32))}
    rows = TOL_ZOO_BF16.get(name, TOL_NET_BF16)
    floors = FLOOR_ZOO_BF16.get(name, FLOOR_NET_BF16)
    failed = rows_failed(rep, rows)
    too_close = floors_failed(rep, floors)
    emit(zoo_bf16_vs_f32={"model": name, "batch": len(x), **rep},
         rows=rows, failed=failed, floors=floors, floors_failed=too_close)
    check(not failed, f"(b) {name} bf16 vs f32 above its rows: {failed}")
    check(not too_close, f"(b) {name} bf16 reads as close to f32 as f32 "
          f"does: {too_close}")
    del f32_net, bf16_net
    torch.cuda.empty_cache()


def _twin(torch, trunk, head):
    """A plain-PyTorch net as ``plain_step`` takes it: ``trunk`` and
    ``head`` modules."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk, self.head = trunk, head
    return Net()


def plain_vgg(torch, name):
    """VGG16 / VGG19 in plain modules: 3x3 ``nn.Conv2d`` (padding 1) and
    ReLU, 2x2 max pools, then dropout (p 0.5) before each dense layer of
    4096 (the port drops a dense layer's input), the ``nn.Linear`` head."""
    from deeplearning4j_tpu_torch.models.zoo import vgg
    nn = torch.nn
    layers, cin = [], 3
    for n_convs, cout in (vgg._VGG16_BLOCKS if name == "VGG16"
                          else vgg._VGG19_BLOCKS):
        for _ in range(n_convs):
            layers += [nn.Conv2d(cin, cout, 3, padding=1),
                       nn.ReLU(inplace=True)]
            cin = cout
        layers.append(nn.MaxPool2d(2, 2))
    side = NET_SHAPE[0] // 32
    layers += [nn.Flatten(), nn.Dropout(0.5),
               nn.Linear(512 * side * side, 4096), nn.ReLU(inplace=True),
               nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(inplace=True)]
    return _twin(torch, nn.Sequential(*layers), nn.Linear(4096, NET_CLASSES))


#: Darknet19's trunk: conv units (out channels, or (out, kernel)), "M" a
#: 2x2/2 max pool
DARKNET19_PLAN = [32, "M", 64, "M", 128, (64, 1), 128, "M", 256, (128, 1),
                  256, "M", 512, (256, 1), 512, (256, 1), 512, "M", 1024,
                  (512, 1), 1024, (512, 1), 1024]


def _dark_units(torch, plan):
    """(modules, out channels) of bias-free ``nn.Conv2d`` ("same"),
    ``nn.BatchNorm2d`` and LeakyReLU(0.1) units and 2x2 max pools."""
    nn = torch.nn
    layers, cin = [], 3
    for p in plan:
        if p == "M":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        cout, k = p if isinstance(p, tuple) else (p, 3)
        layers += [nn.Conv2d(cin, cout, k, padding=k // 2, bias=False),
                   nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1),
                   nn.LeakyReLU(0.1, inplace=True)]
        cin = cout
    return layers, cin


def plain_darknet19(torch):
    """Darknet19 in plain modules: the trunk's units, a 1x1 convolution to
    the classes, global average pooling, the ``nn.Linear`` output."""
    nn = torch.nn
    layers, cin = _dark_units(torch, DARKNET19_PLAN)
    layers += [nn.Conv2d(cin, NET_CLASSES, 1), nn.AdaptiveAvgPool2d(1),
               nn.Flatten()]
    return _twin(torch, nn.Sequential(*layers),
                 nn.Linear(NET_CLASSES, NET_CLASSES))


def plain_yolo2(torch, priors=5, classes=DET_CLASSES):
    """YOLO2 in plain modules: Darknet19's trunk and two more 3x3 units of
    1024, then the 1x1 ``nn.Conv2d`` head to priors · (5 + C) channels."""
    nn = torch.nn
    layers, cin = _dark_units(torch, DARKNET19_PLAN + [1024, 1024])
    return _twin(torch, nn.Sequential(*layers),
                 nn.Conv2d(cin, priors * (5 + classes), 1))


def plain_yolo_loss(torch, out, labels, priors, lambda_coord=5.0,
                    lambda_no_obj=0.5):
    """The YOLOv2 loss of NHWC activations written plainly: the twin's
    loss, the same terms as ``Yolo2OutputLayer.loss``."""
    n, h, w, _ = out.shape
    b = len(priors)
    t = out.reshape(n, h, w, b, -1)
    anchors = torch.tensor(priors, dtype=out.dtype, device=out.device)
    gy, gx = torch.meshgrid(torch.arange(h, device=out.device),
                            torch.arange(w, device=out.device),
                            indexing="ij")
    grid = torch.stack([gx, gy], -1).to(out.dtype)[None, :, :, None]
    xy = torch.sigmoid(t[..., 0:2]) + grid
    wh = torch.exp(t[..., 2:4]) * anchors
    conf = torch.sigmoid(t[..., 4])
    prob = torch.softmax(t[..., 5:], dim=-1)
    box, cls = labels[..., :4], labels[..., 4:]
    obj = (cls.sum(-1) > 0).to(out.dtype)
    gwh = box[..., 2:4] - box[..., 0:2]
    gxy = 0.5 * (box[..., 0:2] + box[..., 2:4])
    inter = torch.minimum(anchors, gwh[..., None, :]).prod(-1)
    iou_p = inter / (anchors.prod(-1) + gwh.prod(-1)[..., None] - inter
                     ).clamp_min(1e-9)
    resp = torch.nn.functional.one_hot(iou_p.argmax(-1), b).to(out.dtype)
    resp = resp * obj[..., None]
    coord = ((xy - gxy[..., None, :]) ** 2).sum(-1) + (
        (wh.clamp_min(1e-9).sqrt() - gwh.clamp_min(0).sqrt()[..., None, :])
        ** 2).sum(-1)
    lo = torch.maximum(xy - wh / 2, box[..., None, 0:2])
    hi = torch.minimum(xy + wh / 2, box[..., None, 2:4])
    i2 = (hi - lo).clamp_min(0).prod(-1)
    iou = i2 / (wh.prod(-1) + gwh.clamp_min(0).prod(-1)[..., None] - i2
                ).clamp_min(1e-9)
    return (lambda_coord * (coord * resp).sum()
            + ((conf - iou) ** 2 * resp).sum()
            + lambda_no_obj * (conf ** 2 * (1 - resp)).sum()
            + ((prob - cls[..., None, :]) ** 2 * resp[..., None]).sum()) / n


def plain_yolo_step(torch, model, opt, bf16):
    """One train step of the YOLO2 twin on NHWC batches: trunk and head
    under bf16 autocast (the port's policy: hidden layers bf16, the YOLO
    loss f32), the plain loss, the optimizer."""
    from deeplearning4j_tpu_torch.models.zoo.darknet import _YOLO2_PRIORS

    def step(x, y):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            h = model.head(model.trunk(x.permute(0, 3, 1, 2)))
        loss = plain_yolo_loss(torch, h.float().permute(0, 2, 3, 1), y,
                               _YOLO2_PRIORS)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss
    return step


def plain_xception(torch, classes=NET_CLASSES):
    """Xception in plain modules: separable convolutions as a depthwise
    ``nn.Conv2d`` (groups = channels) and a 1x1 one, ``nn.BatchNorm2d``,
    ReLU, 3x3/2 max pools and 1x1/2 projections on the residual adds; the
    port's block plan (entry 128/256/728, 8 middle blocks, exit 1024,
    then 1536 and 2048), global average pooling, the ``nn.Linear`` head."""
    nn = torch.nn

    def sep(cin, cout, pre=False, post=False):
        return nn.Sequential(
            *([nn.ReLU()] if pre else []),
            nn.Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False),
            nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout),
            *([nn.ReLU()] if post else []))

    class Reduce(nn.Module):
        def __init__(self, cin, c1, c2, pre):
            super().__init__()
            self.body = nn.Sequential(sep(cin, c1, pre, True), sep(c1, c2),
                                      nn.MaxPool2d(3, 2, 1))
            self.res = nn.Sequential(nn.Conv2d(cin, c2, 1, 2, bias=False),
                                     nn.BatchNorm2d(c2))

        def forward(self, x):
            return self.body(x) + self.res(x)

    class Middle(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(*[sep(728, 728, pre=True)
                                        for _ in range(3)])

        def forward(self, x):
            return self.body(x) + x

    layers = [nn.Conv2d(3, 32, 3, 2, bias=False), nn.BatchNorm2d(32),
              nn.ReLU(), nn.Conv2d(32, 64, 3, bias=False),
              nn.BatchNorm2d(64), nn.ReLU(),
              Reduce(64, 128, 128, False), Reduce(128, 256, 256, True),
              Reduce(256, 728, 728, True), *[Middle() for _ in range(8)],
              Reduce(728, 728, 1024, True), sep(1024, 1536, post=True),
              sep(1536, 2048, post=True), nn.AdaptiveAvgPool2d(1),
              nn.Flatten()]
    return _twin(torch, nn.Sequential(*layers), nn.Linear(2048, classes))


def plain_twin(torch, name, dev, bf16):
    """(module, step) of a zoo model's plain-PyTorch twin on ``dev``, in
    channels-last memory: SGD(Nesterov) at the zoo's lr and momentum and
    cross-entropy (``plain_step``), or for YOLO2 the zoo's Adam and the
    YOLO loss written plainly (``plain_yolo_step``)."""
    if name == "YOLO2":
        twin = plain_yolo2(torch).to(dev).to(memory_format=torch.channels_last)
        opt = torch.optim.Adam(twin.parameters(), lr=ZOO_LR[name],
                               betas=(0.9, 0.999), eps=1e-8)
        return twin, plain_yolo_step(torch, twin, opt, bf16)
    make = {"Darknet19": plain_darknet19,
            "Xception": plain_xception}.get(name)
    twin = (make(torch) if make is not None else plain_vgg(torch, name))
    twin = twin.to(dev).to(memory_format=torch.channels_last)
    opt = torch.optim.SGD(twin.parameters(), lr=ZOO_LR[name],
                          momentum=NET_MOMENTUM, nesterov=True)
    return twin, plain_step(torch, twin, opt, bf16)


def zoo_timing(torch, name, dev, xd, yd, smi):
    """Host ms a step, images/s, device ms, busy share, kernels a step
    (a profiler window of NET_PROFILED steps) and own peak memory of one
    zoo model in bf16 and f32 at the batch of ``xd``, in turns with its
    plain twin (port, plain, plain, port; ``plain_twin``)."""
    rows = []
    batch = int(xd.shape[0])
    for dtype in ("bfloat16", "float32"):
        bf16 = dtype == "bfloat16"
        net = zoo_model(name, dtype).init_model(device=dev)
        twin, tstep = plain_twin(torch, name, dev, bf16)
        runs = {"port": lambda: net.fit(xd, yd),
                "plain": lambda: tstep(xd, yd)}
        timed, peaks = {"port": [], "plain": []}, {}
        for who in ("port", "plain", "plain", "port"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms, _all = step_timing(torch, runs[who])
            peaks[who] = max(peaks.get(who, 0),
                             torch.cuda.max_memory_allocated() - before)
            timed[who].append(ms)
        flops = net.step_cost(batch)[0]
        for who in ("port", "plain"):
            p = profile_window(
                torch, f"zoo_{name}_{who}_{dtype}",
                lambda f=runs[who]: [f() for _ in range(NET_PROFILED)],
                f"zoo_{name}_{who}_{dtype}_trace.json", top=12)
            ms = statistics.median(timed[who])
            busy = p.get("device_busy_us")
            rows.append({
                "net": name, "model": who, "dtype": dtype, "gpu": smi,
                "batch": batch,
                "host_ms_per_step": ms, "turns_ms": timed[who],
                "images_per_s": batch / (ms / 1e3),
                "tflops_per_s": flops / (ms / 1e3) / 1e12,
                "device_ms_per_step": (busy / 1e3 / NET_PROFILED
                                       if busy is not None else None),
                "busy_share": p.get("busy_share"),
                "kernels_per_step": (p["kernels"] / NET_PROFILED
                                     if "kernels" in p else None),
                "own_peak_bytes": peaks[who],
                "top_ops": p.get("top_ops"),
                "top_kernels": p.get("top_kernels")})
        del net, twin, tstep, runs
        torch.cuda.empty_cache()
    for r in rows:
        emit(zoo_timing=r)
    return rows


def zoo_phase(torch, dev, x, y, smi):
    """(a) of every zoo model of ZOO_FULL and ZOO_CHECKED, then (b) and
    the timings of ZOO_FULL's; then Xception's (a) at batch 2, (b) at
    XC_BATCH and timings, and (a) of ZOO_NEW_CHECKED's at their zoo input
    sizes (YOLO2's are the detection phase's)."""
    xs, ys = x[:NET_CHECK_BATCH], y[:NET_CHECK_BATCH]
    for name in ZOO_FULL + ZOO_CHECKED:
        zoo_card_vs_cpu(torch, name, dev, xs, ys)
        torch.cuda.empty_cache()
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev)
    rows = {}
    for name in ZOO_FULL:
        zoo_bf16_vs_f32(torch, name, dev, x, y)
        rows[name] = zoo_timing(torch, name, dev, xd, yd, smi)
    del xd, yd
    xx, xy = zoo_data("Xception", XC_BATCH)
    n = ZOO_CHECK_BATCH["Xception"]
    zoo_card_vs_cpu(torch, "Xception", dev, xx[:n], xy[:n])
    zoo_bf16_vs_f32(torch, "Xception", dev, xx, xy)
    rows["Xception"] = zoo_timing(torch, "Xception", dev,
                                  torch.as_tensor(xx, device=dev),
                                  torch.as_tensor(xy, device=dev), smi)
    torch.cuda.empty_cache()
    for name in ZOO_NEW_CHECKED:
        zoo_card_vs_cpu(torch, name, dev,
                        *zoo_data(name, ZOO_CHECK_BATCH.get(
                            name, NET_CHECK_BATCH)))
    return rows


def network_phase(torch):
    """The DL4J network stack on the card (see NET_* above): checks (a)-(d)
    of PERF.md's network rows, then the timings of ResNet-50 in bf16 and
    f32 in turns with the plain-PyTorch yardstick, then LeNet through
    ``MultiLayerNetwork`` over a prefetching iterator. Returns the port
    kernels' launches over these paths (all must be 0)."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.data import (DataSet,
                                               DevicePrefetchIterator,
                                               ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    reset_all_counts()
    x, y = network_data(NET_BATCH)
    xs, ys = x[:NET_CHECK_BATCH], y[:NET_CHECK_BATCH]
    out = {}

    # (a) f32 on the card against the same net on the CPU
    cpu = zoo_resnet("float32").init_model(device="cpu")
    fresh = zoo_resnet("float32").init_model(device="cpu")
    base = tree_to_numpy(cpu.param_tree())
    cpu_out = zoo_run(cpu, xs, ys)
    reports = {}
    for label, tf32 in (("f32", False), ("tf32_control", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            card = zoo_resnet("float32").init_model(device=dev)
            torch.backends.cudnn.allow_tf32 = tf32   # init pins it off
            carry_net(fresh, card)
            reports[label] = zoo_compare(zoo_run(card, xs, ys), cpu_out,
                                         base)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        del card
    failed = rows_failed(reports["f32"], TOL_NET_F32)
    control = rows_failed(reports["tf32_control"], TOL_NET_F32)
    emit(network_card_vs_cpu=reports, rows=TOL_NET_F32, failed=failed,
         control_failed=control)
    check(not failed, f"(a) f32 card vs CPU above its rows: {failed}")
    check(bool(control), "(a) the TF32 control passed the f32 rows: they "
          "cannot tell TF32 from f32")
    del cpu, fresh, cpu_out

    # (d) inference uses the running statistics. A net whose updater is
    # NoOp fits the batch of 32 NET_STATS_STEPS times: its params stay and
    # its running statistics approach the batch's. Then 4 images alone and
    # the same 4 within the 32 give the same outputs, and a forward on the
    # 4 images' own batch statistics does not.
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.optim.updaters import NoOp
    stats_net = ResNet50(num_classes=NET_CLASSES, input_shape=NET_SHAPE,
                         updater=NoOp()).init_model(device=dev)
    w0 = stats_net.param_tree()["conv1"]["W"].clone()
    for _ in range(NET_STATS_STEPS):
        stats_net.fit(x, y)
    alone = stats_net.output(xs)
    within = stats_net.output(x)[:NET_CHECK_BATCH]
    batch_stats = stats_net.feedForward(xs, train=True)["output"]
    inv = rel_l2(within.cpu().numpy(), alone.cpu().numpy())
    off = rel_l2(batch_stats.cpu().numpy(), alone.cpu().numpy())
    same_w = bool(torch.equal(stats_net.param_tree()["conv1"]["W"], w0))
    emit(network_inference_uses_running_stats={
        "alone_vs_within_batch": inv, "batch_stats_vs_running": off,
        "row": TOL_NET_INVARIANT, "params_unchanged": same_w})
    check(same_w and inv <= TOL_NET_INVARIANT < off,
          f"(d) output() is not per-example on running statistics: "
          f"{inv}, batch statistics {off}, params kept {same_w}")
    del stats_net

    # (b) bf16 against f32 on the card, full batch, the same weights
    f32_net = zoo_resnet("float32").init_model(device=dev)
    bf16_net = zoo_resnet("bfloat16").init_model(device=dev)
    carry_net(f32_net, bf16_net)
    l32, g32 = f32_net.computeGradientAndScore(x, y)
    l16, g16 = bf16_net.computeGradientAndScore(x, y)
    g32, g16 = tree_to_numpy(g32), tree_to_numpy(g16)
    flat = lambda g: np.concatenate([g[k][p].ravel() for k in sorted(g)
                                     for p in sorted(g[k])])
    g_err = tree_errors(g16, g32)
    rep_b = {"probs": rel_l2(train_mode_probs(bf16_net, x),
                             train_mode_probs(f32_net, x)),
             "loss": abs(l16 - l32),
             "head_grad": rel_l2(g16["output"]["W"], g32["output"]["W"]),
             "grad_all_leaves": rel_l2(flat(g16), flat(g32)),
             "worst_grad_leaf": worst(g_err)}
    failed = rows_failed(rep_b, TOL_NET_BF16)
    too_close = floors_failed(rep_b, FLOOR_NET_BF16)
    emit(network_bf16_vs_f32=rep_b, rows=TOL_NET_BF16, failed=failed,
         floors=FLOOR_NET_BF16, floors_failed=too_close)
    check(not failed, f"(b) bf16 vs f32 above its rows: {failed}")
    check(not too_close, f"(b) bf16 reads as close to f32 as f32 does: "
          f"{too_close}")
    del f32_net, g32, g16
    torch.cuda.empty_cache()

    # (c) 20 bf16 steps on one fixed batch
    bf16_net.score_every = 1
    losses = []
    mean0 = bf16_net.state_tree()["conv1_bn"]["mean"].clone()
    for _ in range(NET_FIT_STEPS):
        bf16_net.fit(x, y)
        losses.append(bf16_net.score())
    moved = float((bf16_net.state_tree()["conv1_bn"]["mean"]
                   - mean0).abs().max())
    ev = bf16_net.evaluate(ListDataSetIterator([DataSet(x, y)]))
    emit(network_fit_losses=losses, bn_mean_moved=moved,
         evaluate_accuracy=ev.accuracy())
    check(all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0] and min(losses[-5:]) < losses[0],
          f"(c) 20 bf16 steps: the loss did not fall: {losses}")
    check(moved > 0, "(c) the BN running statistics did not move")
    del bf16_net
    torch.cuda.empty_cache()

    # timings: the port and the yardstick in turns (port, plain, plain,
    # port), bf16 then f32; a profiler window of 3 steps of each
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev)
    rows, bn_rows = [], []
    for dtype in ("bfloat16", "float32"):
        bf16 = dtype == "bfloat16"
        net = zoo_resnet(dtype).init_model(device=dev)
        twin = plain_resnet50(torch).to(dev).to(
            memory_format=torch.channels_last)
        opt = torch.optim.SGD(twin.parameters(), lr=NET_LR,
                              momentum=NET_MOMENTUM, nesterov=True)
        runs = {"port": lambda: net.fit(xd, yd),
                "plain": plain_step(torch, twin, opt, bf16)}
        runs["plain"] = (lambda s=runs["plain"]: s(xd, yd))
        timed = {"port": [], "plain": []}
        peaks = {}
        for who in ("port", "plain", "plain", "port"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms, _all = step_timing(torch, runs[who])
            peaks[who] = max(peaks.get(who, 0),
                             torch.cuda.max_memory_allocated() - before)
            timed[who].append(ms)
        prof = {who: profile_window(
            torch, f"network_{who}_{dtype}",
            lambda f=runs[who]: [f() for _ in range(NET_PROFILED)],
            f"network_{who}_{dtype}_trace.json", top=12)
            for who in ("port", "plain")}
        flops = net.step_cost(NET_BATCH)[0]
        for who in ("port", "plain"):
            ms = statistics.median(timed[who])
            p = prof[who]
            dev_ms = (p["device_busy_us"] / 1e3 / NET_PROFILED
                      if "device_busy_us" in p else None)
            rows.append({
                "model": who, "dtype": dtype, "gpu": smi,
                "host_ms_per_step": ms, "turns_ms": timed[who],
                "images_per_s": NET_BATCH / (ms / 1e3),
                "tflops_per_s": flops / (ms / 1e3) / 1e12,
                "device_ms_per_step": dev_ms,
                "busy_share": p.get("busy_share"),
                "kernels_per_step": (p["kernels"] / NET_PROFILED
                                     if "kernels" in p else None),
                "own_peak_bytes": peaks[who],
                "top_ops": p.get("top_ops"),
                "top_kernels": p.get("top_kernels")})
        del twin, opt, runs
        torch.cuda.empty_cache()
        bn_rows.append(bn_routes(torch, net, dtype, dev))
        del net
        torch.cuda.empty_cache()
    for r in rows:
        emit(network_timing=r)
    for r in bn_rows:
        emit(network_bn_routes=r)
    out["resnet50"] = rows
    out["zoo"] = zoo_phase(torch, dev, x, y, smi)

    # LeNet through MultiLayerNetwork: fit over a ListDataSetIterator
    # through DevicePrefetchIterator, then output and evaluate
    lx, ly = network_data(LENET_BATCH * LENET_BATCHES, shape=(28, 28, 1),
                          classes=10, seed=SEED + 1)
    batches = [DataSet(lx[i:i + LENET_BATCH], ly[i:i + LENET_BATCH])
               for i in range(0, len(lx), LENET_BATCH)]
    lenet = LeNet().init_model(device=dev)
    it = DevicePrefetchIterator(ListDataSetIterator(batches), device=dev)
    lenet.fit(it, epochs=1)                  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    lenet.fit(it, epochs=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t
    probs = lenet.output(lx[:LENET_BATCH])
    acc = lenet.evaluate(ListDataSetIterator(batches)).accuracy()
    lenet_row = {"gpu": smi, "batch": LENET_BATCH, "batches": len(batches),
                 "images_per_s": len(lx) / epoch_s,
                 "ms_per_step": 1e3 * epoch_s / len(batches),
                 "score": lenet.score(), "evaluate_accuracy": acc,
                 "output_shape": list(probs.shape)}
    emit(network_lenet=lenet_row)
    check(tuple(probs.shape) == (LENET_BATCH, 10)
          and bool(torch.isfinite(probs).all())
          and math.isfinite(lenet_row["score"]),
          f"LeNet: output {tuple(probs.shape)}, score {lenet_row['score']}")
    del lenet, it
    torch.cuda.empty_cache()
    launches = all_counts()
    emit(network_phase_seconds=time.perf_counter() - t_phase,
         network_launches=dict(zip(ALL_KERNELS, launches)))
    return launches


# ---------------------------------------------------------------- detection
# The detection phase (PERF.md's detection rows): YOLO2 at
# DET_SHAPE (ZOO_INPUT above). (a) f32 on the card against the CPU at
# batch 2 (the decoded confidences and class probabilities, the loss, every
# gradient leaf, one step's displacements and BN statistics), (b) bf16
# against f32 at DET_BATCH, the detections, and the timings beside the
# plain twin (``plain_yolo2``, ``plain_yolo_loss``). Detections: the card's
# f32 net fits DET_FIT_STEPS steps on (a)'s batch, the CPU net takes its
# weights, and each side decodes its own training-mode activations; the
# threshold sits between the DET_TOP-th and the next confidence of the
# card's, and only objects further than DET_MARGIN from it are compared
# (closer ones may fall either side on two devices). Then three small
# paths card against CPU: a Bernoulli VAE's ``pretrain`` (784 → 256 →
# latent 32, MNIST-shaped binary data, batch VAE_BATCH, the same draws), a
# net under DropConnect (the same masks) and one with Deconvolution2D and
# Upsampling2D bilinear.
DET_FIT_STEPS = 4
DET_TOP = 40
DET_MARGIN = TOL_YOLO_F32["probs"]
DET_VALUE_TOL = 10 * DET_MARGIN    # coordinates and confidences, relative
DET_NMS_IOU = 0.45
VAE_BATCH, VAE_STEPS = 128, 3
SMALL_BATCH = 8
# card against CPU on the three small paths: loss, every gradient leaf,
# one step's displacements (VAE: each pretraining step's score and the
# layer's displacement over the steps). CPU readings, f32 against f64
# (``--readings``): the VAE 6.4e-8 and 2.3e-6 (Adam); DropConnect 1.3e-7,
# 3.3e-7, 1.1e-6; the deconvolution net 6.1e-8, 2.9e-7, 1.6e-5. The rows sit at
# ≥ 30× them: cuDNN's algorithms against the CPU's (ResNet-50's card
# against CPU read 2-3× its f32 against f64).
TOL_SMALL = {"vae_pretrain": {"score_rel": 1e-5, "step": 1e-3},
             "drop_connect": {"loss_rel": 1e-5, "grad": 1e-4, "step": 1e-4},
             "deconv": {"loss_rel": 1e-5, "grad": 1e-4, "step": 1e-3}}


def detections_of(net, x, threshold=None):
    """(the decoded confidences, the detections above ``threshold``) of
    ``net``'s training-mode activations on ``x``."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.objdetect import (
        get_predicted_objects)
    layer = net.conf.nodes["yolo"].layer
    with torch.no_grad():
        acts = net.feedForward(x, train=True)["yolo"].float()
        conf = layer.activate_detections(acts)[2].cpu().numpy()
    if threshold is None:
        return conf, None
    return conf, get_predicted_objects(layer, acts, threshold=threshold)


def detection_check(torch, dev, x, y):
    """The detections and NMS of the card's f32 YOLO2 after DET_FIT_STEPS
    fits against the CPU's on the same weights (see above)."""
    from deeplearning4j_tpu_torch.nn.conf.objdetect import (
        non_max_suppression)
    card = zoo_model("YOLO2", "float32").init_model(device=dev)
    for _ in range(DET_FIT_STEPS):
        card.fit(x, y)
    cpu = zoo_model("YOLO2", "float32").init_model(device="cpu")
    carry_net(card, cpu)
    c = np.sort(detections_of(card, x)[0].ravel())
    thr = float(0.5 * (c[-DET_TOP] + c[-DET_TOP - 1]))
    confs, objs = {}, {}
    for side, net in (("card", card), ("cpu", cpu)):
        confs[side], objs[side] = detections_of(net, x, thr)
    kept = {side: non_max_suppression(o, DET_NMS_IOU)
            for side, o in objs.items()}

    def clear(o):
        return abs(o.confidence - thr) > DET_MARGIN

    def key(o):
        return (o.example, o.predicted_class)

    rep = {"threshold": thr, "conf_max_abs_diff": float(np.abs(
        confs["card"] - confs["cpu"]).max())}
    for stage, lists in (("detected", objs), ("after_nms", kept)):
        a = [o for o in lists["card"] if clear(o)]
        b = [o for o in lists["cpu"] if clear(o)]
        near = len(lists["card"]) - len(a) + len(lists["cpu"]) - len(b)
        same = [key(o) for o in a] == [key(o) for o in b]
        diff = (max((max(abs(u - v) / max(1.0, abs(v)) for u, v in zip(
            (p.center_x, p.center_y, p.width, p.height, p.confidence),
            (q.center_x, q.center_y, q.width, q.height, q.confidence)))
            for p, q in zip(a, b)), default=0.0) if same else None)
        rep[stage] = {"card": len(lists["card"]), "cpu": len(lists["cpu"]),
                      "compared": len(a), "near_threshold": near,
                      "same_objects": same, "max_rel_diff": diff}
    emit(detection_card_vs_cpu=rep, margin=DET_MARGIN,
         value_tol=DET_VALUE_TOL, top=DET_TOP, fit_steps=DET_FIT_STEPS)
    for stage in ("detected", "after_nms"):
        r = rep[stage]
        check(r["same_objects"] and r["compared"] > 0
              and r["max_rel_diff"] <= DET_VALUE_TOL,
              f"YOLO2 detections {stage}: card and CPU differ: {r}")
    del card, cpu
    torch.cuda.empty_cache()
    return rep


def vae_conf():
    """The Bernoulli VAE (784 → 256 → latent 32 → 256 → 784 logits, relu)
    under a softmax head of 10, Adam(1e-3), seed SEED."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.variational import (
        VariationalAutoencoder)
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    return (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(1e-3))
            .list()
            .layer(VariationalAutoencoder(
                n_out=32, encoder_layer_sizes=(256,),
                decoder_layer_sizes=(256,), activation="relu",
                reconstruction_distribution="bernoulli"))
            .layer(OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(InputType.feed_forward(784)).build())


def vae_data(seed=SEED):
    """MNIST-shaped binary rows (a pixel on with probability 0.2) and
    VAE_STEPS reparameterization draws (1, VAE_BATCH, 32), from the seed."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(VAE_BATCH, 784)) < 0.2).astype(np.float32)
    eps = [rng.standard_normal((1, VAE_BATCH, 32)).astype(np.float32)
           for _ in range(VAE_STEPS)]
    return x, eps


def vae_pretrain_run(net, x, eps):
    """(each step's score, the VAE's params after ``pretrainLayer``)."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    scores = []

    class Scores:
        def iteration_done(self, model, it, epoch, score):
            scores.append(score)

    net.setListeners(Scores())
    net.pretrainLayer(0, x, epochs=VAE_STEPS, eps=eps)
    return scores, tree_to_numpy(net.param_tree())


def small_conf(kind):
    """The two small layer paths: "drop_connect", Dense(784 → 256, relu)
    and Dense(256 → 128, relu) under DropConnect(0.8) before a softmax
    head of 10; "deconv", a graph on 64 × 64 × 8 of Convolution 3x3 (16,
    relu), Deconvolution2D (3x3, stride 2, "same", output_padding 1, 16,
    relu), Upsampling2D bilinear ×2, a 1x1 convolution to 4 and a per-pixel
    mse CnnLossLayer; Nesterovs(1e-2, 0.9)."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    b = (NeuralNetConfiguration.builder().seed(SEED)
         .updater(Nesterovs(1e-2, 0.9)))
    if kind == "drop_connect":
        return (b.list()
                .layer(L.DenseLayer(n_out=256, activation="relu",
                                    weight_noise=DropConnect(0.8)))
                .layer(L.DenseLayer(n_out=128, activation="relu",
                                    weight_noise=DropConnect(0.8)))
                .layer(L.OutputLayer(n_out=10, activation="softmax"))
                .set_input_type(InputType.feed_forward(784)).build())
    g = (b.graph_builder().add_inputs("in")
         .set_input_types(InputType.convolutional(64, 64, 8)))
    g.add_layer("conv", L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                           padding="same",
                                           activation="relu"), "in")
    g.add_layer("deconv", L.Deconvolution2D(
        n_out=16, kernel_size=(3, 3), stride=(2, 2), padding="same",
        output_padding=(1, 1), activation="relu"), "conv")
    g.add_layer("up", L.Upsampling2D(size=(2, 2), interpolation="bilinear"),
                "deconv")
    g.add_layer("proj", L.ConvolutionLayer(n_out=4, kernel_size=(1, 1)),
                "up")
    g.add_layer("out", L.CnnLossLayer(loss_function="mse"), "proj")
    return g.set_outputs("out").build()


def small_net(kind, dev):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = small_conf(kind)
    cls = ComputationGraph if kind == "deconv" else MultiLayerNetwork
    return cls(conf, device=dev).init()


def small_data(kind, seed=SEED):
    rng = np.random.default_rng(seed)
    if kind == "drop_connect":
        x = rng.uniform(size=(SMALL_BATCH, 784)).astype(np.float32)
        return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10,
                                                            SMALL_BATCH)]
    x = rng.standard_normal((SMALL_BATCH, 64, 64, 8), dtype=np.float32)
    out = small_conf("deconv").activation_types["proj"]
    y = rng.standard_normal((SMALL_BATCH, out.height, out.width,
                             out.channels), dtype=np.float32)
    return x, y


@contextlib.contextmanager
def shared_drop_connect():
    """DropConnect drawing each mask from a CPU generator seeded afresh at
    every call (a mask depends on its param's shape alone), moved to the
    param's device: the card and CPU nets drop the same weights."""
    import torch
    from deeplearning4j_tpu_torch.nn import weightnoise
    plain = weightnoise.DropConnect.apply

    def same(self, params, gen, layer=None, draws=None):
        g = torch.Generator().manual_seed(SEED)
        draws = {k: (torch.rand(params[k].shape, generator=g)
                     < self.p).to(params[k].device) for k in sorted(params)}
        return plain(self, params, gen, layer, draws=draws)

    weightnoise.DropConnect.apply = same
    try:
        yield
    finally:
        weightnoise.DropConnect.apply = plain


def small_run(net, x, y):
    """The loss, every gradient leaf and one step's params (numpy)."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    loss, grads = net.computeGradientAndScore(x, y)
    net.fit(x, y)
    return {"loss": loss, "grads": tree_to_numpy(grads),
            "params": tree_to_numpy(net.param_tree())}


def small_compare(got, want, base):
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad": worst(tree_errors(got["grads"], want["grads"]))[0],
            "step": worst(tree_errors(got["params"], want["params"],
                                      base=base))[0]}


def small_paths(torch, dev):
    """The VAE's pretraining, the DropConnect net and the deconvolution
    net: f32 on the card against the same nets on the CPU, carried
    weights, the same draws, under TOL_SMALL."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    reps = {}
    x, eps = vae_data()
    nets = [MultiLayerNetwork(vae_conf(), device=d).init()
            for d in ("cpu", dev)]
    carry_net(nets[0], nets[1])
    base = tree_to_numpy(nets[0].param_tree())
    (s_cpu, p_cpu), (s_card, p_card) = (vae_pretrain_run(n, x, eps)
                                        for n in nets)
    reps["vae_pretrain"] = {
        "score_rel": max(abs(a - b) / abs(b) for a, b in zip(s_card, s_cpu)),
        "step": worst(tree_errors({"0": p_card["0"]}, {"0": p_cpu["0"]},
                                  base={"0": base["0"]}))[0],
        "others_moved": any(not np.array_equal(p_card[k][q], base[k][q])
                            for k in p_card if k != "0" for q in p_card[k]),
        "scores": s_card}
    for kind in ("drop_connect", "deconv"):
        x, y = small_data(kind)
        with shared_drop_connect():
            cpu, card = small_net(kind, "cpu"), small_net(kind, dev)
            carry_net(cpu, card)
            base = tree_to_numpy(cpu.param_tree())
            reps[kind] = small_compare(small_run(card, x, y),
                                       small_run(cpu, x, y), base)
    for kind, rep in reps.items():
        rows = TOL_SMALL[kind]
        failed = rows_failed(rep, rows)
        emit(small_card_vs_cpu={"path": kind, **rep}, rows=rows,
             failed=failed)
        check(not failed, f"{kind}: card vs CPU above its rows: {failed}")
    check(not reps["vae_pretrain"]["others_moved"],
          "pretrainLayer moved a layer other than the VAE")
    return reps


def detection_phase(torch, smi=None):
    """YOLO2 on the card (see DET_* above) and the small paths. Returns the
    port kernels' launches over these paths (all must be 0)."""
    from deeplearning4j_tpu_torch._device import resolve_device
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    if smi is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    reset_all_counts()
    x, y = zoo_data("YOLO2", DET_BATCH)
    n = ZOO_CHECK_BATCH["YOLO2"]
    zoo_card_vs_cpu(torch, "YOLO2", dev, x[:n], y[:n])
    zoo_bf16_vs_f32(torch, "YOLO2", dev, x, y)
    detection_check(torch, dev, x[:n], y[:n])
    rows = zoo_timing(torch, "YOLO2", dev, torch.as_tensor(x, device=dev),
                      torch.as_tensor(y, device=dev), smi)
    small_paths(torch, dev)
    launches = all_counts()
    emit(detection_phase_seconds=time.perf_counter() - t_phase,
         detection_launches=dict(zip(ALL_KERNELS, launches)))
    return launches, rows


# ----------------------------------------------------------------- transfer
# The transfer phase (PERF.md's transfer rows): DL4J's fine-tuning recipe
# on the zoo ResNet-50 at NET_SHAPE, batch NET_BATCH, f32, full depth.
# (a) a source net fits TR_SOURCE_STEPS Adam steps, goes into a temporary
# pretrained cache by ``save_pretrained`` and comes back by
# ``init_pretrained`` onto the card: every param, state and updater leaf
# bitwise, outputs no further from the source's than two of its own calls;
# (b) ``TransferLearning.GraphBuilder`` freezes everything up to "avgpool",
# re-draws "output" and takes Adam(TR_LR); ``EarlyStoppingGraphTrainer``
# fits it on TR_TRAIN_BATCHES batches of seeded synthetic images of
# TR_CLASSES classes (a fitted NormalizerStandardize, served by
# AsyncDataSetIterator) and scores TR_HELD_BATCHES held-out batches, with a
# LocalFileModelSaver and a CheckpointListener every epoch (keep_last 2):
# frozen params and their updater state bitwise unchanged, the output layer
# moved, the frozen BatchNormalizations' running statistics moved (the
# reference's behaviour); (c) the saved best model re-scores its recorded
# score; (d) the newest checkpoint resumes one batch beside two in-memory
# copies of the same state, within the copies' own spread; (e) evaluate
# and ROC on the card, the best zip restored on the CPU scores held-out
# images within the network phase's f32 card-vs-CPU row; then LeNet on
# MNIST (synthetic unless the IDX files are there, NormalizerMinMaxScaler):
# (f) ``nout_replace`` + ``set_feature_extractor`` and featurize, (g)
# L-BFGS and conjugate gradient on the card beside the CPU port, (h) a
# DL4J-format zip restored on the card. No kernel of the port runs here.
TR_CLASSES = 5
TR_TRAIN_BATCHES, TR_HELD_BATCHES = 8, 2
TR_SOURCE_STEPS = 2
TR_SOURCE_LR, TR_LR = 1e-3, 1e-4
TR_PATIENCE, TR_MAX_EPOCHS = 2, 4
TR_CPU_IMAGES = 4
TR_LENET_BATCH, TR_LENET_EXAMPLES = 64, 1024
TR_LENET_HIDDEN = 256          # the dense layer's width after nout_replace
TR_SOLVER_ITERS = 5
TR_SOLVERS = ("lbfgs", "conjugate_gradient")
# (c) the best zip's re-score: the same params on the same card and batch
# through the same algorithms (reads 0 where cuDNN is deterministic; a
# loss of ~7 carries f32 rounding of ~5e-7 relative at most)
# (e) the best model on the CPU against the card: the network phase's f32
# card-vs-CPU probabilities row (ResNet-50, 224², inference mode here)
# (g) each solver iteration's score on the card against the CPU port's
# trajectory: see TOL_TRANSFER_SOLVER
TOL_TRANSFER = {"best_rescore_rel": 1e-6, "cpu_probs": TOL_NET_F32["probs"]}
# relative; set from CPU readings (``--readings transfer``): a one-ulp
# nudge of LeNet's start moves its five L-BFGS / CG scores by at most
# 3.0e-7 / 3.6e-7 relative, and the line searches' smallest Armijo margin
# is 0.0087; the row sits ~30× over the nudge (cuDNN's orders against the
# CPU's read 2-3× f32's own on ResNet-50, network rows) and far under the
# margins, so no accept or reject can flip inside it
TOL_TRANSFER_SOLVER = 1e-5


def transfer_data(n, seed):
    """``n`` seeded synthetic NET_SHAPE images of TR_CLASSES classes (the
    vision iterators' generator: a class-coloured grating plus noise) as
    pixels in [0, 255], NHWC f32, labels one-hot over NET_CLASSES outputs
    (the graph's head keeps the pretrained net's width)."""
    from deeplearning4j_tpu_torch.data.vision import _synthetic_images
    imgs, labels = _synthetic_images(n, TR_CLASSES, NET_SHAPE[0],
                                     NET_SHAPE[2], seed)
    return ((255.0 * imgs).astype(np.float32),
            np.eye(NET_CLASSES, dtype=np.float32)[labels])


def unequal_leaves(torch, a, b):
    """The ``layer/param`` leaves of two two-level trees that are not
    bitwise equal (or not in both)."""
    keys = sorted({(k, p) for k in a for p in a[k]}
                  | {(k, p) for k in b for p in b[k]})
    return [f"{k}/{p}" for k, p in keys
            if p not in a.get(k, {}) or p not in b.get(k, {})
            or not torch.equal(a[k][p], b[k][p])]


def unequal_updater_leaves(torch, a, b):
    """Indices of the leaves of two optimizer states (``optim/transforms``
    layout) that differ; ["length"] when they do not line up."""
    from deeplearning4j_tpu_torch.optim.transforms import state_leaves
    la, lb = state_leaves(a), state_leaves(b)
    if len(la) != len(lb):
        return ["length"]
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)]


def param_lists(state, n):
    """The param-shaped lists (``n`` tensors) inside an optimizer state."""
    if isinstance(state, dict):
        for v in state.values():
            yield from param_lists(v, n)
    elif isinstance(state, (list, tuple)):
        if len(state) == n and all(hasattr(t, "shape") for t in state):
            yield state
        else:
            for v in state:
                yield from param_lists(v, n)


def frozen_updater_leaves(net):
    """Clones of every updater-state tensor of ``net``'s frozen leaves."""
    from deeplearning4j_tpu_torch.nn.params import leaf_keys
    keys = leaf_keys(net.param_tree())
    idx = [i for i, (k, _) in enumerate(keys) if k in net._frozen]
    return [lst[i].clone() for lst in param_lists(net.updater_state(),
                                                  len(keys)) for i in idx]


def tree_max_abs(torch, a, b):
    """max |a − b| over the leaves of two two-level trees and, with
    optimizer states under ``"_updater"``, their tensors."""
    from deeplearning4j_tpu_torch.optim.transforms import state_leaves
    worst = 0.0
    for k in a:
        if k == "_updater":
            pairs = [(x, y) for x, y in zip(state_leaves(a[k]),
                                            state_leaves(b[k]))
                     if isinstance(x, torch.Tensor)]
        else:
            pairs = [(a[k][p], b[k][p]) for p in a[k]]
        for x, y in pairs:
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst


def net_snapshot(net):
    return {**net.param_tree(), "_updater": net.updater_state()}


def solver_gaps(card, cpu):
    """Each iteration's |card − cpu| / max(1, |cpu|) over two score
    trajectories of the same length (else None)."""
    if len(card) != len(cpu):
        return None
    return [abs(a - b) / max(1.0, abs(b)) for a, b in zip(card, cpu)]


def armijo_margins(trials):
    """(iteration, step, score − bound) of a solver's line-search trials."""
    return [(it, alpha, score - bound) for it, alpha, score, bound in trials]


def lenet_batches(torch, batch=TR_LENET_BATCH, examples=TR_LENET_EXAMPLES):
    """MNIST through ``MnistDataSetIterator`` (its synthetic glyphs unless
    the IDX files are there) and a fitted ``NormalizerMinMaxScaler``:
    (the normalized DataSets, synthetic or not)."""
    from deeplearning4j_tpu_torch.data import (MnistDataSetIterator,
                                               NormalizerMinMaxScaler)
    it = MnistDataSetIterator(batch, train=True, num_examples=examples)
    norm = NormalizerMinMaxScaler().fit(it)
    it.reset()
    return [norm.transform(ds) for ds in it], it.synthetic


def run_solver(torch, net, algo, x, y):
    """(scores a iteration, line-search trials, host ms an iteration) of
    ``algo`` over TR_SOLVER_ITERS iterations on one batch."""
    from deeplearning4j_tpu_torch.optim.listeners import (
        CollectScoresListener)
    from deeplearning4j_tpu_torch.optim.solvers import Solver
    scores = CollectScoresListener()
    net.setListeners(scores)
    solver = (Solver.Builder().model(net).configure(algo)
              .max_iterations(TR_SOLVER_ITERS).build())
    if net.device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    solver.optimize(x, y)
    ms = 1e3 * (time.perf_counter() - t) / TR_SOLVER_ITERS
    net.setListeners()
    return scores.scores, solver.optimizer.trials, ms


def transfer_readings():
    """CPU readings for TOL_TRANSFER_SOLVER: LeNet's L-BFGS and CG score
    trajectories from the port's init and from the same params moved by
    one f32 ulp (``np.nextafter`` away from 0), the largest relative gap
    a solver's five scores show."""
    import torch
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    batches, synthetic = lenet_batches(torch)
    x, y = batches[0].features, batches[0].labels
    out = {"synthetic": synthetic}
    for algo in TR_SOLVERS:
        runs = []
        for nudge in (False, True):
            net = LeNet().init_model(device="cpu")
            if nudge:
                tree = {k: {p: np.nextafter(
                    v.numpy(), np.where(v.numpy() < 0, -np.inf, np.inf),
                    dtype=np.float32) for p, v in layer.items()}
                    for k, layer in net.param_tree().items()}
                net.set_param_tree(tree)
            runs.append(run_solver(torch, net, algo, x, y))
        gaps = solver_gaps(runs[1][0], runs[0][0])
        out[algo] = {"scores": runs[0][0], "nudged": runs[1][0],
                     "gaps": gaps, "worst": max(gaps) if gaps else None,
                     "margins": armijo_margins(runs[0][1])}
    return out


def resnet_transfer(dtype, dev, source=None):
    """The fine-tuning net: ``source`` (else a fresh zoo ResNet-50 in
    ``dtype``) through ``GraphBuilder``: Adam(TR_LR), frozen up to
    "avgpool", "output" re-drawn."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    if source is None:
        source = ResNet50(num_classes=NET_CLASSES, input_shape=NET_SHAPE,
                          updater=Adam(TR_SOURCE_LR),
                          data_type=dtype).init_model(device=dev)
    return (TransferLearning.GraphBuilder(source)
            .fine_tune_configuration(FineTuneConfiguration(
                updater=Adam(TR_LR)))
            .set_feature_extractor("avgpool").reinit_layer("output").build())


def transfer_timing(torch, dev, smi, x, y):
    """The frozen-trunk fine-tune step, f32 and bf16, in turns (port,
    plain, plain, port) with the plain ResNet-50 twin whose trunk has
    ``requires_grad`` off and whose head takes Adam(TR_LR); then a
    profiler window of NET_PROFILED steps of each (device ms, busy share,
    kernels a step, top device ops)."""
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    rows = []
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        net = resnet_transfer(dtype, dev)
        twin = plain_resnet50(torch).to(dev).to(
            memory_format=torch.channels_last)
        for p in twin.trunk.parameters():
            p.requires_grad_(False)
        opt = torch.optim.Adam(twin.head.parameters(), lr=TR_LR)
        plain = plain_step(torch, twin, opt, bf16)
        runs = {"port": lambda: net.fit(xd, yd),
                "plain": lambda: plain(xd, yd)}
        timed = {"port": [], "plain": []}
        for who in ("port", "plain", "plain", "port"):
            ms, _all = step_timing(torch, runs[who])
            timed[who].append(ms)
        prof = {who: profile_window(
            torch, f"transfer_{who}_{dtype}",
            lambda f=runs[who]: [f() for _ in range(NET_PROFILED)],
            f"transfer_{who}_{dtype}_trace.json", top=8)
            for who in ("port", "plain")}
        for who in ("port", "plain"):
            ms = statistics.median(timed[who])
            p = prof[who]
            rows.append({"model": who, "dtype": dtype, "gpu": smi,
                         "host_ms_per_step": ms, "turns_ms": timed[who],
                         "images_per_s": NET_BATCH / (ms / 1e3),
                         "device_ms_per_step": (
                             p["device_busy_us"] / 1e3 / NET_PROFILED
                             if "device_busy_us" in p else None),
                         "busy_share": p.get("busy_share"),
                         "kernels_per_step": (p["kernels"] / NET_PROFILED
                                              if "kernels" in p else None),
                         "top_ops": p.get("top_ops")})
        del net, twin, opt, runs
        torch.cuda.empty_cache()
    return rows


def transfer_phase(torch, smi=None):
    """The fine-tuning recipe on the card (see TR_* above). Returns the
    port kernels' launches over it (all must be 0)."""
    import os
    import tempfile
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               DataSet, ListDataSetIterator,
                                               NormalizerStandardize)
    from deeplearning4j_tpu_torch.models.zoo import LeNet, ResNet50
    from deeplearning4j_tpu_torch.modelimport import dl4j_zip
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning, TransferLearningHelper)
    from deeplearning4j_tpu_torch.optim import earlystopping as es
    from deeplearning4j_tpu_torch.optim.listeners import CheckpointListener
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    from deeplearning4j_tpu_torch.utils.serialization import (
        ModelSerializer, checkpoint_candidates)
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    if smi is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    reset_all_counts()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_transfer_")
    root = tmp.name
    out = {"gpu": smi}
    try:
        # (a) the pretrained round trip
        x, y = network_data(NET_BATCH)
        zoo = ResNet50(num_classes=NET_CLASSES, input_shape=NET_SHAPE,
                       updater=Adam(TR_SOURCE_LR))
        src = zoo.init_model(device=dev)
        for _ in range(TR_SOURCE_STEPS):
            src.fit(x, y)
        torch.cuda.synchronize()
        cache = os.environ.get("DL4J_TPU_ZOO_CACHE")
        os.environ["DL4J_TPU_ZOO_CACHE"] = os.path.join(root, "zoo")
        try:
            t = time.perf_counter()
            path = zoo.save_pretrained(src, "imagenet")
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            got = zoo.init_pretrained("imagenet")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
        finally:
            if cache is None:
                del os.environ["DL4J_TPU_ZOO_CACHE"]
            else:
                os.environ["DL4J_TPU_ZOO_CACHE"] = cache
        xs = x[:NET_CHECK_BATCH]
        o1, o2, og = src.output(xs), src.output(xs), got.output(xs)
        rep_a = {"save_s": save_s, "restore_s": restore_s,
                 "zip_mb": os.path.getsize(path) / 2**20,
                 "device": str(got.device),
                 "params": unequal_leaves(torch, got.param_tree(),
                                          src.param_tree()),
                 "states": unequal_leaves(torch, got.state_tree(),
                                          src.state_tree()),
                 "updater": unequal_updater_leaves(
                     torch, got.updater_state(), src.updater_state()),
                 "meta": [got.getIterationCount(), got.getEpochCount()],
                 "output_gap": float((og - o1).abs().max()),
                 "two_calls_gap": float((o2 - o1).abs().max())}
        emit(transfer_pretrained=rep_a)
        check(got.device.type == "cuda", f"(a) init_pretrained landed on "
              f"{got.device}, not the card")
        check(not (rep_a["params"] or rep_a["states"] or rep_a["updater"]),
              f"(a) the restored net is not the saved one bit for bit: "
              f"{rep_a}")
        check(rep_a["meta"] == [TR_SOURCE_STEPS, 0],
              f"(a) meta gave iteration and epoch {rep_a['meta']}")
        check(rep_a["output_gap"] <= rep_a["two_calls_gap"],
              f"(a) outputs {rep_a['output_gap']} from the source's, two "
              f"calls of the source {rep_a['two_calls_gap']}")
        del src, o1, o2, og

        # (b) fine-tune under early stopping and checkpoints
        tx, ty = transfer_data(NET_BATCH * TR_TRAIN_BATCHES, SEED + 11)
        hx, hy = transfer_data(NET_BATCH * TR_HELD_BATCHES, SEED + 12)
        norm = NormalizerStandardize().fit(DataSet(tx, ty))

        def batches(xa, ya):
            return [norm.transform(DataSet(xa[i:i + NET_BATCH],
                                           ya[i:i + NET_BATCH]))
                    for i in range(0, len(xa), NET_BATCH)]
        train_sets, held_sets = batches(tx, ty), batches(hx, hy)
        del tx, hx
        ft = resnet_transfer("float32", dev, source=got)
        del got
        frozen_params = {k: {p: v.clone() for p, v in layer.items()}
                         for k, layer in ft.param_tree().items()
                         if k in ft._frozen}
        frozen_opt = frozen_updater_leaves(ft)
        head0 = ft.param_tree()["output"]["W"].clone()
        stats0 = {k: {s: v.clone() for s, v in layer.items()}
                  for k, layer in ft.state_tree().items() if k in ft._frozen}
        best_dir, ck_dir = (os.path.join(root, "best"),
                            os.path.join(root, "checkpoints"))
        saver = es.LocalFileModelSaver(best_dir)
        ck = CheckpointListener(ck_dir, save_every_n_epochs=1, keep_last=2)
        ft.setListeners(ck)
        cfg = (es.EarlyStoppingConfiguration.Builder()
               .score_calculator(es.DataSetLossCalculator(
                   ListDataSetIterator(held_sets)))
               .epoch_termination_conditions(
                   es.ScoreImprovementEpochTerminationCondition(TR_PATIENCE),
                   es.MaxEpochsTerminationCondition(TR_MAX_EPOCHS))
               .model_saver(saver).build())
        train_it = AsyncDataSetIterator(ListDataSetIterator(train_sets))
        try:
            t = time.perf_counter()
            result = es.EarlyStoppingGraphTrainer(cfg, ft, train_it).fit()
            torch.cuda.synchronize()
            es_s = time.perf_counter() - t
        finally:
            train_it.close()
        ft.setListeners()
        moved_stats = [f"{k}/{s}" for k in stats0 for s in stats0[k]
                       if not torch.equal(stats0[k][s],
                                          ft.state_tree()[k][s])]
        frozen_opt_after = frozen_updater_leaves(ft)
        rep_b = {"seconds": es_s, "epochs": result.total_epochs,
                 "reason": result.termination_reason,
                 "details": result.termination_details,
                 "best_epoch": result.best_model_epoch,
                 "best_score": result.best_model_score,
                 "score_vs_epoch": result.score_vs_epoch,
                 "iterations": ft.getIterationCount(),
                 "frozen_layers": len(ft._frozen),
                 "frozen_params_changed": unequal_leaves(
                     torch, {k: ft.param_tree()[k] for k in frozen_params},
                     frozen_params),
                 "frozen_updater_changed": sum(
                     not torch.equal(a, b)
                     for a, b in zip(frozen_opt, frozen_opt_after)),
                 "frozen_updater_leaves": len(frozen_opt),
                 "head_moved": not torch.equal(
                     head0, ft.param_tree()["output"]["W"]),
                 "frozen_bn_stats_moved": len(moved_stats),
                 "checkpoints": sorted(os.listdir(ck_dir))}
        emit(transfer_early_stopping=rep_b)
        check(rep_b["epochs"] >= 1 and rep_b["iterations"]
              == rep_b["epochs"] * TR_TRAIN_BATCHES,
              f"(b) the trainer ran {rep_b['epochs']} epochs, "
              f"{rep_b['iterations']} steps")
        check(not rep_b["frozen_params_changed"]
              and rep_b["frozen_updater_changed"] == 0
              and len(frozen_opt) == len(frozen_opt_after) > 0,
              f"(b) frozen params or their updater state moved: {rep_b}")
        check(rep_b["head_moved"], "(b) the output layer did not move")
        check(rep_b["frozen_bn_stats_moved"] > 0,
              "(b) the frozen BN running statistics did not move (the "
              "reference's step moves them)")
        check(len(rep_b["checkpoints"]) == min(2, rep_b["epochs"]),
              f"(b) keep_last 2 left {rep_b['checkpoints']}")

        # (c) the best model re-scores its recorded score
        best = saver.get_best_model()
        rescore = es.DataSetLossCalculator(
            ListDataSetIterator(held_sets)).calculate_score(best)
        rel = abs(rescore - result.best_model_score) / abs(
            result.best_model_score)
        emit(transfer_best_rescore={"rescore": rescore, "rel": rel,
                                    "row": TOL_TRANSFER["best_rescore_rel"],
                                    "device": str(best.device)})
        check(best.device.type == "cuda", f"(c) the best model landed on "
              f"{best.device}")
        check(rel <= TOL_TRANSFER["best_rescore_rel"],
              f"(c) the best zip re-scores {rescore} against "
              f"{result.best_model_score}")

        # (d) resume from the newest checkpoint beside in-memory copies
        newest = checkpoint_candidates(ck_dir)[0]
        resumed = ModelSerializer.restore(newest)
        # a zip carries no frozen set (as the reference's): re-freeze
        resumed._frozen = set(ft._frozen)
        same_state = not (unequal_leaves(torch, resumed.param_tree(),
                                         ft.param_tree())
                          or unequal_updater_leaves(
                              torch, resumed.updater_state(),
                              ft.updater_state()))
        copies = []
        for _ in range(2):
            c = ComputationGraph(ComputationGraphConfiguration.from_json(
                ft.conf.to_json()), device=dev).init()
            carry_net(ft, c)
            c._frozen = set(ft._frozen)
            copies.append(c)
        xb, yb = train_sets[0].features, train_sets[0].labels
        for net in [resumed] + copies:
            net.fit(xb, yb)
        row_d = tree_max_abs(torch, net_snapshot(copies[0]),
                             net_snapshot(copies[1]))
        err_d = tree_max_abs(torch, net_snapshot(resumed),
                             net_snapshot(copies[0]))
        emit(transfer_resume={"checkpoint": os.path.basename(newest),
                              "same_state_before": same_state,
                              "device": str(resumed.device),
                              "max_abs": err_d, "copies_max_abs": row_d})
        check(resumed.device.type == "cuda" and same_state,
              f"(d) the newest checkpoint is not the trained state "
              f"({resumed.device}, {same_state})")
        check(err_d <= row_d, f"(d) the resumed step is {err_d} from an "
              f"in-memory copy's, two copies {row_d}")
        del resumed, copies, ft
        torch.cuda.empty_cache()

        # (e) evaluate on the card, the best zip on the CPU
        ev = best.evaluate(ListDataSetIterator(held_sets))
        roc = best.evaluateROCMultiClass(ListDataSetIterator(held_sets))
        aucs = [roc.calculate_auc(c) for c in range(TR_CLASSES)]
        cpu_best = saver.get_best_model(device="cpu")
        xs = held_sets[0].features[:TR_CPU_IMAGES]
        p_card = best.output(xs).cpu().numpy()
        p_cpu = cpu_best.output(xs).numpy()
        rep_e = {"accuracy": ev.accuracy(), "auc_by_class": aucs,
                 "cpu_vs_card_probs": rel_l2(p_cpu, p_card),
                 "row": TOL_TRANSFER["cpu_probs"]}
        emit(transfer_evaluate=rep_e)
        check(all(0.0 <= a <= 1.0 for a in aucs)
              and math.isfinite(rep_e["accuracy"]),
              f"(e) evaluation gave {rep_e}")
        check(rep_e["cpu_vs_card_probs"] <= TOL_TRANSFER["cpu_probs"],
              f"(e) the best model on the CPU reads "
              f"{rep_e['cpu_vs_card_probs']} from the card's")
        del best, cpu_best
        torch.cuda.empty_cache()

        # (f) LeNet on MNIST: nout_replace, a frozen prefix, featurize
        lenet_sets, synthetic = lenet_batches(torch)
        lenet = LeNet().init_model(device=dev)
        lenet.fit(ListDataSetIterator(lenet_sets), epochs=1)
        tl = (TransferLearning.Builder(lenet)
              .fine_tune_configuration(FineTuneConfiguration(
                  updater=Adam(1e-3)))
              .nout_replace(4, TR_LENET_HIDDEN).set_feature_extractor(3)
              .build())
        x0, y0 = lenet_sets[0].features, lenet_sets[0].labels
        feat = TransferLearningHelper(tl).featurize(lenet_sets[0]).features
        f_tl, f_src = tl.feedForward(x0)[4], lenet.feedForward(x0)[4]
        frozen_w = tl.param_tree()["0"]["W"].clone()
        tl.fit(ListDataSetIterator(lenet_sets[:4]), epochs=1)
        rep_f = {"synthetic": synthetic,
                 "featurize_is_feedforward": bool(torch.equal(feat, f_tl)),
                 "featurize_is_source": bool(torch.equal(feat, f_src)),
                 "frozen_kept": bool(torch.equal(
                     frozen_w, tl.param_tree()["0"]["W"])),
                 "hidden": list(tl.param_tree()["4"]["W"].shape)}
        emit(transfer_lenet=rep_f)
        check(rep_f["featurize_is_feedforward"] and rep_f["featurize_is_source"]
              and rep_f["frozen_kept"]
              and rep_f["hidden"][1] == TR_LENET_HIDDEN,
              f"(f) LeNet transfer: {rep_f}")

        # (g) L-BFGS and CG on the card beside the CPU port
        rep_g = {}
        for algo in TR_SOLVERS:
            card = LeNet().init_model(device=dev)
            cpu = LeNet().init_model(device="cpu")
            cpu.set_param_tree(card.param_tree())
            c_scores, c_trials, c_ms = run_solver(torch, card, algo, x0, y0)
            h_scores, _, h_ms = run_solver(torch, cpu, algo, x0, y0)
            gaps = solver_gaps(c_scores, h_scores)
            rep_g[algo] = {"scores": c_scores, "cpu_scores": h_scores,
                           "gaps": gaps, "ms_per_iteration": c_ms,
                           "cpu_ms_per_iteration": h_ms,
                           "margins": armijo_margins(c_trials)}
        emit(transfer_solvers=rep_g, row=TOL_TRANSFER_SOLVER, gpu=smi)
        for algo, r in rep_g.items():
            check(r["gaps"] is not None
                  and len(r["scores"]) == TR_SOLVER_ITERS
                  and r["scores"][-1] < r["scores"][0]
                  and max(r["gaps"]) <= TOL_TRANSFER_SOLVER,
                  f"(g) {algo}: {r}")

        # (h) a DL4J-format zip, restored on the card
        zpath = os.path.join(root, "lenet_dl4j.zip")
        dl4j_zip.write_model(lenet, zpath)
        back = dl4j_zip.restore_multi_layer_network(zpath)
        o1, o2, ob = lenet.output(x0), lenet.output(x0), back.output(x0)
        rep_h = {"device": str(back.device),
                 "params": unequal_leaves(torch, back.param_tree(),
                                          lenet.param_tree()),
                 "output_gap": float((ob - o1).abs().max()),
                 "two_calls_gap": float((o2 - o1).abs().max())}
        emit(transfer_dl4j_zip=rep_h)
        check(back.device.type == "cuda" and not rep_h["params"]
              and rep_h["output_gap"] <= rep_h["two_calls_gap"],
              f"(h) the DL4J zip's restore: {rep_h}")
        del lenet, tl, back

        out["timing"] = transfer_timing(torch, dev, smi, *transfer_data(
            NET_BATCH, SEED + 13))
        for r in out["timing"]:
            emit(transfer_timing=r)
    finally:
        tmp.cleanup()
    launches = all_counts()
    emit(transfer_phase_seconds=time.perf_counter() - t_phase,
         transfer_launches=dict(zip(ALL_KERNELS, launches)))
    return launches


# ------------------------------------------------------------------ scoring
# The scoring phase (PERF.md's scoring rows): the fine-tune → serve loop on
# the zoo ResNet-50 at 224², full depth. The trunk stands in for a
# pretrained one: seeded init with its BatchNormalization statistics set
# from one batch of the data (``calibrate_bn``; at their init a deep
# trunk's outputs saturate, so every image would score alike). (1)
# Healing, f32: the transfer
# recipe (frozen to "avgpool", Adam(TR_LR) on the head, batch 32) over
# SC_TRAIN_BATCHES seeded batches under a ResilientTrainer (checkpoints
# every SC_CKPT_EVERY iterations, keep SC_KEEP), with train.step faults
# keyed to the net's iteration: a transient error at SC_TRANSIENT_AT
# (retried in place), a crash at SC_CRASH_AT (restore, fast-forward) and a
# batch that crashes twice at SC_POISON_AT (quarantined); held against two
# undisturbed runs over the same batches without the quarantined one. (2)
# Scoring, f32 and bf16: ModelRegistry.deploy of the healed net
# (batch_limit 32, buckets 1-32, every bucket warmed), SC_CLIENTS client
# threads of SC_REQUESTS requests each (every SC_WIDE_EVERY-th of SC_WIDE
# images) of held-out images of every class, each request held against
# net.output of its images alone (bf16: every SC_BF16_SAMPLE-th); the f32
# check must tell images apart (every image's probabilities further than
# the row from every other's) and fails when a row shift is planted in
# ParallelInference._distribute; images/s, latency, occupancy, bucket
# fill, a profiler window (with how long the copies run under kernels of
# other streams), inflight_limit 1, 2 and a direct batch-32 output loop
# in turns, one of each (bf16: the direct loop alone).
# (3) Canary over POST /v1/classify: v2 (the healed net's zip restored)
# walks to full and promotes; v3 under the serving.canary chaos point rolls
# back; no incumbent request fails. (4) A profile capture during traffic.
# No kernel of the port runs here.
SC_TRAIN_BATCHES = 12
SC_CKPT_EVERY, SC_KEEP = 4, 2
#: the net's iteration at which each train.step fault fires, and its kinds
#: in firing order (the poisoned batch crashes on its first two attempts)
SC_FAULTS = {3: ["error"], 7: ["crash"], 9: ["crash", "crash"]}
SC_MAX_RESTARTS = 4
SC_BATCH_LIMIT, SC_MAX_WAIT_MS = 32, 5.0
SC_CLIENTS, SC_REQUESTS = 16, 32
SC_WIDE_EVERY, SC_WIDE = 4, 3          # every 4th request carries 3 images
SC_PROFILE_STEPS = 8
SC_WINDOW_CLIENTS, SC_WINDOW_REQUESTS = 4, 8     # the profiler window
SC_BF16_SAMPLE = 8          # bf16: every 8th request held to its row
SC_CALIBRATION = 32         # images that set the trunk's BN statistics
SC_DIRECT_BATCHES = 24
SC_TIMEOUT_S = 300.0
# a request's probabilities in its padded bucket against the same images
# through net.output alone: the same net and weights, another batch size
# (cuDNN picks algorithms per batch size: f32 sums in another order).
# f32: 4× the CPU readings on the served recipe (``--readings scoring``:
# BN statistics set from data, fine-tuned, at 64² and 96²), each batch of
# 2-32 against each image alone: 1.30e-4 / 4.0e-5 (oneDNN's batch-1 path
# against its batched one; 3 images at batch 3 against the same in 32:
# 1.2e-6 / 9.8e-7); every pair of distinct images reads ≥ 0.18 apart
# there, ~350× this row. bf16: its hidden activations
# round to bf16 after sums in another order, a one-ulp flip where the f32
# sums straddle a rounding boundary, carried through 50 layers: bounded
# by the whole of bf16's rounding (TOL_NET_BF16's row; the CPU reads
# 3.0e-6 / 2.4e-6 where oneDNN's bf16 sums agree, but cuDNN's need not)
TOL_SCORING = {"float32": 5e-4, "bfloat16": TOL_NET_BF16["probs"]}
# the fleet's classify answers against the demo net in this process: the
# same f32 products on the same card in another process, a few ulps of
# probabilities ≤ 1
TOL_FLEET_CLASSIFY = 1e-6
#: cuDNN convolution kernels by name (Hopper's implicit-GEMM fprop, the
#: older implicit sgemm and winograd kernels, cuDNN's own namespace)
CONV_KERNEL = re.compile(r"conv|fprop|implicit_gemm|implicit_convolve|"
                         r"winograd|cudnn|xmma", re.IGNORECASE)


@contextlib.contextmanager
def positional_train_faults(net, plan, faults=None):
    """``train.step`` faults keyed to ``net``'s iteration: when the step at
    iteration ``i`` is attempted and ``plan[i]`` still holds kinds, the
    first is taken off and raised as an ``InjectedFault`` (before the
    step touches any param, where the fault point sits). Other points
    pass. ``faults`` is the fault module patched (default: the port's).
    Yields the list of (iteration, kind) fired."""
    from unittest import mock
    if faults is None:
        from deeplearning4j_tpu_torch.resilience import faults
    left = {i: list(kinds) for i, kinds in plan.items()}
    fired = []

    def check(point):
        if point != "train.step":
            return
        kinds = left.get(net._iteration)
        if kinds:
            kind = kinds.pop(0)
            fired.append((net._iteration, kind))
            raise faults.InjectedFault(point, kind)

    with mock.patch.object(faults, "armed", return_value=True), \
            mock.patch.object(faults, "check", side_effect=check), \
            mock.patch.object(faults, "corrupt",
                              side_effect=lambda point, value: value):
        yield fired


def counter_value(name, **labels):
    """A counter's value in the process registry (0 when absent)."""
    from deeplearning4j_tpu_torch.observability import global_registry
    inst = global_registry().get(name)
    if inst is None:
        return 0.0
    return float(inst.labels(**labels).value if labels else inst.value)


def histogram_mean(name):
    """(sum, count) of an unlabelled histogram in the process registry."""
    from deeplearning4j_tpu_torch.observability import global_registry
    inst = global_registry().get(name)
    return (0.0, 0) if inst is None else (float(inst.sum), int(inst.count))


def healing_drill(net, sets, root, plan=None, max_restarts=None,
                  every=None, keep=None, trainer=None, iterator=None,
                  faults=None, counter=None):
    """``net`` fit once over ``sets`` (a list of DataSets) by a
    ``ResilientTrainer`` checkpointing into ``root`` under
    :func:`positional_train_faults`. ``trainer``, ``iterator``, ``faults``
    and ``counter`` (a name → value reader) default to the port's
    ``ResilientTrainer``, ``ListDataSetIterator``, fault module and
    :func:`counter_value`; a test passes the JAX package's to run the
    same drill there. Returns the drill's record: the
    faults fired, restarts, restores and quarantines (counter deltas),
    the quarantined positions, the final iteration, the checkpoints left,
    seconds."""
    import os
    if trainer is None:
        from deeplearning4j_tpu_torch.data import (
            ListDataSetIterator as iterator)
        from deeplearning4j_tpu_torch.resilience import (
            ResilientTrainer as trainer)
    counter = counter_value if counter is None else counter
    plan = SC_FAULTS if plan is None else plan
    max_restarts = SC_MAX_RESTARTS if max_restarts is None else max_restarts
    every = SC_CKPT_EVERY if every is None else every
    keep = SC_KEEP if keep is None else keep
    restores0 = counter("dl4j_checkpoint_restores_total")
    quarantined0 = counter("dl4j_data_quarantined_total")
    rt = trainer(net, root, max_restarts=max_restarts,
                 checkpoint_every_iterations=every, keep_checkpoints=keep,
                 quarantine_after=2)
    t = time.perf_counter()
    with positional_train_faults(net, plan, faults) as fired:
        rt.fit(iterator(sets), epochs=1)
    seconds = time.perf_counter() - t
    return {"fired": [list(f) for f in fired], "restarts": rt.restarts,
            "restores": counter("dl4j_checkpoint_restores_total")
            - restores0,
            "quarantines": counter("dl4j_data_quarantined_total")
            - quarantined0,
            "iterations": net._iteration, "seconds": seconds,
            "checkpoints": sorted(os.listdir(root))}


def healing_expected(plan=None, n_batches=None):
    """What :func:`healing_drill` must count for ``plan`` over
    ``n_batches``: every crash one restart and one restore, a batch that
    crashes twice one quarantine, a transient error none, and one
    iteration a batch that is not quarantined."""
    plan = SC_FAULTS if plan is None else plan
    n_batches = SC_TRAIN_BATCHES if n_batches is None else n_batches
    crashes = sum(k == "crash" for kinds in plan.values() for k in kinds)
    poisoned = sum(kinds.count("crash") >= 2 for kinds in plan.values())
    return {"restarts": crashes, "restores": crashes,
            "quarantines": poisoned, "iterations": n_batches - poisoned}


def calibrate_bn(torch, net, x):
    """Set every BatchNormalization layer's running mean and variance of
    ``net`` to the statistics its input has in one training-mode forward
    of ``x`` (each layer normalised by its batch's statistics, as in
    training): a trunk at its init then normalises data like the
    pretrained trunk it stands in for. Nothing else of the net moves."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    bns = [node.layer for node in net.conf.nodes.values()
           if isinstance(node.layer, BatchNormalization)]
    decays = [layer.decay for layer in bns]
    for layer in bns:
        layer.decay = 0.0
    try:
        with torch.no_grad():
            _acts, states, _ = net._forward(net._params, net._states,
                                            (net._to_device(x),), True, None)
    finally:
        for layer, d in zip(bns, decays):
            layer.decay = d
    net.set_state_tree(states)
    return len(bns)


def scoring_images(n, seed=SEED + 31, norm=None):
    """``n`` held-out images of the transfer recipe's classes (drawn
    from their own seed), through ``norm`` (the fitted normaliser) when
    given: (images, class of each)."""
    from deeplearning4j_tpu_torch.data import DataSet
    x, y = transfer_data(n, seed)
    if norm is not None:
        x = np.asarray(norm.transform(DataSet(x, y)).features)
    return x, y.argmax(1)


def scoring_sizes(requests=None):
    """Each client's request sizes: one image, SC_WIDE every
    SC_WIDE_EVERY-th."""
    requests = SC_REQUESTS if requests is None else requests
    return [SC_WIDE if r % SC_WIDE_EVERY == SC_WIDE_EVERY - 1 else 1
            for r in range(requests)]


def scoring_requests(x, clients=None, requests=None):
    """``x`` cut into each client's requests (SC_CLIENTS of SC_REQUESTS
    by default, sized by :func:`scoring_sizes`), in order."""
    clients = SC_CLIENTS if clients is None else clients
    sizes = scoring_sizes(requests)
    check(len(x) >= clients * sum(sizes),
          f"{len(x)} images for {clients} clients of {sum(sizes)}")
    out, off = [], 0
    for _ in range(clients):
        mine = []
        for s in sizes:
            mine.append(x[off:off + s])
            off += s
        out.append(mine)
    return out


def scoring_traffic(output, reqs, timeout_s=None):
    """Every client of ``reqs`` in its own thread, its requests one after
    another through ``output``, all released together. Returns (each
    request's result by (client, request), each request's seconds, the
    traffic's wall seconds); fails on any error or hang."""
    timeout_s = SC_TIMEOUT_S if timeout_s is None else timeout_s
    results, lat, errors = {}, [], []
    lock = threading.Lock()
    gate = threading.Barrier(len(reqs) + 1)

    def client(c):
        gate.wait()
        for r, x in enumerate(reqs[c]):
            t = time.perf_counter()
            try:
                out = output(x)
            except Exception as e:
                with lock:
                    errors.append((c, r, repr(e)))
                continue
            dt = time.perf_counter() - t
            with lock:
                results[(c, r)] = out
                lat.append(dt)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(len(reqs))]
    for th in threads:
        th.start()
    gate.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout_s)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads),
          "a scoring client hung")
    check(not errors, f"scoring requests failed: {errors[:4]}")
    return results, lat, wall


def scoring_references(net, reqs, every=1):
    """``net.output`` of each request's images alone, by (client,
    request), for every ``every``-th request (by client + request, so
    that each client's sample mixes sizes)."""
    return {(c, r): net.output(x).float().cpu().numpy()
            for c, mine in enumerate(reqs) for r, x in enumerate(mine)
            if (c + r) % every == 0}


def scoring_errors(wants, results):
    """Each request's relative L2 error against its reference, by
    (client, request), over the requests of ``wants`` in ``results``."""
    return {k: rel_l2(results[k], w) for k, w in wants.items()
            if k in results}


def separation(wants):
    """The smallest relative L2 distance from one image's probabilities
    to another's, over every image of ``wants`` (the references' rows):
    a request handed another image's row reads at least this far off."""
    rows = np.concatenate([np.asarray(w, np.float64).reshape(
        len(w), -1) for w in wants.values()])
    sq = np.sum(rows * rows, axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * rows @ rows.T, 0.0)
    np.fill_diagonal(d2, np.inf)
    return float(np.min(np.sqrt(d2) / np.sqrt(sq)[:, None]))


def planted_row_shift(pi, reqs, wants):
    """``reqs`` through ``pi`` with a fault planted in its
    ``_distribute``: each batch's output rows rolled by one, so a request
    gets its neighbour's rows. Returns each request's error against
    ``wants``; the row must catch it."""
    real = pi._distribute

    def shifted(batch, out):
        real(batch, np.roll(np.asarray(out), 1, axis=0))
    pi._distribute = shifted
    try:
        results, _lat, _wall = scoring_traffic(pi.output, reqs)
    finally:
        del pi._distribute
    return scoring_errors(wants, results)


def copy_overlap(trace):
    """From a Chrome trace (a path): the copies between host and card,
    their device µs, and the µs of them that ran while a kernel of
    another stream ran (the overlap the upload and download streams are
    for), with the streams of each."""
    events = [e for e in json.loads(Path(trace).read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels.setdefault(e.get("args", {}).get("stream"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    out = {"copies": 0, "copy_us": 0.0, "under_kernels_us": 0.0,
           "copy_streams": [], "kernel_streams": sorted(
               kernels, key=lambda k: -1 if k is None else k)}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        stream = e.get("args", {}).get("stream")
        others = [iv for k, ivs in kernels.items() if k != stream
                  for iv in ivs if iv[0] < t and iv[1] > s]
        out["copies"] += 1
        out["copy_us"] += t - s
        out["under_kernels_us"] += _union_us(others, s, t)
        if stream not in out["copy_streams"]:
            out["copy_streams"].append(stream)
    return out


def direct_loop(torch, net, reqs, batches=None):
    """images/s of ``net.output`` over host batches of SC_BATCH_LIMIT from
    the traffic's images, each result copied back (what a caller without
    ParallelInference does)."""
    batches = SC_DIRECT_BATCHES if batches is None else batches
    x = np.concatenate([x for mine in reqs for x in mine])
    n = SC_BATCH_LIMIT
    xs = [x[(i * n) % (len(x) - n):][:n] for i in range(batches)]
    net.output(xs[0]).cpu()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for xb in xs:
        net.output(xb).cpu()
    return batches * n / (time.perf_counter() - t)


SC_TURNS = ("inflight_1", "inflight_2", "direct_32")


def scoring_run(torch, reg, version, net, dtype, reqs, smi, every=1,
                capture=False, plant=False, turns=SC_TURNS):
    """Deploy ``net`` (compute type ``dtype``) as ``version`` (every bucket
    warmed) and, for an "inflight_1" turn, as ``version``-if1
    (inflight_limit 1); the traffic through
    the first, every ``every``-th request held to TOL_SCORING against
    ``net.output`` of its images alone, and how far apart those
    references' images lie (:func:`separation`); bucket outcomes over it;
    one profiler window and the copies' overlap in its trace; with
    ``plant``, a row shift planted in ``_distribute``
    (:func:`planted_row_shift`); ``turns`` (of inflight 1, 2 and the
    direct loop), one of each in that order; with ``capture``, a profile
    capture during half the clients' traffic. Returns (the record, the
    deployed version)."""
    from deeplearning4j_tpu_torch.observability import (
        global_profile_capture)
    sample = reqs[0][0][:1]
    row = TOL_SCORING[dtype]
    t = time.perf_counter()
    dv = reg.deploy(version, net, sample_input=sample,
                    batch_limit=SC_BATCH_LIMIT, max_wait_ms=SC_MAX_WAIT_MS)
    deploy_s = time.perf_counter() - t
    dv1 = (reg.deploy(f"{version}-if1", net, sample_input=sample,
                      batch_limit=SC_BATCH_LIMIT,
                      max_wait_ms=SC_MAX_WAIT_MS, inflight_limit=1)
           if "inflight_1" in turns else None)
    hits0 = counter_value("dl4j_inference_bucket_total", outcome="hit")
    miss0 = counter_value("dl4j_inference_bucket_total", outcome="miss")
    batches0 = counter_value("dl4j_inference_batches_total")
    occ0, fill0 = (histogram_mean("dl4j_inference_batch_occupancy"),
                   histogram_mean("dl4j_inference_bucket_fill"))
    results, lat, wall = scoring_traffic(dv.pi.output, reqs)
    occ1, fill1 = (histogram_mean("dl4j_inference_batch_occupancy"),
                   histogram_mean("dl4j_inference_bucket_fill"))
    batches = counter_value("dl4j_inference_batches_total") - batches0
    images = sum(len(x) for mine in reqs for x in mine)
    t = time.perf_counter()
    wants = scoring_references(net, reqs, every)
    errs = scoring_errors(wants, results)
    rec = {"version": version, "dtype": dtype, "gpu": smi,
           "warmup_seconds":
           dv.warmup_seconds, "deploy_seconds": deploy_s,
           "warmed_buckets": dv.warmed_buckets,
           "requests": len(results), "images": images,
           "images_per_s": images / wall,
           "latency_ms_p50": 1e3 * float(np.percentile(lat, 50)),
           "latency_ms_p99": 1e3 * float(np.percentile(lat, 99)),
           "batches": batches,
           "occupancy": (occ1[0] - occ0[0]) / max(1, occ1[1] - occ0[1]),
           "bucket_fill": (fill1[0] - fill0[0]) / max(1, fill1[1] - fill0[1]),
           "bucket_hits": counter_value("dl4j_inference_bucket_total",
                                        outcome="hit") - hits0,
           "bucket_misses": counter_value("dl4j_inference_bucket_total",
                                          outcome="miss") - miss0,
           "checked_requests": len(errs),
           "rel_l2_max": max(errs.values()),
           "rel_l2_median": float(np.median(list(errs.values()))),
           "row": row, "separation": separation(wants),
           "classes_predicted": len({int(a) for w in wants.values()
                                     for a in np.argmax(w, axis=1)}),
           "top_probability_median": float(np.median(np.concatenate(
               [np.max(w, axis=1) for w in wants.values()]))),
           "references_seconds": time.perf_counter() - t}
    small = [mine[:SC_WINDOW_REQUESTS] for mine in reqs[:SC_WINDOW_CLIENTS]]
    b0 = counter_value("dl4j_inference_batches_total")
    prof = profile_window(torch, f"scoring_{dtype}",
                          lambda: scoring_traffic(dv.pi.output, small),
                          f"scoring_{dtype}_trace.json", top=8)
    nb = max(1.0, counter_value("dl4j_inference_batches_total") - b0)
    rec.update({"window_batches": nb,
                "host_ms_per_batch": prof["wall_ms"] / nb,
                "device_ms_per_batch": (prof["device_busy_us"] / 1e3 / nb
                                        if "device_busy_us" in prof
                                        else "not measured"),
                "busy_share": prof.get("busy_share"),
                "kernels_per_batch": (prof["kernels"] / nb
                                      if "kernels" in prof
                                      else "not measured"),
                "copies": copy_overlap(
                    OUT_DIR / f"scoring_{dtype}_trace.json"),
                "top_ops": prof.get("top_ops")})
    if plant:
        perrs = planted_row_shift(dv.pi, small, wants)
        rec["planted_row_shift"] = {
            "requests": len(perrs),
            "over_row": sum(e > row for e in perrs.values()),
            "max_rel_l2": max(perrs.values())}
    runs = {"inflight_1": lambda: scoring_traffic(dv1.pi.output, reqs)[2],
            "inflight_2": lambda: scoring_traffic(dv.pi.output, reqs)[2],
            "direct_32": lambda: images / direct_loop(torch, net, reqs)}
    rec["turns_images_per_s"] = {who: images / runs[who]()
                                 for who in turns}
    rec.update({f"{k}_images_per_s": v
                for k, v in rec["turns_images_per_s"].items()})
    if capture:
        bg = threading.Thread(target=scoring_traffic,
                              args=(dv.pi.output, reqs[:len(reqs) // 2]),
                              daemon=True)
        bg.start()
        cap = global_profile_capture().capture(steps=SC_PROFILE_STEPS,
                                               timeout_s=30.0)
        bg.join(SC_TIMEOUT_S)
        device_s = sum(r["total_seconds"] for r in cap.get("top_ops", []))
        rec["profile_capture"] = {
            "steps_seen": cap["steps_seen"],
            "duration_seconds": cap["duration_seconds"],
            "source": cap.get("source"), "parse_error":
            cap.get("parse_error"), "top_ops_seconds": device_s,
            "top_ops": cap.get("top_ops", [])[:8],
            "modules": cap.get("modules", [])[:4]}
        check(not bg.is_alive(), "the traffic under the capture hung")
        check(cap["steps_seen"] >= SC_PROFILE_STEPS
              and cap.get("source") == "device" and cap.get("top_ops")
              and any(CONV_KERNEL.search(r["op"]) for r in cap["top_ops"])
              and device_s <= cap["duration_seconds"],
              f"(4) the profile capture: {rec['profile_capture']}")
    if dv1 is not None:
        reg.retire(f"{version}-if1")
    return rec, dv


def canary_drill(torch, reg, net_v2, x_check, images, timeout_s=120.0):
    """(3): a FrontDoor with the scoring router on 127.0.0.1 over ``reg``'s
    "v1"; a plain JSON classify of ``x_check`` equal to v1's in-process
    ``ParallelInference.output``; ``net_v2`` deployed as "v2" and walked
    shadow → canary → ramp → full over /admin/rollout while a client
    keeps sending ``images`` (one a request), every shadow comparison a
    match, v2 promoted, v1 retired; "v3" (``net_v2`` again) under the
    serving.canary chaos point rolled back. No client request fails."""
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.serving import FrontDoor, ServingRouter
    router = ServingRouter(reg, "v1")
    fd = FrontDoor(router, host="127.0.0.1", port=0).start()
    addr = fd.get_address()
    sample = x_check[:1]
    rec = {}
    try:
        code, body, _h = http_call(addr, "/v1/classify",
                                   {"inputs": x_check.tolist()})
        inproc = reg.get("v1").pi.output(x_check)
        got = np.asarray(body.get("outputs"), np.float32)
        rec["json_equals_inprocess"] = bool(
            code == 200 and got.shape == inproc.shape
            and np.array_equal(got, inproc))
        check(rec["json_equals_inprocess"],
              f"(3) /v1/classify gave {code} {got.shape}, not "
              f"ParallelInference.output's {inproc.shape} values")
        enc = [json.dumps(x[None].tolist()).encode() for x in images]
        stop = threading.Event()
        sent = []

        def keep_sending():
            j = 0
            while not stop.is_set():
                raw = (b'{"request_key": "bg-%d", "inputs": ' % j
                       + enc[j % len(enc)] + b'}')
                code, body, _h = http_call(addr, "/v1/classify", raw=raw)
                sent.append((code, body.get("version"), j % len(enc),
                             body.get("outputs")))
                j += 1

        def walk(candidate, policy):
            code, ro, _h = http_call(addr, "/admin/rollout",
                                     {"lane": "scoring",
                                      "candidate": candidate,
                                      "policy": policy})
            check(code == 200 and ro["stage"] == "shadow",
                  f"(3) begin_rollout {candidate}: {code} {ro}")
            stages = ["shadow"]
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                _c, snap, _h = http_call(addr, "/debug/frontdoor")
                stage = (snap["scoring"]["rollout"] or {}).get("stage")
                if stage != stages[-1]:
                    stages.append(stage)
                if stage in ("full", "rolled_back"):
                    break
                time.sleep(0.05)
            return stages

        policy = {"start_stage": "shadow", "shadow_fraction": 1.0,
                  "canary_fraction": 0.5, "ramp_fractions": [0.75],
                  "window_requests": 2, "healthy_windows": 1,
                  "min_requests": 2, "min_shadow": 2,
                  "latency_ratio_degraded": None,
                  "latency_ratio_failing": None,
                  "drain_timeout_s": timeout_s}
        bg = threading.Thread(target=keep_sending, daemon=True)
        t = time.perf_counter()
        reg.deploy("v2", net_v2, sample_input=sample,
                   batch_limit=SC_BATCH_LIMIT, max_wait_ms=SC_MAX_WAIT_MS)
        bg.start()
        stages = walk("v2", policy)
        promote_s = time.perf_counter() - t
        primary = router.snapshot()["primary"]
        retired = reg.retire("v1", drain_timeout_s=timeout_s)
        shadow = {o: counter_value("dl4j_serving_shadow_total",
                                   version="v2", outcome=o)
                  for o in ("match", "diverged", "error")}
        reg.deploy("v3", net_v2, sample_input=sample,
                   batch_limit=SC_BATCH_LIMIT, max_wait_ms=SC_MAX_WAIT_MS)
        faults.install(faults.FaultPlan(
            [faults.FaultSpec("serving.canary", "error", rate=1.0)],
            seed=SEED))
        try:
            stages3 = walk("v3", policy)
        finally:
            faults.clear()
        primary3 = router.snapshot()["primary"]
        stop.set()
        bg.join(timeout_s)
        check(not bg.is_alive(), "(3) the background client hung")
        refs = [reg.get(primary3).net.output(x[None]).float().cpu().numpy()
                for x in images]
        failed = [s[:3] for s in sent if s[0] != 200]
        worst_err = max((rel_l2(np.asarray(s[3], np.float32), refs[s[2]])
                         for s in sent if s[0] == 200), default=None)
        rec.update({"v2_stages": stages, "v2_promote_seconds": promote_s,
                    "primary_after_v2": primary, "v1_retired_drained":
                    retired, "shadow": shadow, "v3_stages": stages3,
                    "primary_after_v3": primary3,
                    "requests_during_rollouts": len(sent),
                    "failed": failed, "worst_rel_l2": worst_err,
                    "row": TOL_SCORING["float32"]})
        check(stages[-1] == "full" and "canary" in stages and "ramp" in stages
              and primary == "v2" and retired,
              f"(3) v2's canary walk: {stages}, primary {primary}, v1 "
              f"drained {retired}")
        check(shadow["match"] >= 1 and shadow["diverged"] == 0
              and shadow["error"] == 0, f"(3) v2's shadow scores {shadow}")
        check(stages3[-1] == "rolled_back" and primary3 == "v2",
              f"(3) v3 under serving.canary faults: {stages3}, primary "
              f"{primary3}")
        check(sent and not failed
              and worst_err <= TOL_SCORING["float32"],
              f"(3) requests during the rollouts: {len(sent)} sent, failed "
              f"{failed[:4]}, worst error {worst_err}")
        return rec
    finally:
        fd.stop()


def scoring_phase(torch, smi=None):
    """The fine-tune → serve loop on the card (see SC_* above). Returns
    the port kernels' launches over it (all must be 0)."""
    import os
    import tempfile
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.async_runtime import default_buckets
    from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                               NormalizerStandardize)
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.utils.serialization import ModelSerializer
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    if smi is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    reset_all_counts()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_scoring_")
    root = tmp.name
    reg = ModelRegistry()
    seconds = {}
    try:
        # (1) healing, f32, over a trunk whose BN statistics are set
        # from a batch of its own seed
        t = time.perf_counter()
        tx, ty = transfer_data(NET_BATCH * SC_TRAIN_BATCHES, SEED + 21)
        norm = NormalizerStandardize().fit(DataSet(tx, ty))
        sets = [norm.transform(DataSet(tx[i:i + NET_BATCH],
                                       ty[i:i + NET_BATCH]))
                for i in range(0, len(tx), NET_BATCH)]
        del tx
        source = ResNet50(num_classes=NET_CLASSES, input_shape=NET_SHAPE,
                          updater=Adam(TR_SOURCE_LR),
                          data_type="float32").init_model(device=dev)
        calibrate_bn(torch, source, scoring_images(SC_CALIBRATION,
                                                   SEED + 22, norm)[0])
        healed = resnet_transfer("float32", dev, source=source)
        del source

        def twin():
            c = ComputationGraph(ComputationGraphConfiguration.from_json(
                healed.conf.to_json()), device=dev).init()
            carry_net(healed, c)
            c._frozen = set(healed._frozen)
            return c
        runs = [twin(), twin()]
        frozen0 = {k: {p: v.clone() for p, v in layer.items()}
                   for k, layer in healed.param_tree().items()
                   if k in healed._frozen}
        poisoned = [i for i, kinds in SC_FAULTS.items()
                    if kinds.count("crash") >= 2]
        clean = [s for i, s in enumerate(sets) if i not in poisoned]
        for u in runs:
            u.fit(ListDataSetIterator(clean))
        torch.cuda.synchronize()
        rec = healing_drill(healed, sets, os.path.join(root, "heal"))
        torch.cuda.synchronize()
        want = healing_expected()
        row = tree_max_abs(torch, net_snapshot(runs[0]),
                           net_snapshot(runs[1]))
        err = tree_max_abs(torch, net_snapshot(healed),
                           net_snapshot(runs[0]))
        rec.update({"gpu": smi, "max_abs": err, "undisturbed_max_abs": row,
                    "frozen_changed": unequal_leaves(
                        torch, {k: healed.param_tree()[k] for k in frozen0},
                        frozen0) + unequal_leaves(
                        torch, {k: healed.param_tree()[k] for k in frozen0},
                        {k: runs[0].param_tree()[k] for k in frozen0}),
                    "expected": want})
        emit(scoring_healing=rec)
        check(all(rec[k] == v for k, v in want.items()),
              f"(1) the healing drill counted {rec}, want {want}")
        check(not rec["frozen_changed"], f"(1) frozen leaves moved: "
              f"{rec['frozen_changed'][:4]}")
        check(err <= row, f"(1) the healed net is {err} from an "
              f"undisturbed run, two undisturbed runs {row}")
        del runs
        torch.cuda.empty_cache()
        seconds["healing"] = time.perf_counter() - t

        # (2) scoring, f32 then bf16, on held-out images of every class;
        # (4) the capture under f32 traffic
        t = time.perf_counter()
        hx, _cls = scoring_images(
            SC_CLIENTS * sum(scoring_sizes()), SEED + 31, norm)
        reqs = scoring_requests(hx)
        rec32, _dv = scoring_run(torch, reg, "v1", healed, "float32", reqs,
                                 smi, capture=True, plant=True)
        bf16 = resnet_transfer("bfloat16", dev)
        carry_net(healed, bf16)
        bf16._frozen = set(healed._frozen)
        rec16, _dv = scoring_run(torch, reg, "v1-bf16", bf16, "bfloat16",
                                 reqs, smi, every=SC_BF16_SAMPLE,
                                 turns=("direct_32",))
        reg.retire("v1-bf16")
        del bf16
        for r in (rec32, rec16):
            emit(scoring=r)
            check(r["requests"] == SC_CLIENTS * SC_REQUESTS
                  and r["bucket_misses"] == 0
                  and r["warmed_buckets"] == list(
                      default_buckets(SC_BATCH_LIMIT)),
                  f"(2) {r['version']}: {r['requests']} requests, "
                  f"{r['bucket_misses']} bucket misses after warm-up, "
                  f"warmed {r['warmed_buckets']}")
            check(r["rel_l2_max"] <= r["row"],
                  f"(2) {r['version']}: a request's probabilities are "
                  f"{r['rel_l2_max']} from net.output alone (row "
                  f"{r['row']})")
        # the f32 check tells every image from every other, and catches
        # a row shift planted in _distribute
        check(rec32["separation"] > rec32["row"]
              and rec32["planted_row_shift"]["max_rel_l2"] > rec32["row"],
              f"(2) the f32 check cannot tell requests apart: images "
              f"{rec32['separation']} apart, a planted row shift reads "
              f"{rec32['planted_row_shift']} (row {rec32['row']})")
        seconds["scoring"] = time.perf_counter() - t

        # (3) canary over /v1/classify with the healed net's zip as v2
        t = time.perf_counter()
        path = os.path.join(root, "healed.zip")
        ModelSerializer.write_model(healed, path)
        v2 = ModelSerializer.restore(path)
        check(v2.device.type == "cuda", f"(3) v2 restored on {v2.device}")
        rec3 = canary_drill(torch, reg, v2, reqs[0][0],
                            [mine[0][0] for mine in reqs[:4]])
        rec3["gpu"] = smi
        emit(scoring_canary=rec3)
        seconds["canary"] = time.perf_counter() - t
    finally:
        reg.shutdown()
        tmp.cleanup()
    launches = all_counts()
    emit(scoring_phase_seconds=time.perf_counter() - t_phase,
         scoring_parts_seconds=seconds,
         scoring_launches=dict(zip(ALL_KERNELS, launches)))
    return launches


def scoring_readings(sides=(64, 96), n=64, fits=4):
    """CPU readings for TOL_SCORING at each side of ``sides`` (NET_SHAPE
    cut to it): the scoring phase's recipe (a ResNet-50 whose BN
    statistics are set from SC_CALIBRATION images, ``fits`` batches of
    NET_BATCH fine-tuning its head) and its bf16 copy; for each, ``n``
    held-out images' probabilities in batches of 2-32 against each image
    alone (the largest relative L2 a batch size), 3 images at batch 3
    against the same within 32, the separation of the references, the
    classes predicted and the top probabilities."""
    import torch
    global NET_SHAPE
    from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                               NormalizerStandardize)
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    shape, out = NET_SHAPE, {}
    try:
        for side in sides:
            NET_SHAPE = (side, side, NET_SHAPE[2])
            tx, ty = transfer_data(NET_BATCH * fits, SEED + 21)
            norm = NormalizerStandardize().fit(DataSet(tx, ty))
            src = ResNet50(num_classes=NET_CLASSES, input_shape=NET_SHAPE,
                           updater=Adam(TR_SOURCE_LR),
                           data_type="float32").init_model(device="cpu")
            calibrate_bn(torch, src, scoring_images(SC_CALIBRATION,
                                                    SEED + 22, norm)[0])
            net = resnet_transfer("float32", "cpu", source=src)
            for i in range(0, len(tx), NET_BATCH):
                net.fit(ListDataSetIterator([norm.transform(DataSet(
                    tx[i:i + NET_BATCH], ty[i:i + NET_BATCH]))]))
            bf16 = resnet_transfer("bfloat16", "cpu")
            carry_net(net, bf16)
            hx, _cls = scoring_images(n, SEED + 31, norm)
            for dtype, m in (("float32", net), ("bfloat16", bf16)):
                def probs(x):
                    return m.output(x).float().numpy()
                alone = np.concatenate([probs(hx[i:i + 1])
                                        for i in range(n)])
                rec = {}
                for b in (2, 4, 8, 16, 32):
                    got = np.concatenate([probs(hx[i:i + b])
                                          for i in range(0, n, b)])
                    rec[f"batch_{b}"] = max(rel_l2(got[i], alone[i])
                                            for i in range(n))
                within = probs(hx[:32])
                rec["three_in_32"] = max(
                    rel_l2(within[i:i + 3], probs(hx[i:i + 3]))
                    for i in range(0, 30, 3))
                rec["separation"] = separation(
                    {(i, 0): alone[i:i + 1] for i in range(n)})
                rec["classes_predicted"] = len(set(alone.argmax(1)))
                rec["top_probability"] = [float(alone.max(1).min()),
                                          float(np.median(alone.max(1))),
                                          float(alone.max(1).max())]
                out[f"{dtype}_{side}"] = rec
                emit(scoring_reading={f"{dtype}_{side}": rec})
    finally:
        NET_SHAPE = shape
    return out


def _keeps_f64(net):
    """``net`` (an ``_f64_copy``) taking its float inputs and labels as
    f64 (the port's entry points make floats f32)."""
    import torch

    def to_device(a):
        if a is None:
            return None
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a)
        return t.to(torch.float64) if t.is_floating_point() else t

    net._to_device = to_device
    return net


def zoo_readings(names=("YOLO2", "Xception") + ZOO_NEW_CHECKED,
                 bf16=("YOLO2", "Xception")):
    """CPU readings for the rows of the new zoo models: (a) each model in
    f32 against the same net in f64 at its check batch (``zoo_run`` on
    both, ``zoo_compare``), (b) bf16 against f32 at the same batch for
    ``bf16``'s; the same readings for the three small paths."""
    import torch
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    out = {}
    for name in names:
        x, y = zoo_data(name, ZOO_CHECK_BATCH.get(name, NET_CHECK_BATCH))
        make = (lambda m=name: zoo_model(m, "float32").init_model(
            device="cpu"))
        with shared_dropout():
            net = make()
            base = tree_to_numpy(net.param_tree())
            f64 = _keeps_f64(_f64_copy(net, make))
            truth = zoo_run(f64, x.astype(np.float64), y.astype(np.float64))
            out[f"{name}_f32_vs_f64"] = zoo_compare(
                zoo_run(net, x, y), truth, base, ZOO_FLOOR.get(name, 0.0),
                elementwise(net))
            if name in bf16:
                f32 = make()
                low = zoo_model(name, "bfloat16").init_model(device="cpu")
                carry_net(f32, low)
                l32, g32 = f32.computeGradientAndScore(x, y)
                l16, g16 = low.computeGradientAndScore(x, y)
                head = head_key(f32)
                g32, g16 = tree_to_numpy(g32), tree_to_numpy(g16)
                out[f"{name}_bf16_vs_f32"] = {
                    "probs": rel_l2(train_mode_probs(low, x),
                                    train_mode_probs(f32, x)),
                    "loss": abs(l16 - l32), "loss_rel": abs(l16 - l32)
                    / abs(l32),
                    "head_grad": rel_l2(g16[head]["W"], g32[head]["W"]),
                    "worst_grad_leaf": worst(tree_errors(g16, g32))}
        print(json.dumps({name: {k: v for k, v in out.items()
                                 if k.startswith(name)}}, default=str),
              flush=True)
    x, eps = vae_data()
    net = MultiLayerNetwork(vae_conf(), device="cpu").init()
    base = tree_to_numpy(net.param_tree())
    f64 = _keeps_f64(_f64_copy(net, lambda: MultiLayerNetwork(
        vae_conf(), device="cpu").init()))
    s64, p64 = vae_pretrain_run(f64, x.astype(np.float64),
                                [e.astype(np.float64) for e in eps])
    s32, p32 = vae_pretrain_run(net, x, eps)
    out["vae_pretrain_f32_vs_f64"] = {
        "score_rel": max(abs(a - b) / abs(b) for a, b in zip(s32, s64)),
        "step": worst(tree_errors({"0": p32["0"]}, {"0": p64["0"]},
                                  base={"0": base["0"]}))[0]}
    for kind in ("drop_connect", "deconv"):
        x, y = small_data(kind)
        with shared_drop_connect():
            net = small_net(kind, "cpu")
            base = tree_to_numpy(net.param_tree())
            f64 = _keeps_f64(_f64_copy(net, lambda k=kind: small_net(k,
                                                                      "cpu")))
            truth = small_run(f64, x.astype(np.float64), y.astype(np.float64))
            out[f"{kind}_f32_vs_f64"] = small_compare(small_run(net, x, y),
                                                      truth, base)
    print(json.dumps(out, default=str), flush=True)
    return out


# ---------------------------------------------------------------- attention
# The attention slice (PERF.md's attention rows). A1: a MultiLayerNetwork
# sequence classifier at the widths of bench.py's large config (vocab
# 32768, d_model 1024, 16 heads of 64, T 1024): EmbeddingSequenceLayer →
# SelfAttentionLayer × 2 → GlobalPoolingLayer(avg) under the mask →
# OutputLayer(softmax, mcxent) over 10 classes, batch 8, Nesterovs(1e-2,
# 0.9), a seeded key mask of lengths in [256, 1024], f32 and bf16. A2: the
# other attention modules at small widths (heads of 16-32, T ≤ 128): a
# ComputationGraph of CrossAttentionLayer without and with a key input,
# LearnedSelfAttentionLayer and the three vertices, and a MultiLayerNetwork
# of RecurrentAttentionLayer and a one-head SelfAttentionLayer under a mask
# (a graph hands the recurrent layer no mask, as the reference's).
A1_VOCAB, A1_WIDTH, A1_HEADS, A1_SEQ = 32768, 1024, 16, 1024
A1_BATCH, A1_CLASSES, A1_MIN_LEN = 8, 10, 256
A1_CHECK_BATCH = 2          # (a): the same net on the card and on the CPU
A1_FIT_STEPS = 3
A1_LR, A1_MOMENTUM = 1e-2, 0.9
A2_BATCH, A2_TQ, A2_TK, A2_T = 4, 96, 128, 64
# masked K1/K2 cases: (name, B, H, Tq, Tk, d, dtype, mask). Every operand
# is the (B, H, T, d) view of its own (B, T, H·d) projection, as the
# attention layers hand them over, o the (B, H, Tq, d) view of a (B, Tq,
# H, d) buffer. Masks (``key_mask_np``): "a1" A1's seeded lengths, "gap"
# an interior gap, a masked first 128 keys and ragged lengths, "empty" one
# element that keeps no key, handed over as the op hands it (every key
# kept, q zeroed), "none" the same shape unmasked.
MASKED_CASES = [
    ("a1", 8, 16, 1024, 1024, 64, "bfloat16", "a1"),
    ("a1", 8, 16, 1024, 1024, 64, "float32", "a1"),
    ("a1_unmasked", 8, 16, 1024, 1024, 64, "bfloat16", "none"),
    ("a1_unmasked", 8, 16, 1024, 1024, 64, "float32", "none"),
    ("gap", 4, 16, 300, 700, 64, "bfloat16", "gap"),
    ("gap", 4, 4, 300, 700, 128, "bfloat16", "gap"),
    ("gap", 4, 16, 300, 700, 64, "float32", "gap"),
    ("empty", 4, 16, 256, 256, 64, "bfloat16", "empty"),
    ("empty", 4, 16, 256, 256, 64, "float32", "empty"),
    ("a2", 4, 4, 96, 128, 16, "float32", "gap"),
    ("a2_step", 4, 4, 1, 64, 16, "float32", "gap"),
    ("a2", 4, 2, 96, 128, 32, "bfloat16", "gap"),
]
MASKED_TIMED = ("a1", "a1_unmasked")
MASKED_MAIN_CASE = {"wgmma": MASKED_CASES[0], "simple": MASKED_CASES[1],
                    "bwd_wgmma": MASKED_CASES[0], "bwd": MASKED_CASES[1]}
# (a) A1 and A2 f32 on the card against the same nets on the CPU, carried
# weights: the kernels (the f32 forward's three TF32 products, the FMA
# backward) against their plain versions in f32. Gradients are held over
# all leaves at once ("grad"; ``model_report`` says why) and by the output
# layer's W; "step" is every param's displacement after one step (∝ the
# gradient under Nesterov). Set before the first chip run from CPU readings
# of the nets in f32 against f64 (``a1_readings``, PERF.md): A1 probs
# 5.8e-8, loss 1.9e-7, grad 1.6e-7, head 5.3e-7, step 3.6e-6; A2's graph
# 6.0e-8, 2.8e-8, 3.7e-7, 1.9e-7 and MLN 5.7e-8, 1.1e-7, 2.0e-7, 1.3e-7.
# The card's f32 forward adds its split products' ~1e-6 relative, so the
# rows sit 10-100x over the readings, and far under what a wrong mask
# (O(1)) or a product rounded to TF32 alone (~1e-4) reads.
TOL_A1_F32 = {"probs": 1e-6, "loss": 2e-6, "grad": 5e-5, "head_grad": 5e-5,
              "step": 2e-4}
TOL_A2_F32 = {"probs": 1e-6, "loss": 1e-6, "grad": 5e-5, "head_grad": 5e-5}
# (b) A1 bf16 against f32 on the card, batch 8, the same weights: 30x the
# CPU reading at batch 1 (probs 3.2e-6, loss 2.9e-6, grad 3.5e-4, head
# 6.2e-3; near-uniform probabilities at init keep the first two small);
# from below above (a)'s f32 rows, so a bf16 policy that computed in f32
# fails (the loss, a mean over the batch, is not held from below: its
# bf16 reading sits within 1.5x of (a)'s row)
TOL_A1_BF16 = {"probs": 1e-4, "loss": 1e-4, "grad": 1e-2, "head_grad": 0.1}
FLOOR_A1_BF16 = {k: TOL_A1_F32[k] for k in ("probs", "grad", "head_grad")}


def key_mask_np(kind, b, t_k, seed=SEED):
    """(B, Tk) bool key masks of MASKED_CASES (None for "none")."""
    if kind == "none":
        return None
    rng = np.random.default_rng(seed + t_k)
    low = A1_MIN_LEN if kind == "a1" else max(1, t_k // 2)
    lengths = rng.integers(low, t_k + 1, b)
    m = np.arange(t_k)[None, :] < lengths[:, None]
    if kind == "gap":                     # a masked first tile
        m[0, :min(128, lengths[0] - 1)] = False
        m[1 % b, t_k // 4:t_k // 2] = False   # an interior gap
    if kind == "empty":
        m[1 % b] = False
    return m


def a1_mask(n, seed=SEED):
    """A1's (N, T) f32 feature mask: lengths in [A1_MIN_LEN, T]."""
    return key_mask_np("a1", n, A1_SEQ, seed).astype(np.float32)


def masked_case_inputs(torch, case, seed=SEED):
    """q, k, v (views of projections), the key mask on the card (for an
    "empty" case with the op's handling applied), o's view, dO and three
    views that receive dq, dk, dv, all as the attention layers lay them
    out."""
    _name, b, h, t_q, t_k, d, dtype, kind = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(
        seed + b * 7919 + t_q * 101 + t_k + d)
    c = h * d

    def proj(t):
        return torch.randn((b, t, c), generator=g, device="cuda",
                           dtype=dt).view(b, t, h, d).transpose(1, 2)

    q, k, v, do = proj(t_q), proj(t_k), proj(t_k), proj(t_q)
    m = key_mask_np(kind, b, t_k, seed)
    kmask = None if m is None else torch.as_tensor(m, device="cuda")
    if kind == "empty":
        kept = kmask.any(dim=-1)
        kmask = kmask | ~kept[:, None]
        q = q * kept[:, None, None, None].to(dt)
    out = torch.empty((b, t_q, h, d), device="cuda", dtype=dt).transpose(1, 2)
    grads = tuple(torch.empty((b, t, h, d), device="cuda", dtype=dt)
                  .transpose(1, 2) for t in (t_q, t_k, t_k))
    return q, k, v, kmask, out, do, grads


def masked_bound_ms(kmask, h, t_q, t_k, d, dtype, backward=False):
    """Least time of one masked call: the FLOPs of the pairs this mask
    keeps (4·d a pair forward, 10·d backward, as ``attention_bound_ms``)
    over the type's peak, against q, k, v (o, dO), the mask's bytes and
    the outputs read or written once over the memory rate."""
    itemsize = 2 if dtype == "bfloat16" else 4
    b, kept = kmask.shape[0], int(kmask.sum())
    flops = (10.0 if backward else 4.0) * h * d * t_q * kept
    tensors = 4 * (t_q + t_k) if backward else 2 * (t_q + t_k)
    nbytes = itemsize * b * h * d * tensors + 4 * b * h * t_q + b * t_k
    return _bound(flops, nbytes, dtype, ATTN_PEAK_FLOPS)


def masked_kernel_phase(torch, fa):
    """Masked K1 and K2 against their plain versions at MASKED_CASES (by
    the K1/K2 rows: TOL_O, TOL_LSE, TOL_GRAD and the 64-row tiles'
    relative L2), masked keys' dk and dv exactly 0; at MASKED_TIMED, ms
    and device ms of each direction beside the plain versions, the bound
    of the kept pairs and SDPA with the additive -1e30 mask (forward, and
    forward and backward)."""
    import torch.nn.functional as F
    rows = {}
    for case in MASKED_CASES:
        name, b, h, t_q, t_k, d, dtype, kind = case
        q, k, v, kmask, out, do, grads = masked_case_inputs(torch, case)
        path = fa.kernel_for(q.dtype, d)
        reset_counts(fa)
        o, lse = fa.flash_attention_fwd(q, k, v, out=out, kmask=kmask)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, out=grads,
                                     kmask=kmask)
        torch.cuda.synchronize()
        want = ((1, 0, 1, 0) if path == "wgmma" else (0, 1, 0, 1))
        check(counts(fa) == want and o.data_ptr() == out.data_ptr()
              and all(x is y for x, y in zip(got, grads)),
              f"masked {case}: launched {counts(fa)}, want {want}, or did "
              f"not write into the caller's views")
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, kmask=kmask)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err_o) and err_o <= TOL_O[dtype]
              and math.isfinite(err_lse) and err_lse <= TOL_LSE,
              f"masked K1 {case}: max |do| {err_o}, |dlse| {err_lse}")
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                               kmask=kmask)
        errs, tile_l2 = {}, {}
        for gname, x, r in zip(("dq", "dk", "dv"), got, ref):
            err = (x.float() - r.float()).abs().max().item()
            limit = TOL_GRAD[dtype] * max(1.0, r.float().abs().max().item())
            tile_l2[gname] = tile_rel_l2(x, r, GRAD_RMS_FLOOR[dtype])
            check(math.isfinite(err) and err <= limit
                  and tile_l2[gname] <= TOL_GRAD_TILE_L2[dtype],
                  f"masked K2 {case}: {gname} max |d| {err} > {limit} or "
                  f"a tile's relative L2 {tile_l2[gname]}")
            errs[gname] = err
        gone = 0.0
        if kmask is not None:
            kept = kmask[:, None, :, None]
            gone = max(float(g.float().masked_fill(kept, 0).abs().max())
                       for g in got[1:])
        check(gone == 0.0, f"masked K2 {case}: a masked key's dk or dv "
              f"reads {gone}")
        row = {"name": name, "path": path, "b": b, "h": h, "t_q": t_q,
               "t_k": t_k, "d": d, "dtype": dtype, "mask": kind,
               "kept_keys": (None if kmask is None
                             else int(kmask.sum().item())),
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "max_abs_err_grad": errs, "max_tile_rel_l2": tile_l2}
        if name in MASKED_TIMED:
            q4, k4, v4 = (x.detach() for x in (q, k, v))
            add = None
            if kmask is not None:
                add = torch.zeros(kmask.shape, device="cuda",
                                  dtype=q.dtype).masked_fill(~kmask, -1e30)
                add = add[:, None, None, :]

            def fwd():
                fa.flash_attention_fwd(q, k, v, out=out, kmask=kmask)

            def bwd():
                fa.flash_attention_bwd(q, k, v, o, lse, do, out=grads,
                                       kmask=kmask)

            def library():
                F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add)

            def library_fwd_bwd():
                xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
                y = F.scaled_dot_product_attention(*xs, attn_mask=add)
                torch.autograd.grad(y, xs, do)

            if kmask is not None:
                bound, bound_by = masked_bound_ms(kmask.cpu().numpy(), h,
                                                  t_q, t_k, d, dtype)
                bwd_bound, bwd_by = masked_bound_ms(
                    kmask.cpu().numpy(), h, t_q, t_k, d, dtype, True)
            else:
                bound, bound_by = attention_bound_ms(b * h, t_q, t_k, d,
                                                     dtype, False)
                bwd_bound, bwd_by = attention_bwd_bound_ms(
                    b * h, t_q, t_k, d, dtype, False)
            row.update({
                "ms": time_ms(fwd, torch), "device_ms": device_ms(fwd, torch),
                "bwd_ms": time_ms(bwd, torch),
                "bwd_device_ms": device_ms(bwd, torch),
                "plain_ms": time_ms(lambda: fa.flash_attention_reference(
                    q, k, v, kmask=kmask), torch, iters=3, repeats=3),
                "bwd_plain_ms": time_ms(
                    lambda: fa.flash_attention_bwd_reference(
                        q, k, v, o, lse, do, kmask=kmask), torch, iters=3,
                    repeats=3),
                "library_ms": time_ms(library, torch),
                "library_device_ms": device_ms(library, torch),
                "library_fwd_bwd_ms": time_ms(library_fwd_bwd, torch),
                "library_fwd_bwd_device_ms": device_ms(library_fwd_bwd,
                                                       torch),
                "bound_ms": bound, "bound_by": bound_by,
                "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by})
            row["library_bwd_device_ms"] = (row["library_fwd_bwd_device_ms"]
                                            - row["library_device_ms"])
        emit(masked_kernel_case=row)
        rows[case] = row
    return rows


def a1_conf(data_type):
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    return (NeuralNetConfiguration.builder().seed(SEED)
            .updater(Nesterovs(A1_LR, momentum=A1_MOMENTUM))
            .data_type(data_type).weight_init("xavier").list()
            .layer(L.EmbeddingSequenceLayer(n_in=A1_VOCAB, n_out=A1_WIDTH,
                                            input_length=A1_SEQ))
            .layer(L.SelfAttentionLayer(n_heads=A1_HEADS))
            .layer(L.SelfAttentionLayer(n_heads=A1_HEADS))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=A1_CLASSES, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(InputType.recurrent(1, A1_SEQ)).build())


def a1_net(data_type, dev):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(a1_conf(data_type), device=dev).init()


def a1_data(n, seed=SEED):
    """(token ids (N, T) int64, one-hot labels, the (N, T) mask)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, A1_VOCAB, (n, A1_SEQ)).astype(np.int64)
    y = np.eye(A1_CLASSES, dtype=np.float32)[rng.integers(0, A1_CLASSES, n)]
    return x, y, a1_mask(n, seed=seed)


def a2_graph_conf():
    """A2's graph: inputs q (N, 96, 64), kv (N, 128, 64), key (N, 128,
    32); cross attention (4 heads of 16) over kv, cross attention with a
    key input and biases (2 heads of 32), a learned bank of 96 queries
    (4 heads of 16) over kv, the dot-product vertex (cross over kv), the
    causal additive vertex (cross_k over learned), the dot vertex of the
    two, merged, pooled, a softmax output of 5."""
    from deeplearning4j_tpu_torch.nn import graph_conf as gc
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    return (NeuralNetConfiguration.builder().seed(SEED)
            .updater(Nesterovs(A1_LR, momentum=A1_MOMENTUM))
            .weight_init("xavier").graph_builder()
            .add_inputs("q", "kv", "key")
            .set_input_types(InputType.recurrent(64, A2_TQ),
                             InputType.recurrent(64, A2_TK),
                             InputType.recurrent(32, A2_TK))
            .add_layer("cross", L.CrossAttentionLayer(n_heads=4), "q", "kv")
            .add_layer("cross_k", L.CrossAttentionLayer(
                n_heads=2, qkv_bias=True), "q", "kv", "key")
            .add_layer("learned", L.LearnedSelfAttentionLayer(
                n_heads=4, n_queries=A2_TQ), "kv")
            .add_vertex("dpa", gc.DotProductAttentionVertex(), "cross", "kv")
            .add_vertex("add", gc.AdditiveAttentionVertex(causal=True),
                        "cross_k", "learned")
            .add_vertex("dot", gc.DotVertex(axes=2), "dpa", "add")
            .add_vertex("merge", gc.MergeVertex(), "dpa", "add", "dot")
            .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"),
                       "merge")
            .add_layer("out", L.OutputLayer(n_out=5, activation="softmax",
                                            loss_function="mcxent"), "pool")
            .set_outputs("out").build())


def a2_mln_conf():
    """A2's MultiLayerNetwork: RecurrentAttentionLayer (32 → 64, 4 heads
    of 16, tanh) and a one-head SelfAttentionLayer without projections
    (d 64) under the mask, pooled, a softmax output of 5."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs
    return (NeuralNetConfiguration.builder().seed(SEED)
            .updater(Nesterovs(A1_LR, momentum=A1_MOMENTUM))
            .weight_init("xavier").list()
            .layer(L.RecurrentAttentionLayer(n_out=64, n_heads=4,
                                             activation="tanh"))
            .layer(L.SelfAttentionLayer(project_input=False))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=5, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(InputType.recurrent(32, A2_T)).build())


def a2_data(seed=SEED):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    graph_in = (f(A2_BATCH, A2_TQ, 64), f(A2_BATCH, A2_TK, 64),
                f(A2_BATCH, A2_TK, 32))
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, A2_BATCH)]
    mask = key_mask_np("gap", A2_BATCH, A2_T, seed).astype(np.float32)
    return graph_in, f(A2_BATCH, A2_T, 32), labels, mask


def a2_nets(dev):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return (ComputationGraph(a2_graph_conf(), device=dev).init(),
            MultiLayerNetwork(a2_mln_conf(), device=dev).init())


def model_report(net, ref, x, y, mask, base=None):
    """Check (a)'s readings of ``net`` against ``ref`` (a dict from the
    same computation on the other device or in f64): probabilities'
    relative L2, |Δloss|, the worst gradient leaf and, with ``base``,
    the worst param displacement after one step; plus the raw readings
    of ``net`` (numpy) for use as a ``ref``."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    graph = isinstance(x, tuple)
    probs = (net.output(*x) if graph else net.output(x, mask=mask))
    loss, grads = (net.computeGradientAndScore(x, y) if graph else
                   net.computeGradientAndScore(x, y, mask=mask))
    out = {"probs": probs.float().cpu().numpy(), "loss": loss,
           "grads": tree_to_numpy(grads)}
    if base is not None:
        from deeplearning4j_tpu_torch.data import DataSet
        net.fit(DataSet(x, y, mask, None))
        out["params"] = tree_to_numpy(net.param_tree())
    if ref is None:
        return out
    # a key projection's bias shifts every key of a query alike, and the
    # softmax does not see it: its gradient is 0 in exact arithmetic, so
    # it is read by its largest entry, not held relatively
    # it is read by its largest entry, not held relatively. The gradients
    # are held over all leaves at once ("grad"): the queries' and keys'
    # projections of a layer whose softmax is near uniform (random
    # weights) have gradients that cancel far below their terms, whose
    # rounding then reads as a large relative error of that leaf alone
    # (reported, "worst_leaf")
    def flat(tree, base=None):
        return np.concatenate([
            (tree[k][p] - (base[k][p] if base is not None else 0)).ravel()
            for k in sorted(tree) for p in sorted(tree[k]) if p != "bk"])

    head = head_key(net)
    g_err = {k: e for k, e in tree_errors(out["grads"], ref["grads"]).items()
             if not k.endswith("/bk")}
    rep = {"probs": rel_l2(out["probs"], ref["probs"]),
           "loss": abs(loss - ref["loss"]),
           "grad": rel_l2(flat(out["grads"]), flat(ref["grads"])),
           "head_grad": rel_l2(out["grads"][head]["W"],
                               ref["grads"][head]["W"]),
           "worst_leaf": worst(g_err),
           "bk_grad_max_abs": max([float(np.abs(g["bk"]).max())
                                   for g in out["grads"].values()
                                   if "bk" in g] or [0.0])}
    if base is not None:
        rep["step"] = rel_l2(flat(out["params"], base),
                             flat(ref["params"], base))
    return rep


def _f64_copy(net, make):
    """A net built by ``make()`` on the CPU carrying ``net``'s params as
    f64 (its updater state fresh): the readings' truth."""
    import torch
    twin = make()
    twin.set_param_tree(net.param_tree())
    twin._params = {k: {p: v.double() for p, v in layer.items()}
                    for k, layer in twin._params.items()}
    twin._opt_state = twin._opt.init(twin._leaves())
    return twin


def a1_readings(batch=1):
    """CPU readings for (a)'s rows: A1 (at ``batch``) and A2 in f32
    against the same nets in f64 (the attention op's plain route in f64,
    its kernels' plain versions in f32), the same readings (a) takes; and
    A1 bf16 against f32 for (b)."""
    import torch
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    out = {}
    x, y, m = a1_data(batch)
    net = a1_net("float32", "cpu")
    base = tree_to_numpy(net.param_tree())
    f64 = _f64_copy(net, lambda: a1_net("float32", "cpu"))
    truth = model_report(f64, None, x, y.astype(np.float64),
                         m.astype(np.float64), base)
    out["a1_f32_vs_f64"] = model_report(net, truth, x, y, m, base)
    bf16 = a1_net("bfloat16", "cpu")
    f32 = a1_net("float32", "cpu")
    ref = model_report(f32, None, x, y, m)
    out["a1_bf16_vs_f32"] = model_report(bf16, ref, x, y, m)
    graph_in, xr, yl, mr = a2_data()
    for label, net in zip(("a2_graph", "a2_mln"), a2_nets("cpu")):
        make = (lambda i=label: a2_nets("cpu")[0 if i == "a2_graph" else 1])
        f64 = _f64_copy(net, make)
        xs = (graph_in if label == "a2_graph" else xr)
        x64 = (tuple(a.astype(np.float64) for a in xs)
               if label == "a2_graph" else xs.astype(np.float64))
        truth = model_report(f64, None, x64, yl.astype(np.float64),
                             None if label == "a2_graph"
                             else mr.astype(np.float64))
        out[f"{label}_f32_vs_f64"] = model_report(
            net, truth, xs, yl, None if label == "a2_graph" else mr)
    return out


def plain_a1(torch):
    """The yardstick: A1 in plain PyTorch modules (``nn.Embedding``,
    ``nn.Linear`` projections, SDPA with the additive -1e30 key mask,
    the masked mean, ``nn.Linear`` head), SGD(Nesterov). Never on the
    port's path."""
    nn = torch.nn

    class Twin(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(A1_VOCAB, A1_WIDTH)
            self.proj = nn.ModuleList(
                nn.ModuleList(nn.Linear(A1_WIDTH, A1_WIDTH, bias=False)
                              for _ in range(4)) for _ in range(2))
            self.head = nn.Linear(A1_WIDTH, A1_CLASSES)

    return Twin()


def plain_a1_step(torch, model, opt, bf16):
    import torch.nn.functional as F
    hs = A1_WIDTH // A1_HEADS

    def step(x, y, m):
        n, t = x.shape
        add = torch.zeros(m.shape, device=m.device).masked_fill(
            m == 0, -1e30)[:, None, None, :]
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            h = model.emb(x)
            for wq, wk, wv, wo in model.proj:
                q, k, v = (w(h).view(n, t, A1_HEADS, hs).transpose(1, 2)
                           for w in (wq, wk, wv))
                a = F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=add.to(q.dtype))
                h = wo(a.transpose(1, 2).reshape(n, t, A1_WIDTH))
            mm = m[..., None].to(h.dtype)
            pooled = (h * mm).sum(1) / mm.sum(1).clamp_min(1.0)
        loss = F.cross_entropy(model.head(pooled.float()), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss
    return step


def attention_timing(torch, dev, smi):
    """A1 at batch 8: host ms a step, sequences/s, tokens/s, device ms,
    busy share, kernels a step and the flash kernels' share (a profiler
    window of NET_PROFILED steps), own peak memory; bf16 then f32, in turns
    with the plain twin (port, plain, plain, port)."""
    from deeplearning4j_tpu_torch.data import DataSet
    x, y, m = a1_data(A1_BATCH, seed=SEED + 1)
    xd, yd, md = (torch.as_tensor(a, device=dev) for a in (x, y, m))
    ds = DataSet(xd, yd, md, None)
    rows = []
    for dtype in ("bfloat16", "float32"):
        bf16 = dtype == "bfloat16"
        net = a1_net(dtype, dev)
        twin = plain_a1(torch).to(dev)
        opt = torch.optim.SGD(twin.parameters(), lr=A1_LR,
                              momentum=A1_MOMENTUM, nesterov=True)
        tstep = plain_a1_step(torch, twin, opt, bf16)
        runs = {"port": lambda: net.fit(ds),
                "plain": lambda: tstep(xd, yd, md)}
        timed, peaks = {"port": [], "plain": []}, {}
        for who in ("port", "plain", "plain", "port"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms, _all = step_timing(torch, runs[who])
            peaks[who] = max(peaks.get(who, 0),
                             torch.cuda.max_memory_allocated() - before)
            timed[who].append(ms)
        flops = net.step_cost(A1_BATCH)[0]
        for who in ("port", "plain"):
            p = profile_window(
                torch, f"attention_{who}_{dtype}",
                lambda f=runs[who]: [f() for _ in range(NET_PROFILED)],
                f"attention_{who}_{dtype}_trace.json", top=12)
            ms = statistics.median(timed[who])
            busy = p.get("device_busy_us")
            att_us = sum(k["us"] for k in p.get("attention_kernels") or [])
            rows.append({
                "model": who, "dtype": dtype, "gpu": smi,
                "host_ms_per_step": ms, "turns_ms": timed[who],
                "sequences_per_s": A1_BATCH / (ms / 1e3),
                "tokens_per_s": A1_BATCH * A1_SEQ / (ms / 1e3),
                "kept_tokens": int(m.sum()),
                "tflops_per_s": flops / (ms / 1e3) / 1e12,
                "device_ms_per_step": (busy / 1e3 / NET_PROFILED
                                       if busy is not None else None),
                "busy_share": p.get("busy_share"),
                "kernels_per_step": (p["kernels"] / NET_PROFILED
                                     if "kernels" in p else None),
                "flash_share": (att_us / busy if busy else None),
                "own_peak_bytes": peaks[who],
                "top_ops": p.get("top_ops"),
                "top_kernels": p.get("top_kernels")})
        del net, twin, opt, runs
        torch.cuda.empty_cache()
    for r in rows:
        emit(attention_timing=r)
    return rows


def attention_phase(torch, fa):
    """The attention slice on the card: masked K1/K2 against their plain
    versions (``masked_kernel_phase``); (a) A1 f32 on the card against the
    same net on the CPU at A1_CHECK_BATCH (TOL_A1_F32); A1 in bf16 and f32
    at batch 8: A1_FIT_STEPS masked fits and ``output``, the loss finite,
    the flash kernels launched once a layer each way (bf16: the wgmma
    pair, f32: the simple forward and the mma.sync / FMA backward), the
    op's plain route never; (b) bf16 against f32 (TOL_A1_BF16 from above,
    FLOOR_A1_BF16 from below); A2's nets f32 on the card against the CPU
    (TOL_A2_F32), with their launches; then the timings in turns with the
    plain twin. Returns (the masked rows, A1's launches, A2's)."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    masked = masked_kernel_phase(torch, fa)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()

    # (a) A1 f32, card against CPU
    x, y, m = a1_data(A1_CHECK_BATCH)
    cpu = a1_net("float32", "cpu")
    base = tree_to_numpy(cpu.param_tree())
    card = a1_net("float32", dev)
    carry_net(cpu, card)
    cpu_out = model_report(cpu, None, x, y, m, base)
    rep = model_report(card, cpu_out, x, y, m, base)
    failed = rows_failed(rep, TOL_A1_F32)
    emit(a1_card_vs_cpu=rep, rows=TOL_A1_F32, failed=failed)
    check(not failed, f"(a) A1 f32 card vs CPU above its rows: {failed}")
    del cpu, card, cpu_out

    # A1 at batch 8, each dtype: masked fits and output, the path's launches
    x, y, m = a1_data(A1_BATCH)
    ds = DataSet(x, y, m, None)
    launches = {}
    for dtype in ("bfloat16", "float32"):
        net = a1_net(dtype, dev)
        net.score_every = 1
        reset_all_counts()
        losses = []
        for _ in range(A1_FIT_STEPS):
            net.fit(ds)
            losses.append(net.score())
        probs = net.output(x, mask=m)
        torch.cuda.synchronize()
        launches[dtype] = all_counts()
        fwd, bwd = (("wgmma", "bwd_wgmma") if dtype == "bfloat16"
                    else ("simple", "bwd"))
        layers = 2
        want = launch_counts(**{fwd: layers * (A1_FIT_STEPS + 1),
                                bwd: layers * A1_FIT_STEPS})
        emit(a1_fit={"dtype": dtype, "losses": losses,
                     "probs_shape": list(probs.shape),
                     "launches": dict(zip(ALL_KERNELS, launches[dtype]))})
        check(all(math.isfinite(v) for v in losses)
              and tuple(probs.shape) == (A1_BATCH, A1_CLASSES)
              and bool(torch.isfinite(probs).all()),
              f"A1 {dtype}: losses {losses}, output {tuple(probs.shape)}")
        check(launches[dtype] == want,
              f"A1 {dtype} launched {dict(zip(ALL_KERNELS, launches[dtype]))}"
              f", want {dict(zip(ALL_KERNELS, want))}")
        del net

    # (b) bf16 against f32, the same weights, batch 8
    f32, bf16 = a1_net("float32", dev), a1_net("bfloat16", dev)
    carry_net(f32, bf16)
    ref = model_report(f32, None, x, y, m)
    rep_b = model_report(bf16, ref, x, y, m)
    failed = rows_failed(rep_b, TOL_A1_BF16)
    too_close = floors_failed(rep_b, FLOOR_A1_BF16)
    emit(a1_bf16_vs_f32=rep_b, rows=TOL_A1_BF16, failed=failed,
         floors=FLOOR_A1_BF16, floors_failed=too_close)
    check(not failed, f"(b) A1 bf16 vs f32 above its rows: {failed}")
    check(not too_close, f"(b) A1 bf16 reads as close to f32 as f32 does: "
          f"{too_close}")
    del f32, bf16
    torch.cuda.empty_cache()

    # A2, f32, card against CPU, and its launches
    graph_in, xr, yl, mr = a2_data()
    cpu_nets, card_nets = a2_nets("cpu"), a2_nets(dev)
    reset_all_counts()
    a2_rows = {}
    for label, cpu_net, card_net, xs, mask in (
            ("graph", cpu_nets[0], card_nets[0], graph_in, None),
            ("mln", cpu_nets[1], card_nets[1], xr, mr)):
        carry_net(cpu_net, card_net)
        cpu_out = model_report(cpu_net, None, xs, yl, mask)
        a2_rows[label] = model_report(card_net, cpu_out, xs, yl, mask)
    a2_launches = all_counts()
    failed = {k: rows_failed(r, TOL_A2_F32) for k, r in a2_rows.items()}
    emit(a2_card_vs_cpu=a2_rows, rows=TOL_A2_F32, failed=failed,
         a2_launches=dict(zip(ALL_KERNELS, a2_launches)))
    check(not any(failed.values()),
          f"A2 f32 card vs CPU above its rows: {failed}")
    named_a2 = dict(zip(ALL_KERNELS, a2_launches))
    check(named_a2["simple"] > 0 and named_a2["bwd"] > 0
          and sum(n for k, n in named_a2.items()
                  if k not in ("simple", "bwd")) == 0,
          f"A2 launched off its path: {named_a2}")
    del cpu_nets, card_nets

    timing = attention_timing(torch, dev, smi)
    a1 = tuple(a + b for a, b in zip(launches["bfloat16"],
                                      launches["float32"]))
    emit(attention_phase_seconds=time.perf_counter() - t_phase,
         attention_launches=dict(zip(ALL_KERNELS, a1)))
    return masked, timing, a1, a2_launches


def masked_kernel_entry(path, rows):
    """The masked rows' fields of a flash kernel's entry in the kernels
    line, at MASKED_MAIN_CASE[path] (A1's shape)."""
    main = rows[MASKED_MAIN_CASE[path]]
    unmasked = next(r for r in rows.values()
                    if r["name"] == "a1_unmasked"
                    and r["dtype"] == main["dtype"])
    bwd = path.startswith("bwd")
    fwd_path = {"bwd_wgmma": "wgmma", "bwd": "simple"}.get(path, path)
    mine = [r for r in rows.values() if r["path"] == fwd_path]
    key = "bwd_" if bwd else ""
    errs = ([e for r in mine for e in r["max_abs_err_grad"].values()] if bwd
            else [r["max_abs_err_o"] for r in mine])
    return {"max_abs_err": max(errs),
            "ms": main[f"{key}ms"], "device_ms": main[f"{key}device_ms"],
            "plain_ms": main[f"{key}plain_ms"],
            "bound_ms": main[f"{key}bound_ms"],
            "bound_by": main[f"{key}bound_by"],
            "library_ms": (main["library_fwd_bwd_ms"] if bwd
                           else main["library_ms"]),
            "library_device_ms": (main["library_bwd_device_ms"] if bwd
                                  else main["library_device_ms"]),
            "unmasked_device_ms": unmasked[f"{key}device_ms"],
            "at": dict(zip(("name", "b", "h", "t_q", "t_k", "d", "dtype",
                            "mask"), MASKED_MAIN_CASE[path]))}


# ---------------------------------------------------------------- recurrent
# The char-RNNs of PERF.md's recurrent rows. R1: the zoo TextGenerationLSTM
# at its full width (2 × LSTM(256), RnnOutputLayer softmax/mcxent over 47
# characters, Adam(1e-3), TBPTT 50). R2: BASELINE.json configs[2], the
# GravesLSTM char-RNN, at the layer width, minibatch, example length and
# TBPTT length of dl4j-examples' GravesLSTMCharModellingExample (200, 32,
# 1000, 50), built through ListBuilder (seed 12345, xavier, l2 1e-4,
# Adam(5e-3)). R3: R1's layers as a ComputationGraph. R4: a masked
# sequence classifier, Bidirectional(LSTM 256, concat) →
# LastTimeStepVertex → OutputLayer, batch 32, T 200, lengths 50-200.
RNN_CHARS = 47
RNN_BATCH = 32
RNN_SEQ = 1000             # characters a sequence: one fit is 20 chunks
RNN_TBPTT = 50
RNN_WIDTH = {"R1": 256, "R2": 200}
R1_LR, R2_LR, R2_L2 = 1e-3, 5e-3, 1e-4
R4_T, R4_CLASSES, R4_LENS = 200, 5, (50, 200)
RNN_STREAM_STEPS = 200     # (c): one character a call
RNN_SAMPLE_CHARS = 300     # rnnTimeStep sampling at batch 1
# K11 alone (b): (N, H, peepholes, masked) at R1's and R2's shapes
K11_CASES = [(RNN_BATCH, h, peep, masked) for h in (256, 200)
             for peep in (False, True) for masked in (False, True)]
K11_MAIN_CASE = (RNN_BATCH, 256, False, False)     # R1's cell
# K11L alone (b'): the whole layer over a chunk, (N, H, peepholes, masked)
# at R1's and R2's layer shapes, T = RNN_TBPTT
K11L_CASES = K11_CASES
K11L_MAIN_CASE = K11_MAIN_CASE                     # R1's second layer
# the wide layer past K11L's widest (H 512, one chunk): the per-step route
WIDE_LAYER = (RNN_BATCH, 512)
# (a) R1 and R2 in f32, card against CPU over one fit: the fitted nets'
# output on the first chunk (relative L2), each chunk's loss (largest
# |Δ|; a loss is ~190), each leaf's displacement (relative L2 of the
# worst leaf) and the final carries (relative L2, worst of h and c over
# both layers). Set from CPU readings of f32 against f64 (rnn_readings):
# R1 1.0e-7, 1.8e-5, 1.1e-5, 1.0e-6; R2 1.0e-7, 2.7e-5, 8.2e-6, 4.7e-6.
# Two f32 runs read up to twice that apart; the rows sit 3.7-10× above
# the readings. A control whose products round to TF32 must read above.
TOL_RNN_F32 = {"probs": 1e-6, "loss": 2e-4, "step": 1e-4, "carry": 3e-5}
# (b) K11f / K11b against their plain versions: max |Δ| over
# max(1, max |plain|) (test_torch_kernels_gpu.py's K11 rows)
TOL_K11 = {"fwd": 4e-6, "bwd": 1e-5}
# (b') K11Lf / K11Lb against their plain versions (the reference's loop,
# addmm and the plain cell) over the chunk, every output: max |Δ| over
# max(1, max |plain|). Set before the first chip run from CPU readings of
# the plain layer in f32 against f64 (k11l_readings: 32 draws at
# K11L_CASES, ≤ 1.8e-6 forward, ≤ 7.2e-7 backward): two f32 sums in other
# orders read up to twice that, and the cell's elementwise part K11's rows
TOL_K11L = {"fwd": 1e-5, "bwd": 1e-5}
# the wide layer (K11 a step) against the plain versions: relative L2 of
# the output, carries and every gradient (the card test's f32 row)
TOL_WIDE_LAYER = 1e-5
# (c) rnnTimeStep one character at a time against output() over the
# sequence: f32 sums of the same products in another batching
TOL_RNN_STREAM = 1e-5
# (d) R1 bf16 against f32 on the card, same weights: the output on the
# first chunk before any fit (relative L2) and each chunk's loss over one
# fit (largest |Δ|). CPU readings 3.0e-4 and 9.2e-3 (the hidden layers'
# params round to bf16, and the first layer's x·W); rows 10× those. From
# below, above (a)'s rows, which two f32 runs meet: a bf16 policy that
# computed in f32 fails.
TOL_RNN_BF16 = {"loss": 0.1, "probs": 3e-3}
FLOOR_RNN_BF16 = {"loss": TOL_RNN_F32["loss"],
                  "probs": TOL_RNN_F32["probs"]}
# (e) R3 (the graph) against R1 (the sequential net): the same products
# in the same order; R4's masked rows against each row alone, unpadded:
# other GEMM shapes, f32 sums in another order
TOL_RNN_GRAPH = {"r3_loss": 1e-5, "r4_alone": 1e-5}


def char_stream(n, t, seed=SEED):
    """(x, y): ``n`` sequences of ``t`` one-hot characters of a seeded
    first-order Markov chain over RNN_CHARS (each character's successor
    drawn from a Dirichlet(0.1) row), and the same shifted by one."""
    rng = np.random.default_rng(seed)
    cum = rng.dirichlet(np.full(RNN_CHARS, 0.1), size=RNN_CHARS).cumsum(1)
    idx = np.empty((n, t + 1), np.int64)
    idx[:, 0] = rng.integers(0, RNN_CHARS, n)
    u = rng.random((n, t))
    for k in range(t):
        idx[:, k + 1] = np.minimum(
            (u[:, k, None] > cum[idx[:, k]]).sum(1), RNN_CHARS - 1)
    eye = np.eye(RNN_CHARS, dtype=np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]]


def r1_model(data_type="float32"):
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    return TextGenerationLSTM(total_unique_characters=RNN_CHARS,
                              tbptt_length=RNN_TBPTT,
                              updater=Adam(R1_LR), data_type=data_type)


def r2_conf(data_type="float32"):
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        BackpropType, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (GravesLSTM,
                                                         RnnOutputLayer)
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    w = RNN_WIDTH["R2"]
    return (NeuralNetConfiguration.builder().seed(12345).l2(R2_L2)
            .weight_init("xavier").updater(Adam(R2_LR))
            .data_type(data_type).list()
            .layer(GravesLSTM(n_in=RNN_CHARS, n_out=w, activation="tanh"))
            .layer(GravesLSTM(n_out=w, activation="tanh"))
            .layer(RnnOutputLayer(n_out=RNN_CHARS, activation="softmax",
                                  loss_function="mcxent"))
            .backprop_type(BackpropType.TruncatedBPTT)
            .t_bptt_length(RNN_TBPTT)
            .set_input_type(InputType.recurrent(RNN_CHARS)).build())


def rnn_net(name, dev, data_type="float32"):
    """R1 or R2 on ``dev``."""
    if name == "R1":
        return r1_model(data_type).init_model(device=dev)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(r2_conf(data_type), device=dev).init()


def r3_graph(dev):
    """R1's layers as a ComputationGraph (input "in", layers "0", "1",
    "2" named as R1's keys, so R1's trees load as they are)."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_dict
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = r1_model().conf()
    b = (NeuralNetConfiguration.builder().seed(conf.seed)
         .updater(conf.updater).weight_init("xavier").graph_builder()
         .add_inputs("in").set_input_types(conf.input_type))
    src = "in"
    for i, layer in enumerate(conf.layers):
        b.add_layer(str(i), layer_from_dict(layer.to_dict()), src)
        src = str(i)
    g = (b.set_outputs(src).backprop_type("tbptt")
         .t_bptt_length(RNN_TBPTT).build())
    return ComputationGraph(g, device=dev).init()


def r4_graph(dev):
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (LSTM,
                                                         Bidirectional,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import LastTimeStepVertex
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    g = (NeuralNetConfiguration.builder().seed(7).updater(Adam(R1_LR))
         .weight_init("xavier").graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(RNN_CHARS))
         .add_layer("bi", Bidirectional.wrap(LSTM(n_out=256,
                                                  activation="tanh")), "in")
         .add_vertex("last", LastTimeStepVertex(), "bi")
         .add_layer("out", OutputLayer(n_out=R4_CLASSES,
                                       activation="softmax",
                                       loss_function="mcxent"), "last")
         .set_outputs("out").build())
    return ComputationGraph(g, device=dev).init()


class _ChunkScores:
    """A listener keeping every TBPTT chunk's score."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(score)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def tbptt_fit_record(net, x, y):
    """One ``fit`` of ``net`` on (x, y): each chunk's loss, the params
    after it and the last chunk's final carries (all numpy, f32)."""
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    rec, carried = _ChunkScores(), []
    step = net._train_step

    def spy(*args, **kwargs):
        out = step(*args, **kwargs)
        carried.append(out[2])
        return out

    net.setListeners(rec)
    net._train_step = spy
    try:
        net.fit(x, y)
    finally:
        del net._train_step
        net.setListeners([])
    carries = {k: [c.float().cpu().numpy() for c in v]
               for k, v in carried[-1].items()}
    return {"losses": rec.scores, "params": tree_to_numpy(net.param_tree()),
            "carries": carries}


def tbptt_fit_f64(net, x, y):
    """:func:`tbptt_fit_record`'s quantities for the same fit taken in f64
    on the CPU: ``net``'s own loss, layers and updater chain on f64 copies
    of its params and updater state (the truth for the f32 rows)."""
    from deeplearning4j_tpu_torch.nn import params as _flat
    from deeplearning4j_tpu_torch.nn._step_tail import finish_train_step
    from deeplearning4j_tpu_torch.optim import transforms as T
    torch = __import__("torch")
    params = {k: {p: v.detach().cpu().double() for p, v in layer.items()}
              for k, layer in net.param_tree().items()}
    opt = T.map_state(lambda t: t.detach().cpu().double(),
                      net.updater_state())
    keys = _flat.leaf_keys(params)
    xt = torch.tensor(x, dtype=torch.float64)
    yt = torch.tensor(y, dtype=torch.float64)
    carries, losses = {}, []
    for start in range(0, xt.shape[1], net.conf.tbptt_fwd_length):
        end = start + net.conf.tbptt_fwd_length
        leaves = [params[k][p].requires_grad_() for k, p in keys]
        loss, _, new = net._loss_fn(params, {}, (xt[:, start:end],),
                                    (yt[:, start:end],), None, None, None,
                                    carries)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new_leaves, opt, _, _ = finish_train_step(
                net._opt, [t.detach() for t in leaves], opt, list(grads),
                loss.detach(), [False] * len(leaves))
        params = {k: {} for k in params}
        for (k, p), t in zip(keys, new_leaves):
            params[k][p] = t.detach()
        carries = {k: tuple(c.detach() for c in v) for k, v in new.items()}
        losses.append(float(loss.detach()))
    return {"losses": losses,
            "params": {k: {p: v.numpy() for p, v in layer.items()}
                       for k, layer in params.items()},
            "carries": {k: [c.numpy() for c in v]
                        for k, v in carries.items()}}


def tbptt_report(got, want, base):
    """``got`` against ``want`` (each from :func:`tbptt_fit_record`): the
    largest |Δ| of a chunk's loss, the worst leaf's displacement (relative
    L2 against ``base``, the params before the fit) and the worst final
    carry (relative L2)."""
    steps = tree_errors(got["params"], want["params"], base=base)
    carry = max(rel_l2(a, b) for k in want["carries"]
                for a, b in zip(got["carries"][k], want["carries"][k]))
    return {"loss": float(np.max(np.abs(np.subtract(got["losses"],
                                                    want["losses"])))),
            "step": worst(steps)[0], "step_leaf": worst(steps)[1],
            "carry": carry}


def rnn_readings(name, seq=RNN_SEQ):
    """CPU readings for (a)'s rows: ``name``'s f32 fit against the same
    fit in f64 (``tbptt_report``), and the fitted net's output on the
    first chunk against the same forward in f64 (``probs``)."""
    import torch
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    x, y = char_stream(RNN_BATCH, seq)
    net = rnn_net(name, "cpu")
    base = tree_to_numpy(net.param_tree())
    truth = tbptt_fit_f64(net, x, y)
    out = tbptt_report(tbptt_fit_record(net, x, y), truth, base)
    x64 = torch.tensor(x[:, :RNN_TBPTT], dtype=torch.float64)
    with torch.no_grad():
        p64, _, _ = net._forward(
            {k: {p: v.double() for p, v in layer.items()}
             for k, layer in net.param_tree().items()}, {}, x64, False,
            None)
    out["probs"] = rel_l2(net.output(x[:, :RNN_TBPTT]).numpy(),
                          p64.numpy())
    return out


def k11_inputs(torch, case, seed=SEED):
    """One step's operands on the card at ``case`` = (N, H, peepholes,
    masked): z, b, c_prev, h_prev, the peepholes (3, H) or None, a mask
    (N,) with every third row 0 or None, and the backward's dy, dh, dc."""
    n, hd, peep, masked = case
    g = torch.Generator(device="cuda").manual_seed(seed + hd)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    z, b, c0, h0 = rnd(n, 4 * hd), rnd(4 * hd), rnd(n, hd), rnd(n, hd)
    p = 0.5 * rnd(3, hd) if peep else None
    m = ((torch.arange(n, device="cuda") % 3 != 2).float() if masked
         else None)
    return z, b, c0, h0, p, m, rnd(n, hd), rnd(n, hd), rnd(n, hd)


def k11_bound_ms(n, hd, peep, masked, which):
    """One K11 launch's least time: every operand the function needs read
    once and every output it makes written once (f32), over the memory
    rate; its ~20 FLOPs an element are nothing against that. K11f reads
    z, b, c_prev, h_prev (and the peepholes, the mask) and writes h, c,
    the gates and, under a mask, the output h·m (with no mask the output
    is h). K11b reads dy, dh, dc, the gates, c, c_prev (and the
    peepholes, the mask) and writes dz, dc_prev and, under a mask, dh_pass
    (0 with no mask, and not written); with peepholes it adds into the
    three (N, H) peephole buffers. K11b has no bias operand."""
    nh = n * hd
    small = (4 * 3 * hd if peep else 0) + (4 * n if masked else 0)
    if which == "fwd":
        nbytes = (4 * (4 * nh + 2 * nh + 2 * nh + 4 * nh
                       + (nh if masked else 0)) + 4 * 4 * hd + small)
    else:
        nbytes = (4 * (3 * nh + 4 * nh + 2 * nh + 4 * nh + nh
                       + (nh if masked else 0)) + small
                  + (2 * 4 * 3 * nh if peep else 0))
    return _bound(0.0, nbytes, "float32")


def k11_phase(torch):
    """(b): K11f and K11b against their plain versions at R1's and R2's
    cell shapes (with and without peepholes, unmasked and masked), each
    launch's bits equal from call to call, and their times: ``device_ms``
    (20 launches in a CUDA graph), ``ms`` (20 wrapper calls, host
    included), the plain version, the bound and, where the cell is aten's
    (LSTM, tanh, no mask), ``_thnn_fused_lstm_cell`` and its backward.
    Returns {case: row}."""
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    rows = {}
    aten = torch.ops.aten
    for case in K11_CASES:
        n, hd, peep, masked = case
        z, b, c0, h0, p, m, dy, dh, dc = k11_inputs(torch, case)
        before = all_counts()
        out = rc.lstm_cell_fwd(z, b, c0, h0, p, m, 0)
        ref = rc.cell_fwd_reference(z, b, c0, h0, p, m, 0)
        dpeep = torch.zeros((3, n, hd), device="cuda") if peep else None
        got_b = rc.lstm_cell_bwd(dy, dh, dc, ref[3], ref[2], c0, p, m, 0,
                                 dpeep=dpeep)
        ref_b = rc.cell_bwd_reference(dy, dh, dc, ref[3], ref[2], c0, p, m,
                                      0)
        torch.cuda.synchronize()
        check(delta(before) == launch_counts(rnn_cell_fwd=1, rnn_cell_bwd=1),
              f"K11 {case}: launches {delta(before)}")
        err_f = max(((a - r).abs().max() / r.abs().max().clamp_min(1.0)
                     ).item() for a, r in zip(out, ref))
        check((got_b[2] is None) == (ref_b[2] is None) == (m is None),
              f"K11 {case}: dh_pass is written only under a mask")
        pairs = [(a, r) for a, r in zip(got_b, ref_b[:3])
                 if r is not None] + ([(dpeep, ref_b[3])] if peep else [])
        err_b = max(((a - r).abs().max() / r.abs().max().clamp_min(1.0)
                     ).item() for a, r in pairs)
        abs_f = max((a - r).abs().max().item() for a, r in zip(out, ref))
        abs_b = max((a - r).abs().max().item() for a, r in pairs)
        again = rc.lstm_cell_fwd(z, b, c0, h0, p, m, 0)
        dpeep2 = torch.zeros_like(dpeep) if peep else None
        again_b = rc.lstm_cell_bwd(dy, dh, dc, ref[3], ref[2], c0, p, m, 0,
                                   dpeep=dpeep2)
        same = (all(bool(a.equal(b_)) for a, b_ in zip(again, out))
                and all(bool(a.equal(b_)) for a, b_ in zip(again_b, got_b)
                        if a is not None)
                and (not peep or bool(dpeep2.equal(dpeep))))
        # no output buffer unmasked, as LSTMLayer calls it (the output is h)
        fwd_buf = (None if m is None else torch.empty_like(c0),
                   torch.empty_like(c0), torch.empty_like(c0),
                   torch.empty_like(z))
        dz_buf = torch.empty_like(z)
        fwd = lambda: rc.lstm_cell_fwd(z, b, c0, h0, p, m, 0, out=fwd_buf)
        bwd = lambda: rc.lstm_cell_bwd(dy, dh, dc, ref[3], ref[2], c0, p, m,
                                       0, dz=dz_buf, dpeep=dpeep)
        row = {"case": dict(zip(("n", "h", "peepholes", "masked"), case)),
               "max_rel_err": {"fwd": err_f, "bwd": err_b},
               "max_abs_err": {"fwd": abs_f, "bwd": abs_b},
               "bit_identical": same,
               "fwd_ms": time_ms(fwd, torch),
               "fwd_device_ms": device_ms(fwd, torch),
               "bwd_ms": time_ms(bwd, torch),
               "bwd_device_ms": device_ms(bwd, torch),
               "fwd_plain_ms": time_ms(
                   lambda: rc.cell_fwd_reference(z, b, c0, h0, p, m, 0),
                   torch),
               "bwd_plain_ms": time_ms(
                   lambda: rc.cell_bwd_reference(dy, dh, dc, ref[3], ref[2],
                                                 c0, p, m, 0), torch)}
        for which in ("fwd", "bwd"):
            row[f"{which}_bound_ms"], row[f"{which}_bound_by"] = \
                k11_bound_ms(n, hd, peep, masked, which)
        row["library"] = None
        if not peep and not masked:
            row.update(k11_library(torch, aten, z, b, c0, h0))
        rows[case] = row
        emit(k11_case=row)
        check(err_f <= TOL_K11["fwd"] and err_b <= TOL_K11["bwd"],
              f"K11 {case}: {err_f} / {err_b} over {TOL_K11}")
        check(same, f"K11 {case}: a second launch gave other bits")
    return rows


def k11_library(torch, aten, z, b, c0, h0):
    """aten's fused LSTM cell on the same step (LSTM, tanh, no mask):
    ``_thnn_fused_lstm_cell(input_gates, hidden_gates, cx, input_bias,
    hidden_bias)`` with the input gates z, zero hidden gates and a zero
    hidden bias, and its backward ``_thnn_fused_lstm_cell_backward_impl``;
    its agreement with K11f's h and c and its times, or why it was not
    measured (a yardstick: the port never calls it)."""
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    try:
        cell = aten._thnn_fused_lstm_cell
        cell_bwd = aten._thnn_fused_lstm_cell_backward_impl
        zero, zero_b = torch.zeros_like(z), torch.zeros_like(b)
        hy, cy, ws = cell(z, zero, c0, b, zero_b)
        gh, gc = torch.randn_like(hy), torch.randn_like(cy)
        fwd = lambda: cell(z, zero, c0, b, zero_b)
        bwd = lambda: cell_bwd(gh, gc, c0, cy, ws, True)
        bwd()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError) as e:
        return {"library": "_thnn_fused_lstm_cell",
                "library_ms": None, "library_error": str(e)[:300]}
    _y, h, c, _g = rc.lstm_cell_fwd(z, b, c0, h0, None, None, 0)
    return {"library": "_thnn_fused_lstm_cell",
            "library_vs_k11": {"h": (hy - h).abs().max().item(),
                               "c": (cy - c).abs().max().item()},
            "library_ms": time_ms(fwd, torch),
            "library_device_ms": device_ms(fwd, torch),
            "library_bwd_ms": time_ms(bwd, torch),
            "library_bwd_device_ms": device_ms(bwd, torch)}


def k11l_inputs(torch, case, dev="cuda", seed=SEED, t_len=RNN_TBPTT):
    """A layer's operands over a chunk at ``case`` = (N, H, peepholes,
    masked), f32 on ``dev``: {xw (T, N, 4H), rw (H, 4H) of scale H^-1/2,
    b, peep (3, H) of scale 0.1 or None, m (T, N) or None, h0, c0}, and
    the backward's dy (T, N, H), dh, dc. The mask keeps each row's first
    20-50 steps, cuts an interior gap into row 1 and zeroes row 2."""
    n, hd, peep, masked = case
    g = torch.Generator(device=dev).manual_seed(seed + hd)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    ops = {"xw": rnd(t_len, n, 4 * hd), "rw": rnd(hd, 4 * hd) / hd ** 0.5,
           "b": 0.1 * rnd(4 * hd), "peep": 0.1 * rnd(3, hd) if peep else None,
           "m": None, "h0": rnd(n, hd), "c0": rnd(n, hd)}
    if masked:
        keep = torch.randint(20, t_len + 1, (n,), generator=g, device=dev)
        m = (torch.arange(t_len, device=dev)[:, None] < keep[None, :]).float()
        m[t_len // 5:t_len // 3, 1] = 0
        m[:, 2] = 0
        ops["m"] = m.contiguous()
    return ops, rnd(t_len, n, hd), rnd(n, hd), rnd(n, hd)


def k11l_errors(got, ref):
    """max |Δ| over max(1, max |ref|), worst output, and max |Δ|."""
    pairs = [(a, r) for a, r in zip(got, ref) if r is not None]
    rel = max(((a - r).abs().max() / r.abs().max().clamp_min(1.0)).item()
              for a, r in pairs)
    return rel, max((a - r).abs().max().item() for a, r in pairs)


def k11l_readings(cases=K11L_CASES, seeds=range(4), t_len=RNN_TBPTT):
    """CPU readings behind TOL_K11L: the plain layer in f32 against the
    same layer in f64 over ``t_len`` steps, forward and backward (on the
    f32 forward's own carries and gates), {"fwd": worst, "bwd": worst}
    over the cases and seeds."""
    import torch
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    d = lambda t: None if t is None else t.double()
    worst = {"fwd": 0.0, "bwd": 0.0}
    for case in cases:
        for seed in seeds:
            ops, dy, dh, dc = k11l_inputs(torch, case, "cpu", SEED + seed,
                                          t_len)
            f32 = rc.layer_fwd_reference(**ops, act=0)
            f64 = rc.layer_fwd_reference(
                **{k: d(v) for k, v in ops.items()}, act=0)
            got = rc.layer_bwd_reference(dy, dh, dc, f32[3], f32[2],
                                         ops["c0"], ops["rw"], ops["peep"],
                                         ops["m"], 0)
            want = rc.layer_bwd_reference(
                d(dy), d(dh), d(dc), f64[3], f64[2], d(ops["c0"]),
                d(ops["rw"]), d(ops["peep"]), d(ops["m"]), 0)
            worst["fwd"] = max(worst["fwd"], k11l_errors(f32, f64)[0])
            worst["bwd"] = max(worst["bwd"], k11l_errors(got, want)[0])
    return worst


def k11l_bound_ms(n, hd, peep, masked, which, t_len=RNN_TBPTT):
    """One K11L launch's least time: the larger of its recurrent product
    (2·N·T·H·4H FLOPs each way, f32 at 67 TFLOP/s; the cell's ~20 FLOPs an
    element are left out) and its bytes (every operand read once and every
    output written once, f32). K11Lf reads X·W, RW, b, h0, c0 (and the
    peepholes, the mask) and writes h, c and the gates a step (and, under
    a mask, the output h·m); K11Lb reads dy, dh, dc, the gates, c a step,
    c0 and RW (and the peepholes, the mask) and writes dz a step, dh0,
    dc0 (and the peephole sums (3, N, H))."""
    nh, tnh = n * hd, t_len * n * hd
    small = (3 * hd if peep else 0) + (t_len * n if masked else 0)
    if which == "fwd":
        floats = (4 * tnh + 4 * hd * hd + 4 * hd + 2 * nh + 2 * tnh
                  + 4 * tnh + (tnh if masked else 0) + small)
    else:
        floats = (tnh + 2 * nh + 4 * tnh + tnh + nh + 4 * hd * hd + small
                  + 4 * tnh + 2 * nh + (3 * nh if peep else 0))
    return _bound(2.0 * t_len * n * hd * 4 * hd, 4 * floats, "float32")


def k11l_phase(torch):
    """(b'): K11Lf and K11Lb against their plain versions over one chunk
    at R1's and R2's layer shapes (with and without peepholes, unmasked
    and ragged-masked), each launch's bits equal from call to call, and
    their times: ``device_ms`` (20 launches in a CUDA graph), ``ms`` (20
    wrapper calls, host included), the plain versions, the bound and,
    where cuDNN computes the layer (LSTM, tanh, no mask), one layer of
    ``nn.LSTM`` (its input product included): forward (``_VF.lstm`` under
    no_grad) and forward + backward. Returns {case: row}."""
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    rows = {}
    for case in K11L_CASES:
        n, hd, peep, masked = case
        ops, dy, dh, dc = k11l_inputs(torch, case)
        before = all_counts()
        got = rc.lstm_layer_fwd(**ops, act=0)
        ref = rc.layer_fwd_reference(**ops, act=0)
        args = (dy, dh, dc, ref[3], ref[2], ops["c0"], ops["rw"],
                ops["peep"], ops["m"], 0)
        got_b = rc.lstm_layer_bwd(*args)
        ref_b = rc.layer_bwd_reference(*args)
        torch.cuda.synchronize()
        check(delta(before) == launch_counts(rnn_layer_fwd=1,
                                             rnn_layer_bwd=1),
              f"K11L {case}: launches {delta(before)}")
        check((got[0] is None) == (ref[0] is None) == (not masked)
              and (got_b[3] is None) == (not peep),
              f"K11L {case}: the output is made only under a mask, the "
              f"peephole sums only with peepholes")
        err_f, abs_f = k11l_errors(got, ref)
        err_b, abs_b = k11l_errors(got_b, ref_b)
        again = rc.lstm_layer_fwd(**ops, act=0)
        again_b = rc.lstm_layer_bwd(*args)
        same = all((a is None and b is None) or bool(a.equal(b))
                   for a, b in zip(again + again_b, got + got_b))
        fwd = lambda: rc.lstm_layer_fwd(**ops, act=0)
        bwd = lambda: rc.lstm_layer_bwd(*args)
        row = {"case": dict(zip(("n", "h", "peepholes", "masked"), case),
                            t=RNN_TBPTT),
               "cluster": rc.layer_cluster(hd), "rows": rc.layer_rows(n),
               "smem": {w: rc.layer_geometry(w, hd, rc.layer_cluster(hd),
                                             rc.layer_rows(n))["smem"]
                        for w in ("fwd", "bwd")},
               "clusters_fit": {w: rc.layer_clusters(
                   w, hd, rc.layer_cluster(hd), rc.layer_rows(n),
                   ops["xw"].device) for w in ("fwd", "bwd")},
               "max_rel_err": {"fwd": err_f, "bwd": err_b},
               "max_abs_err": {"fwd": abs_f, "bwd": abs_b},
               "bit_identical": same,
               "fwd_ms": time_ms(fwd, torch),
               "fwd_device_ms": device_ms(fwd, torch),
               "bwd_ms": time_ms(bwd, torch),
               "bwd_device_ms": device_ms(bwd, torch),
               "fwd_plain_ms": time_ms(
                   lambda: rc.layer_fwd_reference(**ops, act=0), torch,
                   iters=3, repeats=3),
               "bwd_plain_ms": time_ms(
                   lambda: rc.layer_bwd_reference(*args), torch, iters=3,
                   repeats=3)}
        for which in ("fwd", "bwd"):
            row[f"{which}_bound_ms"], row[f"{which}_bound_by"] = \
                k11l_bound_ms(n, hd, peep, masked, which)
        row["library"] = None
        if not peep and not masked:
            row.update(k11l_library(torch, n, hd))
        rows[case] = row
        emit(k11l_case=row)
        check(err_f <= TOL_K11L["fwd"] and err_b <= TOL_K11L["bwd"],
              f"K11L {case}: {err_f} / {err_b} over {TOL_K11L}")
        check(same, f"K11L {case}: a second launch gave other bits")
    return rows


def k11l_library(torch, n, hd, calls=10):
    """cuDNN's one LSTM layer (``nn.LSTM(H, H)``, N rows, RNN_TBPTT steps;
    its input product X·W included, which K11Lf takes done): the forward
    alone under no_grad (``_VF.lstm``) and forward + backward; ms with the
    host by CUDA events, device ms from a profiler window over ``calls``
    calls (no CUDA graph: cuDNN's RNN is not captured). A yardstick: the
    port never calls it."""
    twin = torch.nn.LSTM(hd, hd, batch_first=True).cuda()
    x = torch.randn((n, RNN_TBPTT, hd), device="cuda")

    def fwd():
        with torch.no_grad():
            return twin(x)[0]

    def fwd_bwd():
        xs = x.detach().requires_grad_()
        y, _ = twin(xs)
        y.backward(torch.ones_like(y))

    out = {"library": "nn.LSTM (cuDNN), one layer",
           "library_ms": time_ms(fwd, torch),
           "library_fwd_bwd_ms": time_ms(fwd_bwd, torch, iters=10)}
    for key, fn in (("library_device_ms", fwd),
                    ("library_fwd_bwd_device_ms", fwd_bwd)):
        p = profile_window(torch, f"k11l_{key}",
                           lambda: [fn() for _ in range(calls)],
                           f"k11l_{key}_trace.json", top=4)
        busy = p.get("device_busy_us")
        out[key] = None if busy is None else busy / 1e3 / calls
    return out


def wide_layer_phase(torch):
    """The per-step route on the card: an LSTM layer past K11L's widest
    (WIDE_LAYER: N 32, H 512, n_in 512) over one chunk, forward and
    backward, against the same layer with the plain versions swapped in
    (relative L2 of the output, carries and every gradient); its launches
    (K11f and K11b a step each, no K11L) and its time. Returns the launch
    tuple."""
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    from deeplearning4j_tpu_torch.nn.conf.layers import LSTM
    n, hd = WIDE_LAYER
    layer = LSTM(n_in=hd, n_out=hd)
    layer.apply_global_defaults({})
    check(layer.cell_route() == "k11",
          f"H {hd}: route {layer.cell_route()}, not the per-step one")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = {k: 0.05 * torch.randn(s, generator=g, device="cuda")
              for k, s in layer.param_shapes().items()}
    x = torch.randn((n, RNN_TBPTT, hd), generator=g, device="cuda")

    def run():
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        xs = x.detach().requires_grad_()
        y, (h, c) = layer.run(ps, xs, layer.initial_carry(n, "cuda"))
        grads = torch.autograd.grad(y.square().sum() + h.sum() + c.sum(),
                                    [*ps.values(), xs])
        return [y, h, c, *grads]

    reset_all_counts()
    got = run()
    torch.cuda.synchronize()
    launches = all_counts()
    saved = rc.lstm_cell_fwd, rc.lstm_cell_bwd

    def plain_fwd(z, b, c_prev, h_prev, peep, m, act, out=None):
        for buf, val in zip(out, rc.cell_fwd_reference(z, b, c_prev, h_prev,
                                                       peep, m, act)):
            if buf is not None:
                buf.copy_(val)
        return out

    def plain_bwd(dy, dh, dc, gates, c, c_prev, peep, m, act, dz=None,
                  dpeep=None):
        rz, rcp, rh, _ = rc.cell_bwd_reference(dy, dh, dc, gates, c, c_prev,
                                               peep, m, act)
        dz.copy_(rz)
        return dz, rcp, rh

    rc.lstm_cell_fwd, rc.lstm_cell_bwd = plain_fwd, plain_bwd
    try:
        want = run()
    finally:
        rc.lstm_cell_fwd, rc.lstm_cell_bwd = saved
    err = max(rel_l2(a.detach().cpu().numpy(), b.detach().cpu().numpy())
              for a, b in zip(got, want))
    emit(recurrent_wide_layer={"n": n, "h": hd, "t": RNN_TBPTT,
                               "route": layer.cell_route(),
                               "max_rel_l2": err, "row": TOL_WIDE_LAYER,
                               "ms": time_ms(run, torch, iters=3, repeats=3),
                               "launches": dict(zip(ALL_KERNELS, launches))})
    check(err <= TOL_WIDE_LAYER, f"the wide layer (K11 a step) against "
          f"the plain versions: {err} over {TOL_WIDE_LAYER}")
    check(launches == launch_counts(rnn_cell_fwd=RNN_TBPTT,
                                    rnn_cell_bwd=RNN_TBPTT),
          f"the wide layer launched {dict(zip(ALL_KERNELS, launches))}")
    return launches


def layer_vs_cudnn(torch, dev):
    """One LSTM layer (R1's second: 256 → 256, N 32) over one 50-step
    chunk, forward and backward: the port's layer Function (K11 a step)
    against cuDNN's ``nn.LSTM`` (one layer, the same gate order and
    weights), in turns; ms by CUDA events (host included) and device ms
    and kernels from a profiler window of one pass each."""
    from deeplearning4j_tpu_torch.nn.conf.layers import LSTM
    layer = LSTM(n_in=256, n_out=256)
    layer.apply_global_defaults({})
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = {k: (0.05 * torch.randn(s, generator=g, device=dev))
              .requires_grad_() for k, s in layer.param_shapes().items()}
    x = torch.randn((RNN_BATCH, RNN_TBPTT, 256), generator=g,
                    device=dev).requires_grad_()
    twin = torch.nn.LSTM(256, 256, batch_first=True).to(dev)
    with torch.no_grad():
        twin.weight_ih_l0.copy_(params["W"].t())
        twin.weight_hh_l0.copy_(params["RW"].t())
        twin.bias_ih_l0.copy_(params["b"])
        twin.bias_hh_l0.zero_()
    zeros = layer.initial_carry(RNN_BATCH, dev)

    def port():
        y, _ = layer.run(params, x, zeros)
        y.backward(torch.ones_like(y))

    def cudnn():
        y, _ = twin(x)
        y.backward(torch.ones_like(y))

    with torch.no_grad():
        agree = (layer.run(params, x, zeros)[0] - twin(x)[0]).abs().max()
    timed = {"port": [], "cudnn": []}
    for who in ("port", "cudnn", "cudnn", "port"):
        timed[who].append(time_ms(port if who == "port" else cudnn, torch,
                                  iters=10, repeats=5))
    out = {"shape": {"n": RNN_BATCH, "t": RNN_TBPTT, "n_in": 256, "h": 256},
           "output_max_abs_diff": agree.item()}
    for who, fn in (("port", port), ("cudnn", cudnn)):
        p = profile_window(torch, f"lstm_layer_{who}", fn,
                           f"lstm_layer_{who}_trace.json", top=6)
        out[who] = {"ms": statistics.median(timed[who]),
                    "turns_ms": timed[who],
                    "device_ms": p.get("device_busy_us", 0) / 1e3,
                    "kernels": p.get("kernels"),
                    "top_kernels": p.get("top_kernels")}
    return out


def plain_char_rnn(torch, width, dev, bf16=False):
    """The yardstick: a 2-layer char-RNN in plain PyTorch modules (cuDNN's
    ``nn.LSTM``, ``nn.Linear``), ``F.cross_entropy`` over every step,
    ``torch.optim.Adam``, the carries detached every RNN_TBPTT steps; with
    ``bf16`` the LSTM under bf16 autocast (``fit.dtype`` records the type
    it computed in). Never on the port's path. Returns fit(x, y) over a
    whole sequence."""
    import torch.nn.functional as F
    lstm = torch.nn.LSTM(RNN_CHARS, width, num_layers=2,
                         batch_first=True).to(dev)
    head = torch.nn.Linear(width, RNN_CHARS).to(dev)
    opt = torch.optim.Adam(list(lstm.parameters()) + list(head.parameters()),
                           lr=R1_LR)

    def fit(x, y):
        state = None
        for s in range(0, x.shape[1], RNN_TBPTT):
            xs, ys = x[:, s:s + RNN_TBPTT], y[:, s:s + RNN_TBPTT]
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                h, state = lstm(xs, state)
            fit.dtype = str(h.dtype)
            loss = F.cross_entropy(head(h.float()).flatten(0, 1),
                                   ys.argmax(-1).flatten())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            state = tuple(t.detach() for t in state)
        return loss
    return fit


def fit_timing(torch, fit):
    """Host ms of one whole fit (ending in a synchronise), after one warm
    fit: the median of two."""
    fit()
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def rnn_timing(torch, label, net, x, y, twin_fit, smi, chunks):
    """Host ms a chunk, characters/s, device ms, busy share and kernels a
    chunk (a profiler window of one whole fit), top device ops, the
    share of the device time in rnn_cell.cu's kernels (K11L on R1 and R2)
    and own peak memory, for the port's ``net``
    and (where ``twin_fit`` is given) the plain twin, in turns (port,
    twin, twin, port)."""
    runs = {"port": lambda: net.fit(x, y)}
    if twin_fit is not None:
        runs["twin"] = lambda: twin_fit(x, y)
    order = (("port", "twin", "twin", "port") if twin_fit is not None
             else ("port", "port"))
    timed, peaks = {k: [] for k in runs}, {}
    for who in order:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        timed[who].append(fit_timing(torch, runs[who]))
        peaks[who] = max(peaks.get(who, 0),
                         torch.cuda.max_memory_allocated() - before)
    rows = []
    for who, fn in runs.items():
        p = profile_window(torch, f"{label}_{who}", fn,
                           f"{label}_{who}_trace.json", top=12)
        k11_us = sum(k["us"] for k in p.get("rnn_kernels") or [])
        ms = statistics.median(timed[who]) / chunks
        busy = p.get("device_busy_us")
        rows.append({
            "net": label, "model": who, "gpu": smi,
            "host_ms_per_chunk": ms,
            "turns_ms_per_fit": timed[who],
            "chars_per_s": RNN_BATCH * RNN_TBPTT / (ms / 1e3),
            "device_ms_per_chunk": (busy / 1e3 / chunks
                                    if busy is not None else None),
            "busy_share": p.get("busy_share"),
            "kernels_per_chunk": (p["kernels"] / chunks
                                  if "kernels" in p else None),
            "k11_share": (k11_us / busy if busy else None),
            "own_peak_bytes": peaks[who],
            "top_ops": p.get("top_ops"), "top_kernels": p.get("top_kernels")})
    return rows


def recurrent_phase(torch):
    """The recurrent slice on the card (R1-R4 above): checks (a)-(e) of
    PERF.md's recurrent rows, K11 alone (b), K11L alone (b'), the wide
    layer on K11 a step, the timings and the recurrent path's launches:
    every count 0 just before one fit of R1 in f32, read just after (K11Lf
    and K11Lb once a layer and chunk, 2 × 20 each, nothing else). Returns
    (that launch tuple, the wide layer's, the K11 rows, the K11L rows)."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    t_phase = time.perf_counter()
    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    k11_rows = k11_phase(torch)
    k11l_rows = k11l_phase(torch)
    wide = wide_layer_phase(torch)
    chunks = RNN_SEQ // RNN_TBPTT
    x, y = char_stream(RNN_BATCH, RNN_SEQ)

    # (a) R1 and R2 in f32: the card against the CPU, one fit each; the
    # launch count of the recurrent path is R1's card fit
    reports, launches = {}, None
    for name in ("R1", "R2"):
        cpu = rnn_net(name, "cpu")
        base = tree_to_numpy(cpu.param_tree())
        card = rnn_net(name, dev)
        carry_net(cpu, card)
        control = rnn_net(name, dev)
        carry_net(cpu, control)
        cpu_out = tbptt_fit_record(cpu, x, y)
        if name == "R1":
            reset_all_counts()
        card_out = tbptt_fit_record(card, x, y)
        if name == "R1":
            launches = all_counts()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ctl_out = tbptt_fit_record(control, x, y)
            ctl_probs = control.output(x[:, :RNN_TBPTT]).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        reports[name] = {"f32": tbptt_report(card_out, cpu_out, base),
                         "tf32_control": tbptt_report(ctl_out, cpu_out,
                                                      base),
                         "losses_first_last": [card_out["losses"][0],
                                               card_out["losses"][-1]]}
        # the fitted nets' outputs on the first chunk
        cpu_probs = cpu.output(x[:, :RNN_TBPTT]).cpu().numpy()
        reports[name]["f32"]["probs"] = rel_l2(
            card.output(x[:, :RNN_TBPTT]).cpu().numpy(), cpu_probs)
        reports[name]["tf32_control"]["probs"] = rel_l2(ctl_probs,
                                                        cpu_probs)
        del cpu, card, control
    failed = {n: rows_failed(r["f32"], TOL_RNN_F32)
              for n, r in reports.items()}
    control = {n: rows_failed(r["tf32_control"], TOL_RNN_F32)
               for n, r in reports.items()}
    emit(recurrent_card_vs_cpu=reports, rows=TOL_RNN_F32, failed=failed,
         control_failed=control)
    check(not any(failed.values()), f"(a) f32 card vs CPU above its rows: "
          f"{failed}")
    check(all(control.values()), f"(a) a TF32 control passed the f32 rows: "
          f"{control}")
    check(launches == launch_counts(rnn_layer_fwd=2 * chunks,
                                    rnn_layer_bwd=2 * chunks),
          f"the recurrent path (one fit of R1) launched "
          f"{dict(zip(ALL_KERNELS, launches))}")

    # (c) streaming: rnnTimeStep one character at a time against output()
    net = rnn_net("R1", dev)
    xs = x[:, :RNN_STREAM_STEPS]
    full = net.output(xs)
    net.rnnClearPreviousState()
    steps = torch.stack([net.rnnTimeStep(xs[:, t])
                         for t in range(RNN_STREAM_STEPS)], 1)
    stream_err = (steps - full).abs().max().item()
    kept = net.rnnGetPreviousState(0)
    net.rnnClearPreviousState()
    cleared = net.rnnGetPreviousState(0)
    restart = (net.rnnTimeStep(xs[:, 0]) - full[:, 0]).abs().max().item()
    # sampling at batch 1, as examples/char_lstm.py does
    rng = np.random.default_rng(SEED)
    eye = np.eye(RNN_CHARS, dtype=np.float32)
    net.rnnClearPreviousState()
    ch = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RNN_SAMPLE_CHARS):
        p_ = net.rnnTimeStep(eye[None, ch]).double().cpu().numpy().ravel()
        ch = int(rng.choice(RNN_CHARS, p=p_ / p_.sum()))
    sample_ms = 1e3 * (time.perf_counter() - t0) / RNN_SAMPLE_CHARS
    emit(recurrent_streaming={"max_abs_err": stream_err,
                              "row": TOL_RNN_STREAM,
                              "restart_err": restart,
                              "kept_layers": None if kept is None
                              else len(kept),
                              "cleared_is_none": cleared is None,
                              "sample_ms_per_char": sample_ms,
                              "gpu": smi})
    check(stream_err <= TOL_RNN_STREAM and restart <= TOL_RNN_STREAM,
          f"(c) rnnTimeStep vs output(): {stream_err}, after a clear "
          f"{restart}")
    check(kept is not None and len(kept) == 2 and cleared is None,
          "(c) rnnGetPreviousState before / after rnnClearPreviousState")

    # (d) R1 bf16 against f32, same weights, one fit each
    f32_net = rnn_net("R1", dev)
    bf16_net = rnn_net("R1", dev, "bfloat16")
    carry_net(f32_net, bf16_net)
    probs = rel_l2(bf16_net.output(x[:, :RNN_TBPTT]).cpu().numpy(),
                   f32_net.output(x[:, :RNN_TBPTT]).cpu().numpy())
    o32 = tbptt_fit_record(f32_net, x, y)
    o16 = tbptt_fit_record(bf16_net, x, y)
    rep_d = {"loss": float(np.max(np.abs(np.subtract(o16["losses"],
                                                     o32["losses"])))),
             "probs": probs}
    failed = rows_failed(rep_d, TOL_RNN_BF16)
    too_close = floors_failed(rep_d, FLOOR_RNN_BF16)
    emit(recurrent_bf16_vs_f32=rep_d, rows=TOL_RNN_BF16, failed=failed,
         floors=FLOOR_RNN_BF16, floors_failed=too_close,
         bf16_losses_first_last=[o16["losses"][0], o16["losses"][-1]])
    check(not failed, f"(d) bf16 vs f32 above its rows: {failed}")
    check(not too_close, f"(d) bf16 reads as close to f32 as f32 does: "
          f"{too_close}")

    # (e) R3, R1's layers as a graph with R1's weights, against R1; R4's
    # masked rows against each row alone
    seq_net = rnn_net("R1", dev)
    graph = r3_graph(dev)
    carry_net(seq_net, graph)
    o_seq = tbptt_fit_record(seq_net, x, y)
    o_graph = tbptt_fit_record(graph, x, y)
    r3 = float(np.max(np.abs(np.subtract(o_graph["losses"],
                                         o_seq["losses"]))))
    r4 = r4_graph(dev)
    rng = np.random.default_rng(SEED + 4)
    lens = rng.integers(R4_LENS[0], R4_LENS[1] + 1, RNN_BATCH)
    x4, _ = char_stream(RNN_BATCH, R4_T, seed=SEED + 4)
    mask4 = (np.arange(R4_T)[None, :] < lens[:, None]).astype(np.float32)
    x4 = x4 * mask4[..., None]
    y4 = np.eye(R4_CLASSES, dtype=np.float32)[
        rng.integers(0, R4_CLASSES, RNN_BATCH)]
    batch_out = r4.output(x4, masks=[mask4]).cpu().numpy()
    alone = np.concatenate([r4.output(x4[i:i + 1, :lens[i]]).cpu().numpy()
                            for i in range(RNN_BATCH)])
    r4_err = float(np.abs(batch_out - alone).max())
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    r4.fit(MultiDataSet([x4], [y4], [mask4], None))
    r4_loss = r4.score()
    rep_e = {"r3_loss": r3, "r4_alone": r4_err}
    failed = rows_failed(rep_e, TOL_RNN_GRAPH)
    emit(recurrent_graph=rep_e, rows=TOL_RNN_GRAPH, failed=failed,
         r4_fit_loss=r4_loss, r4_lengths=[int(lens.min()), int(lens.max())])
    check(not failed and math.isfinite(r4_loss),
          f"(e) graph against sequential / R4 masked vs alone: {rep_e}, "
          f"fit loss {r4_loss}")
    del seq_net, graph, r4, f32_net, bf16_net, net
    torch.cuda.empty_cache()

    # timings: R1 f32 and bf16 (each with the twin, bf16 under autocast),
    # R2 f32 (with a twin of its widths; cuDNN has no peepholes)
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    rows = []
    for label, name, dtype, width in (("r1_f32", "R1", "float32", 256),
                                      ("r1_bf16", "R1", "bfloat16", 256),
                                      ("r2_f32", "R2", "float32", 200)):
        net = rnn_net(name, dev, dtype)
        twin = plain_char_rnn(torch, width, dev, bf16=dtype == "bfloat16")
        try:
            twin(xd[:, :RNN_TBPTT], yd[:, :RNN_TBPTT])
        except RuntimeError as e:      # a yardstick the library lacks
            emit(recurrent_twin_error={"net": label, "error": str(e)[:300]})
            twin = None
        rows += rnn_timing(torch, label, net, xd, yd, twin, smi, chunks)
        if twin is not None:
            rows[-1]["twin_compute_dtype"] = twin.dtype
        del net, twin
        torch.cuda.empty_cache()
    for r in rows:
        emit(recurrent_timing=r)
    emit(recurrent_lstm_layer_vs_cudnn=layer_vs_cudnn(torch, dev), gpu=smi)
    emit(recurrent_phase_seconds=time.perf_counter() - t_phase,
         recurrent_launches=dict(zip(ALL_KERNELS, launches)),
         wide_layer_launches=dict(zip(ALL_KERNELS, wide)))
    return launches, wide, k11_rows, k11l_rows


def k11_kernel_entry(which, rows, launches):
    """The kernels-line entry of K11f ("rnn_cell_fwd") or K11b
    ("rnn_cell_bwd"), its numbers at K11_MAIN_CASE (R1's cell); its path
    is the wide layer's since K11L runs R1's."""
    p = "fwd" if which == "rnn_cell_fwd" else "bwd"
    main = rows[K11_MAIN_CASE]
    lib = {"fwd": ("library_ms", "library_device_ms"),
           "bwd": ("library_bwd_ms", "library_bwd_device_ms")}[p]
    return {
        "name": f"lstm_cell_{p}", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/rnn_cell.cu",
        # LSTM.step (and GravesLSTM.step, :980) in _RnnBase.run's scan
        "replaces": "deeplearning4j_tpu/nn/conf/layers.py:951",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": sum(launches.values()) > 0,
        "max_abs_err": max(r["max_abs_err"][p] for r in rows.values()),
        "ms": main[f"{p}_ms"], "device_ms": main[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"],
        "library": main.get("library"),
        "library_ms": main.get(lib[0]),
        "library_device_ms": main.get(lib[1]),
        "at": main["case"]}


def k11l_kernel_entry(which, rows, launches):
    """The kernels-line entry of K11Lf ("rnn_layer_fwd") or K11Lb
    ("rnn_layer_bwd"), its numbers at K11L_MAIN_CASE (R1's second layer
    over a chunk); library_ms is cuDNN's one layer forward, or forward and
    backward for K11Lb (its input product and weight gradients
    included)."""
    p = "fwd" if which == "rnn_layer_fwd" else "bwd"
    main = rows[K11L_MAIN_CASE]
    lib = {"fwd": ("library_ms", "library_device_ms"),
           "bwd": ("library_fwd_bwd_ms", "library_fwd_bwd_device_ms")}[p]
    return {
        "name": f"lstm_layer_{p}", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/kernels/csrc/rnn_cell.cu",
        # _RnnBase.run's lax.scan over LSTM.step / GravesLSTM.step
        "replaces": "deeplearning4j_tpu/nn/conf/layers.py:895",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "on_main_path": sum(launches.values()) > 0,
        "max_abs_err": max(r["max_abs_err"][p] for r in rows.values()),
        "ms": main[f"{p}_ms"], "device_ms": main[f"{p}_device_ms"],
        "plain_ms": main[f"{p}_plain_ms"], "bound_ms": main[f"{p}_bound_ms"],
        "bound_by": main[f"{p}_bound_by"],
        "library": main.get("library"),
        "library_ms": main.get(lib[0]),
        "library_device_ms": main.get(lib[1]),
        "at": main["case"]}


def check_path_launches(serve, modes, train, moe, f32_serve, f32_train,
                        pipeline, frontdoor, fleet, network, recurrent,
                        wide, detection, transfer, scoring):
    """Which kernels each main path launched (each an ``all_counts()``
    tuple): the bf16 paths (serving, the serving modes, the rungs, MoE)
    the wgmma flash kernels and never the simple forward or the mma.sync
    backward; the f32 paths the simple forward (serving and training) and
    the mma.sync backward (training), never a wgmma flash kernel, and
    the tf32 K3 and its split pass (training) where bf16 launches the wgmma
    K3; chunked_ce.cu's K3 on no path; K4a+w on every serving path and K4a
    on none, K4w on the int8 serving modes only (the prefill's insert);
    the front door K1's wgmma forward and K4a+w only, the fleet's demo
    model (f32, head dim 16) the simple forward and K4a+w only; the DL4J
    network paths (ResNet-50, LeNet, the zoo), the detection path
    (YOLO2, the VAE, DropConnect, deconvolution), the transfer path
    (persistence, transfer learning, early stopping, the solvers) and the
    scoring path (healing, ParallelInference, the canary, the capture) no
    kernel of the port at all, nor the attention op's plain route; the
    recurrent path (one fit of R1: 20 chunks of 50 steps, 2 LSTM layers)
    K11Lf and K11Lb 2 × 20 times each and nothing else, the wide layer
    (one chunk past K11L's widest) K11f and K11b 50 times each and nothing
    else, and no other path K11 or K11L."""
    check(serve[0] > 0 and train[0] > 0 and moe[0] > 0,
          "a main path launched no flash_attention_fwd_wgmma")
    check(train[2] > 0 and moe[2] > 0,
          "training launched no flash_attention_bwd_wgmma")
    check(serve[1] == modes[1] == train[1] == moe[1] == 0,
          "a bf16 path launched the simple kernel")
    check(serve[2] == serve[3] == modes[3] == train[3] == moe[3] == 0,
          "serving launched a backward, or bf16 training the mma.sync one")
    check(f32_serve[1] > 0 and f32_train[1] > 0 and f32_train[3] > 0,
          f"the f32 paths launched no simple forward or mma.sync backward: "
          f"serve {f32_serve[:4]}, train {f32_train[:4]}")
    check(f32_serve[0] == f32_serve[2] == f32_serve[3] == 0
          and f32_train[0] == f32_train[2] == 0,
          f"an f32 path launched a wgmma flash kernel (or serving a "
          f"backward): serve {f32_serve[:4]}, train {f32_train[:4]}")
    check(all(n > 0 for n in train[8:10] + moe[6:10]),
          f"training launched no wgmma K3f or K3b, K7d or K7c: {train}, "
          f"{moe}")
    check(train[4:6] == moe[4:6] == f32_train[4:6] == (0, 0),
          f"a training path launched chunked_ce.cu's K3 kernels: bf16 "
          f"{train[4:6]}, MoE {moe[4:6]}, f32 {f32_train[4:6]}")
    check(all(n > 0 for n in f32_train[12:15])
          and f32_train[8:10] == (0, 0),
          f"f32 training launched K3 off its path: {f32_train[4:10]} "
          f"{f32_train[12:15]}")
    check(train[12:15] == moe[12:15] == (0, 0, 0),
          "bf16 training launched the tf32 K3")
    check(serve[4:10] == modes[4:10] == f32_serve[4:10] == (0,) * 6
          and serve[12:15] == modes[12:15] == f32_serve[12:15] == (0,) * 3
          and train[6:8] == f32_train[6:8] == (0, 0),
          "serving launched K3 or K7, or a dense model K7")
    k4 = [(t[10], t[11], t[15]) for t in (serve, modes, f32_serve, train,
                                          moe, f32_train)]
    check(serve[15] > 0 and modes[15] > 0 and f32_serve[15] > 0
          and serve[10] == modes[10] == f32_serve[10] == 0
          and serve[11] == f32_serve[11] == 0 and modes[11] > 0
          and k4[3:] == [(0, 0, 0)] * 3,
          f"K4a, K4w or K4a+w off their paths (serve, modes, f32 serve, "
          f"train, moe, f32 train): {k4}")
    named = dict(zip(ALL_KERNELS, pipeline))
    check(named["wgmma"] > 0 and named["paged_attention_write"] > 0
          and named["kv_quant_write"] > 0 and named["paged_attention"] == 0
          and named["simple"] == 0 and sum(
              n for k, n in named.items() if k not in (
                  "wgmma", "paged_attention_write", "kv_quant_write")) == 0,
          f"the pipeline launched kernels off its path: {named}")
    for label, path, on in (("front door", frontdoor,
                             ("wgmma", "paged_attention_write")),
                            ("fleet demo", fleet,
                             ("simple", "paged_attention_write"))):
        named = dict(zip(ALL_KERNELS, path))
        check(all(named[k] > 0 for k in on)
              and sum(n for k, n in named.items() if k not in on) == 0,
              f"the {label} path launched kernels off its path: {named}")
    check(not any(network), f"the network paths launched port kernels: "
          f"{dict(zip(ALL_KERNELS, network))}")
    check(not any(detection), f"the detection path launched port kernels: "
          f"{dict(zip(ALL_KERNELS, detection))}")
    check(not any(transfer), f"the transfer path launched port kernels: "
          f"{dict(zip(ALL_KERNELS, transfer))}")
    check_scoring_launches(scoring)
    check_recurrent_launches(recurrent, wide, (
        serve, modes, train, moe, f32_serve, f32_train, pipeline, frontdoor,
        fleet, network, detection, transfer, scoring))


def check_scoring_launches(scoring):
    """The scoring path launches no hand kernel and never the attention
    op's plain route (the last of ALL_KERNELS)."""
    check(not any(scoring), f"the scoring path launched port kernels: "
          f"{dict(zip(ALL_KERNELS, scoring))}")


def recurrent_kernel_entries(launches, k11_rows, k11l_rows):
    """The kernels-line entries of K11f, K11b, K11Lf and K11Lb;
    ``launches`` maps each kernel to its launches by path."""
    return ([k11_kernel_entry(k, k11_rows, launches[k])
             for k in ("rnn_cell_fwd", "rnn_cell_bwd")]
            + [k11l_kernel_entry(k, k11l_rows, launches[k])
               for k in ("rnn_layer_fwd", "rnn_layer_bwd")])


def check_recurrent_launches(recurrent, wide, others=()):
    """The recurrent paths' launches: one fit of R1 K11Lf and K11Lb once a
    layer and chunk (2 × 20 each) and nothing else, the wide layer K11f
    and K11b once a step (50 each) and nothing else, and no path of
    ``others`` K11 or K11L."""
    chunks = 2 * (RNN_SEQ // RNN_TBPTT)
    check(recurrent == launch_counts(rnn_layer_fwd=chunks,
                                     rnn_layer_bwd=chunks),
          f"the recurrent path launched "
          f"{dict(zip(ALL_KERNELS, recurrent))}")
    check(wide == launch_counts(rnn_cell_fwd=RNN_TBPTT,
                                rnn_cell_bwd=RNN_TBPTT),
          f"the wide layer launched {dict(zip(ALL_KERNELS, wide))}")
    k11 = [ALL_KERNELS.index(k) for k in ("rnn_cell_fwd", "rnn_cell_bwd",
                                          "rnn_layer_fwd", "rnn_layer_bwd")]
    check(all(path[i] == 0 for path in others for i in k11),
          "a path other than the recurrent ones launched K11 or K11L")


#: rnn_cell.cu's kernels: K11f, K11b and K11Lf, K11Lb at 1, 2 and 4 rows
#: a cluster
RNN_CELL_INSTANTIATIONS = ["bwd", "fwd"] + [
    f"layer_{w} r{r}" for w in ("fwd", "bwd") for r in (1, 2, 4)]


def rnn_cell_ptxas(log):
    """{"fwd"|"bwd"|"layer_fwd r4"|...: {"registers": n, "spill_bytes":
    n}}: rnn_cell.cu's kernels."""
    return _ptxas(log, r"lstm_(layer_)?(fwd|bwd)_kernel(ILi(\d)E)?",
                  lambda m: (f"layer_{m.group(2)} r{m.group(4)}"
                             if m.group(1) else m.group(2)))


# --precision-f32: the f32 shapes of the kernel and backward phases
F32_PRECISION_CASES = [("3d", 16, 1, 256, 256, 64, "float32", True),
                       ("fused", 1, 16, 1024, 1024, 64, "float32", True),
                       ("fused", 8, 16, 1024, 1024, 64, "float32", True)]


def _attention_f64(torch, q, k, v, do, causal):
    """o, lse and (dq, dk, dv) of attention in f64 throughout: the truth
    the kernels and the plain versions are measured against."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2:]
        keep = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, vd) / l
    p = p / l
    dp = torch.matmul(dod, vd.transpose(-1, -2))
    ds = p * (dp - (dod * o).sum(-1, keepdim=True))
    return (o, (m + torch.log(l))[..., 0],
            (scale * torch.matmul(ds, kd),
             scale * torch.matmul(ds.transpose(-1, -2), qd),
             torch.matmul(p.transpose(-1, -2), dod)))


def precision_f32(torch, fa):
    """At F32_PRECISION_CASES, the f32 kernels and the plain versions each
    against f64: the forward's largest |Δo| and |Δlse|, the backward's
    largest 64-row tile relative L2 (the f32 K2 row's measure, its floor
    too), and the kernels against the plain versions, which is what the
    tolerance rows hold. The backward runs on the plain forward's o and lse
    on both sides."""
    rows = []
    for case in F32_PRECISION_CASES:
        (q, k, v, out, o, lse, do, grads,
         _sdpa) = bwd_case_inputs(torch, fa, case)
        causal, floor = case[7], GRAD_RMS_FLOOR["float32"]
        o_k = o.clone()
        o_p, lse_p = fa.flash_attention_reference(q, k, v, causal)
        o64, lse64, g64 = _attention_f64(torch, q, k, v, do, causal)
        g_k = fa.flash_attention_bwd(q, k, v, o_p, lse_p, do, causal,
                                     out=grads)
        g_p = fa.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do,
                                               causal)
        torch.cuda.synchronize()

        def worst(gs, refs):
            return max(tile_rel_l2(g, r, floor) for g, r in zip(gs, refs))

        rows.append({
            "case": case,
            "fwd_o": {"kernel_vs_plain": (o_k - o_p).abs().max().item(),
                      "kernel_vs_f64": (o_k.double() - o64).abs().max()
                      .item(),
                      "plain_vs_f64": (o_p.double() - o64).abs().max()
                      .item()},
            "fwd_lse": {"kernel_vs_f64": (lse.double() - lse64).abs().max()
                        .item(),
                        "plain_vs_f64": (lse_p.double() - lse64).abs().max()
                        .item()},
            "bwd_tile_l2": {"kernel_vs_plain": worst(g_k, g_p),
                            "kernel_vs_f64": worst(g_k, g64),
                            "plain_vs_f64": worst(g_p, g64)}})
        emit(precision=rows[-1])
        del o64, g64, g_p
        torch.cuda.empty_cache()
    return rows


# --precision-ce-f32: the f32 training shape of K3 (bench large config,
# batch 8)
CE_PRECISION_CASE = (8192, 32768, 1024, "float32", 8)


def precision_ce_f32(torch):
    """At CE_PRECISION_CASE, K3f's lse and K3b's dlogits of the first and
    last chunk from the plain versions, chunked_ce.cu's FMA kernels and
    the tf32 kernels, each against f64: the largest |Δlse|, and K3b's two
    rows (relative L2 off the targets, largest |Δ| at them over g/N)
    against the plain version (what TOL_CE_LSE and the f32 K3b rows hold)
    and against f64. Every K3b reads
    the plain version's lse, so its readings are its products' alone. Then
    each kernel's K3f and first-chunk K3b (on parts split beforehand)
    device ms, in turns (mma_sync, tf32, tf32, mma_sync)."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    case = CE_PRECISION_CASE
    n, v, d, _dtype, chunks = case
    c = v // chunks
    x, e, t = ce_inputs(torch, case)
    lse_p, _cor = ce.chunked_ce_fwd_reference(x, e, t, chunks)
    xd = x.double()
    m64 = torch.full((n,), -math.inf, dtype=torch.float64, device="cuda")
    l64 = torch.zeros((n,), dtype=torch.float64, device="cuda")
    for i in range(chunks):
        s64 = xd @ e[i * c:(i + 1) * c].double().T
        mn = torch.maximum(m64, s64.amax(-1))
        l64 = l64 * torch.exp(m64 - mn) + torch.exp(s64 - mn[:, None]).sum(-1)
        m64 = mn
    lse64 = m64 + torch.log(l64)
    gr = torch.ones((), device="cuda")
    kernels = ["mma_sync", "tf32"]
    row = {"case": case, "lse": {
        "plain_vs_f64": (lse_p.double() - lse64).abs().max().item()}}
    for kernel in kernels:
        lse_k, _loss = ce.chunked_ce_fwd(x, e, t, chunks, kernel=kernel)
        row["lse"][f"{kernel} vs plain"] = (lse_k - lse_p).abs().max().item()
        row["lse"][f"{kernel} vs f64"] = (lse_k.double() - lse64).abs().max(
        ).item()
    del m64, l64, lse64
    for i in (0, chunks - 1):
        e_c = e[i * c:(i + 1) * c]
        ref = ce.ce_dlogits_reference(x, e_c, t, lse_p, i * c, gr, n)
        s64 = xd @ e_c.double().T
        local = torch.where((t >= i * c) & (t < (i + 1) * c), t - i * c, -1)
        onehot = torch.zeros_like(s64)
        rows = torch.nonzero(local >= 0)[:, 0]
        onehot[rows, local[rows]] = 1.0
        d64 = (torch.exp(s64 - lse_p.double()[:, None]) - onehot) / n
        del s64, onehot
        readings = {"plain vs f64": dlogits_errors(ref.double(), d64, local,
                                                   1.0 / n)}
        for kernel in kernels:
            dl = ce.ce_dlogits(x, e_c, t, lse_p, i * c, gr, n, kernel=kernel)
            readings[f"{kernel} vs plain"] = dlogits_errors(dl, ref, local,
                                                            1.0 / n)
            readings[f"{kernel} vs f64"] = dlogits_errors(dl.double(), d64,
                                                          local, 1.0 / n)
        row[f"dlogits_chunk{i}"] = {
            k: {"rel_l2_off_target": a, "at_target_over_scale": b}
            for k, (a, b) in readings.items()}
        del d64, ref, dl
        torch.cuda.empty_cache()
    parts = ce.split_tf32(x, e)
    parts0 = parts[:2] + tuple(p[:c] for p in parts[2:])
    turns = {k: {"fwd": [], "dlogits": []} for k in kernels}
    for kernel in kernels + kernels[::-1]:
        for what, fn in (
                ("fwd", lambda k: ce.chunked_ce_fwd(x, e, t, chunks,
                                                    kernel=k)),
                ("dlogits", lambda k: ce.ce_dlogits(
                    x, e[:c], t, lse_p, 0, gr, n, kernel=k,
                    parts=parts0 if k == "tf32" else None))):
            turns[kernel][what].append(device_ms(
                lambda: fn(kernel), torch, launches=5, repeats=3))
    row["turns_device_ms"] = turns
    row["tolerance"] = {"lse": TOL_CE_LSE,
                        "rel_l2_off_target": TOL_CE_DLOG_L2["float32"],
                        "at_target_over_scale":
                        TOL_CE_DLOG_TARGET["float32"]}
    emit(precision_ce=row)
    return row


# one turn of --compare-bwd: the tree's own phases on the given cases
_TURN = """
import json, sys, torch, chip_smoke
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
fwd, bwd = json.loads(sys.argv[1])
chip_smoke.KERNEL_CASES = [tuple(c) for c in fwd]
chip_smoke.BWD_CASES = [tuple(c) for c in bwd]
chip_smoke.kernel_phase(torch, fa)
chip_smoke.bwd_phase(torch, fa)
"""


# the cases --compare-f32 times in turns: the simple forward and the
# mma.sync / FMA backward at the f32 shapes (the table's, the f32 model's
# prefill and training layer) and bf16 at the other head dims an earlier
# tree's kernels also take
F32_COMPARE_CASES = [("3d", 16, 1, 256, 256, 64, "float32", True),
                     ("fused", 1, 16, 1024, 1024, 64, "float32", True),
                     ("fused", 8, 16, 1024, 1024, 64, "float32", True),
                     ("3d", 16, 1, 512, 512, 32, "bfloat16", True),
                     ("3d", 16, 1, 512, 512, 80, "bfloat16", True),
                     ("3d", 16, 1, 512, 512, 96, "bfloat16", True)]


# one turn of --compare-decode: the tree's own K4a and K4w at the given
# cases, then its own engine over bf16 and int8 pages after a
# PROFILE_PROMPT-token prompt, at the large config
_DECODE_TURN = """
import json, statistics, sys, time
import numpy as np, torch, chip_smoke
cases, quant = json.loads(sys.argv[1])
chip_smoke.DECODE_CASES = [tuple(tuple(x) if isinstance(x, list) else x
                                 for x in c) for c in cases]
chip_smoke.QUANT_CASES = [tuple(c) for c in quant]
chip_smoke.SPLIT_SWEEP = {}
chip_smoke.FUSED_CASES = []
chip_smoke.decode_kernel_phase(torch)
from deeplearning4j_tpu_torch.models.generation import DecodeEngine
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout)
cfg = TransformerConfig(**chip_smoke.LARGE)
params = from_jax_params(init_jax_layout(cfg, chip_smoke.SEED), cfg)
model = TransformerLM(cfg)
prompt = np.random.default_rng(chip_smoke.SEED + 7).integers(
    0, cfg.vocab_size, (1, chip_smoke.PROFILE_PROMPT)).astype(np.int32)
for quant in (False, True):
    eng = DecodeEngine(model, params, max_len=cfg.max_len, kv_quant=quant)
    first, _l, kv, t = eng.prefill(prompt)

    def ready():
        state = eng.insert_slot(eng.new_state(1), kv, 0)
        toks, pos = first, np.full((1,), t, np.int32)
        toks, _l, state = eng.decode(state, toks, pos, 1)
        torch.cuda.synchronize()
        return [state, toks, pos]

    def steps(at, n):
        state, toks, pos = at
        start = time.perf_counter()
        for i in range(n):
            pos = pos + 1
            toks, _l, state = eng.decode(state, toks, pos, 2 + i)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - start) / n

    at = ready()
    row = chip_smoke.profile_window(torch, "decode", lambda: steps(at, 4),
                                    f"turn_decode_{int(quant)}.json")
    ms = [steps(ready(), 24) for _ in range(3)]
    print(json.dumps({"decode_turn": {
        "pool": "int8" if quant else "bfloat16",
        "int8_pool": eng.kv_quant, "kernels_per_step": row["kernels"] / 4,
        "device_busy_us_per_step": row["device_busy_us"] / 4,
        "busy_share": row["busy_share"],
        "host_ms_per_step": statistics.median(ms)}}), flush=True)
    del eng, kv
"""


def compare_decode(other, this=ROOT):
    """Each tree's K4a at the decode step on bf16 and int8 pages, the dense
    view and B 8, W 5, and its K4w at the bucket-1024 insert (device ms),
    then decode at the large config over bf16 and int8 pages: kernels a
    step and device busy time a step from a profiled window of 4 steps,
    and host ms a step over 24 steps (median of 3); in the checkout at
    ``other`` and in ``this`` in turns (other, this, this, other), each
    turn a subprocess of that tree. Returns {what: {"other": [x, x],
    "this": [x, x]}}."""
    arg = json.dumps([[DECODE_CASES[i] for i in (0, 7, 11, 6)],
                      [QUANT_CASES[0]]])
    out = {}
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        run = subprocess.run([sys.executable, "-c", _DECODE_TURN, arg],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        check(run.returncode == 0, f"decode turn in {root} failed:\n"
              f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            if "decode_turn" in row:
                r = row["decode_turn"]
                key = f"decode {r['pool']}"
            elif "decode_case" in row:
                r = row["decode_case"]["device_ms"]
                key = "K4a " + " ".join(str(row["decode_case"][k]) for k in (
                    "b", "w", "page_tokens", "pool", "contexts"))
            elif "quant_write_case" in row:
                r = row["quant_write_case"]["device_ms"]
                key = "K4w " + " ".join(str(row["quant_write_case"][k])
                                        for k in ("b", "w", "layers"))
            else:
                continue
            out.setdefault(key, {}).setdefault(label, []).append(r)
    return out


def compare_turns(other, this=ROOT, fwd=None, bwd=None):
    """Device ms of K1 at ``fwd`` and K2 at ``bwd`` (by default K1 at
    MAIN_CASE["wgmma"] and the training layer, and K2 at every bf16 d
    64/128 case of BWD_CASES), in the checkout at ``other`` and in
    ``this`` in turns (other, this, this, other), each turn a subprocess of
    that tree running its own ``kernel_phase`` and ``bwd_phase``. Returns
    {"fwd"|"bwd": {case: {"other": [ms, ms], "this": [ms, ms]}}}."""
    if fwd is None:
        fwd = [MAIN_CASE["wgmma"], KERNEL_CASES[13]]
    if bwd is None:
        bwd = [c for c in BWD_CASES
               if c[6] == "bfloat16" and c[5] in (64, 128)]
    arg = json.dumps([fwd, bwd])
    times = {"fwd": {}, "bwd": {}}
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        run = subprocess.run([sys.executable, "-c", _TURN, arg], cwd=root,
                             capture_output=True, text=True, timeout=900)
        check(run.returncode == 0, f"turn in {root} failed:\n"
              f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            row = json.loads(line) if line.startswith("{") else {}
            for kind, key in (("fwd", "kernel_case"), ("bwd", "bwd_case")):
                if key in row:
                    r = row[key]
                    case = " ".join(str(r[k]) for k in (
                        "layout", "b", "h", "t_q", "t_k", "d", "causal"))
                    times[kind].setdefault(case, {}).setdefault(
                        label, []).append(r["device_ms"])
    return times


# one turn of --compare-k11l: the tree's own K11Lf and K11Lb at the given
# cases, each one launch against the plain versions (the error, not
# checked: an ablated tree computes something else) and its device ms
_K11L_TURN = """
import json, sys, torch, chip_smoke
from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
for case in json.loads(sys.argv[1]):
    ops, dy, dh, dc = chip_smoke.k11l_inputs(torch, tuple(case))
    ref = rc.layer_fwd_reference(**ops, act=0)
    args = (dy, dh, dc, ref[3], ref[2], ops["c0"], ops["rw"], ops["peep"],
            ops["m"], 0)
    err = [chip_smoke.k11l_errors(rc.lstm_layer_fwd(**ops, act=0), ref)[0],
           chip_smoke.k11l_errors(rc.lstm_layer_bwd(*args),
                                  rc.layer_bwd_reference(*args))[0]]
    print(json.dumps({"k11l_turn": {
        "case": case, "max_rel_err": err,
        "fwd_device_ms": chip_smoke.device_ms(
            lambda: rc.lstm_layer_fwd(**ops, act=0), torch),
        "bwd_device_ms": chip_smoke.device_ms(
            lambda: rc.lstm_layer_bwd(*args), torch)}}))
"""


def compare_k11l(others, this=ROOT, cases=(K11L_MAIN_CASE,
                                           (RNN_BATCH, 200, True, False))):
    """Device ms of K11Lf and K11Lb at ``cases`` in the checkouts at
    ``others`` and in ``this``, in turns (others in order, this twice,
    others in reverse), each turn a subprocess of that tree timing its own
    kernels. Returns {case: {tree: {"fwd": [ms...], "bwd": [ms...],
    "max_rel_err": [fwd, bwd]}}}."""
    trees = [(str(o), o) for o in others]
    order = trees + [("this", this)] * 2 + trees[::-1]
    arg = json.dumps([list(c) for c in cases])
    times = {}
    for label, root in order:
        run = subprocess.run([sys.executable, "-c", _K11L_TURN, arg],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        check(run.returncode == 0, f"turn in {root} failed:\n"
              f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            r = (json.loads(line) if line.startswith("{") else {}).get(
                "k11l_turn")
            if r:
                got = times.setdefault(" ".join(map(str, r["case"])),
                                       {}).setdefault(
                    label, {"fwd": [], "bwd": []})
                got["fwd"].append(r["fwd_device_ms"])
                got["bwd"].append(r["bwd_device_ms"])
                got["max_rel_err"] = r["max_rel_err"]
    return times


def check_rnn_cell_build(build):
    """K11's and K11L's kernels spill nothing (when compiled in this
    run)."""
    log = build.build_logs.get("rnn_cell")
    if log is not None:
        report = rnn_cell_ptxas(log)
        emit(rnn_cell_ptxas=report)
        check(spill_free(report, RNN_CELL_INSTANTIATIONS),
              f"K11, K11L: want no spills in their "
              f"{len(RNN_CELL_INSTANTIATIONS)} kernels, ptxas gave {report}")


# ----------------------------------------- SameDiff and TF GraphDef import
# BERT-base (BASELINE.json configs[3]: "SameDiff TF-import: BERT-base
# fine-tune"): HuggingFace's TFBertModel frozen to a GraphDef, shipped as a
# skeleton (modelimport/skeletons/, written by tools/bert_skeleton.py) and
# filled from SEED here; imported by the port's TF importer, its weights
# promoted to variables and a [CLS] head attached, then SameDiff.fit
SD_CHECK_SKELETON = "bert_base_b2_t128"     # (a) card against CPU
SD_FIT_SKELETON = "bert_base_b32_t128"      # (b) the fine-tune
SD_CHECK_SHAPE, SD_FIT_SHAPE = (2, 128), (32, 128)   # (batch, seq) of each
SD_VOCAB, SD_HIDDEN, SD_CLASSES = 30522, 768, 2
SD_LR = 2e-5
SD_CHECK_STEPS = 3
SD_WARM, SD_TIMED = 2, 10
# (b)'s moments pass off and on (DL4J_TPU_GRAPH_OPT), in turns after the
# timed steps: each turn one untimed step, SD_OPT_STEPS timed, one profiled
SD_OPT_TURNS = ("0", "1", "1", "0")
SD_OPT_STEPS = 5
SD_MIN_PROMOTE = 512                        # elements: the weight tensors
SD_RAGGED_KEEP = 100                        # (a): mask[1, 100:] = 0
SD_ATTENTION = (32, 12, 128, 64)            # (c): B, heads, T, head dim
# (a)'s rows (PERF.md states the reasons): the card's imported BERT-base
# against the port's CPU on the same weights, f32, TF32 off
TOL_SD = {"last_hidden_state": 5e-4, "loss": 1e-4, "grad": 1e-4}
# a gradient leaf under SD_ZERO_SHARE of the whole gradient's norm is zero
# in exact arithmetic and reads rounding: only such a leaf's norm is
# floored, at SD_GRAD_FLOOR of the whole
SD_ZERO_SHARE = 1e-6
SD_GRAD_FLOOR = 1e-3


def sd_promote(sd, min_size=SD_MIN_PROMOTE):
    """Every float constant over ``min_size`` elements made trainable (the
    imported encoder's weights); returns the count."""
    n = 0
    for var in list(sd.variables()):
        if (var.var_type.value == "CONSTANT" and var.shape
                and var.dtype.is_floating_point
                and int(np.prod(var.shape)) > min_size):
            var.convert_to_variable()
            n += 1
    return n


def sd_output_name(gd):
    """The frozen graph's output: its last Identity node."""
    return [n.name for n in gd.node if n.op == "Identity"][-1]


def sd_attach_head(sd, gd, lr=SD_LR, seed=SEED):
    """A linear head on the [CLS] position, softmax cross-entropy and an
    Adam training config. The head's weights are drawn (normal, 0.02) so
    the trunk's first gradient is not zero."""
    from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    hidden = sd.get_variable(sd_output_name(gd))            # (B, T, H)
    cls = hidden[:, 0]
    w = sd.var("head_w", init=np.random.default_rng(seed).normal(
        0.0, 0.02, (SD_HIDDEN, SD_CLASSES)).astype(np.float32))
    b = sd.var("head_b", init=np.zeros((SD_CLASSES,), np.float32))
    logits = cls.mmul(w) + b
    lab = sd.placeholder("label", (None, SD_CLASSES))
    sd.loss.softmax_cross_entropy(lab, logits).rename("loss")
    sd.set_training_config(TrainingConfig(
        updater=Adam(lr), data_set_feature_mapping=["input_ids",
                                                    "attention_mask"],
        data_set_label_mapping=["label"], loss_variables=["loss"]))
    return sd


def sd_batches(n, batch, seq, seed=SEED, ragged=False):
    """``n`` MultiDataSets of token ids, attention masks and one-hot labels
    (numpy, from ``seed``); ``ragged`` masks row 1 past SD_RAGGED_KEEP."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, SD_VOCAB, (batch, seq)).astype(np.int32)
        mask = np.ones((batch, seq), np.int32)
        if ragged:
            mask[1, SD_RAGGED_KEEP:] = 0
        y = np.eye(SD_CLASSES, dtype=np.float32)[
            rng.integers(0, SD_CLASSES, batch)]
        out.append(MultiDataSet([ids, mask], [y]))
    return out


def sd_feed(ds):
    return {"input_ids": ds.features[0], "attention_mask": ds.features[1],
            "label": ds.labels[0]}


def sd_card_vs_cpu(torch):
    """(a): the (2, 128) BERT-base imported on the card and on the CPU from
    one filled skeleton; last_hidden_state under a ragged mask, the first
    gradient and 3 Adam steps, each side against the other."""
    from deeplearning4j_tpu_torch.modelimport import tf_skeleton
    from deeplearning4j_tpu_torch.modelimport.tfimport import TFGraphMapper

    gd = tf_skeleton.fill_skeleton(
        tf_skeleton.load_skeleton(SD_CHECK_SKELETON), SEED)
    out_name = sd_output_name(gd)
    card = TFGraphMapper.import_graph(gd, device=None)
    cpu = TFGraphMapper.import_graph(gd, device="cpu")
    data = sd_batches(SD_CHECK_STEPS, *SD_CHECK_SHAPE, seed=SEED + 1,
                      ragged=True)
    feed = sd_feed(data[0])
    h_card = card.output(feed, out_name)[out_name].cpu().numpy()
    h_cpu = cpu.output(feed, out_name)[out_name].numpy()
    check(np.isfinite(h_card).all(), "(a) the card's last_hidden_state "
          "holds a non-finite value under the ragged mask")
    for sd in (card, cpu):
        sd_promote(sd)
        sd_attach_head(sd, gd)
    g_card = card.calculate_gradients(feed)
    g_cpu = cpu.calculate_gradients(feed)
    got = {n: g_card[n].cpu().numpy() for n in g_cpu}
    want = {n: g_cpu[n].numpy() for n in g_cpu}
    raw = {n: rel_l2(got[n], want[n]) for n in want}
    norms = {n: float(np.linalg.norm(w.astype(np.float64)))
             for n, w in want.items()}
    whole = math.sqrt(sum(v * v for v in norms.values()))
    # the key projections' biases have a zero gradient in exact arithmetic
    # (q·bk shifts a query's every score alike), so they read rounding;
    # only leaves that small are floored, and each is printed
    floored = sorted(n for n in want if norms[n] < SD_ZERO_SHARE * whole)
    grads = dict(raw)
    for n in floored:
        grads[n] = rel_l2(got[n], want[n], floor=SD_GRAD_FLOOR * whole)
    held = [n for n in want if n not in floored]
    smallest = min(held, key=norms.get)
    l_card = list(card.fit(data))
    l_cpu = list(cpu.fit(data))
    report = {"last_hidden_state": float(np.abs(h_card - h_cpu).max()),
              "loss": max(abs(a - b) for a, b in zip(l_card, l_cpu)),
              "grad": max(grads.values())}
    failed = rows_failed(report, TOL_SD)
    worst_leaf = max(grads, key=grads.get)
    worst_held = max(held, key=raw.get)
    emit(samediff_card_vs_cpu=report, rows=TOL_SD, failed=failed,
         trainable=len(g_cpu), worst_grad_leaf=worst_leaf,
         grad_norm=whole, zero_share=SD_ZERO_SHARE, grad_floor=SD_GRAD_FLOOR,
         floored={n: {"norm": norms[n], "rel_l2_unfloored": raw[n],
                      "rel_l2": grads[n]} for n in floored},
         worst_unfloored={"leaf": worst_held, "norm": norms[worst_held],
                          "rel_l2": raw[worst_held]},
         smallest_unfloored={"leaf": smallest, "norm": norms[smallest],
                             "rel_l2": raw[smallest]},
         losses_card=l_card, losses_cpu=l_cpu)
    check(not failed, f"(a) the card's BERT-base against the CPU's: "
          f"{failed} over {TOL_SD}: {report} (worst leaf {worst_leaf})")
    return report


def sd_fine_tune(torch, smi):
    """(b): the (32, 128) BERT-base filled, imported onto the card, fit
    with Adam for SD_WARM warm-up and SD_TIMED timed steps; then the
    moments pass off and on in turns (``sd_opt_turns``)."""
    from deeplearning4j_tpu_torch.modelimport import tf_skeleton
    from deeplearning4j_tpu_torch.modelimport.tfimport import TFGraphMapper

    t0 = time.perf_counter()
    gd = tf_skeleton.fill_skeleton(
        tf_skeleton.load_skeleton(SD_FIT_SKELETON), SEED)
    t1 = time.perf_counter()
    sd = TFGraphMapper.import_graph(gd, device=None)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    promoted = sd_promote(sd)
    sd_attach_head(sd, gd)
    batch, seq = SD_FIT_SHAPE
    data = sd_batches(SD_WARM + SD_TIMED + 1 + SD_OPT_STEPS + 2, batch, seq,
                      seed=SEED + 2)
    torch.cuda.reset_peak_memory_stats()
    losses = list(sd.fit(data[:SD_WARM]))
    torch.cuda.synchronize()
    step_ms = []
    for ds in data[SD_WARM:SD_WARM + SD_TIMED]:
        t = time.perf_counter()
        losses += list(sd.fit(ds))          # ends in float(loss): synced
        step_ms.append(1e3 * (time.perf_counter() - t))
    prof = profile_window(torch, "samediff_step",
                          lambda: sd.fit(data[SD_WARM + SD_TIMED]),
                          "samediff_bert_step_trace.json")
    turns = sd_opt_turns(torch, sd, data[SD_WARM + SD_TIMED + 1:], losses)
    check(all(np.isfinite(losses)), f"(b) a non-finite loss: {losses}")
    mean_ms = float(np.mean(step_ms))
    n_params = sum(int(np.prod(sd.get_variable(n).shape))
                   for n in sd.trainable_names())
    report = {"batch": batch, "seq": seq, "trainable_tensors": promoted + 2,
              "params": n_params, "ops": len(sd.ops()),
              "fill_s": t1 - t0, "import_s": t2 - t1,
              "step_ms": step_ms, "step_ms_mean": mean_ms,
              "step_ms_median": float(np.median(step_ms)),
              "samples_per_s": batch * 1e3 / mean_ms,
              "profiled_step": prof,
              "kernels_per_step": prof.get("kernels"),
              "device_busy_ms_per_step": (prof.get("device_busy_us", 0.0)
                                          / 1e3),
              "busy_share": prof.get("busy_share"),
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "graph_opt_turns": turns,
              "losses": losses, "gpu": smi}
    emit(samediff_fine_tune=report)
    del sd, gd
    return report


def sd_opt_turns(torch, sd, data, losses):
    """(b)'s fit with ``DL4J_TPU_GRAPH_OPT`` set by SD_OPT_TURNS, one turn
    after another on the same graph: each turn one untimed step (the walk
    is built once for each setting), SD_OPT_STEPS timed steps and one
    profiled. Appends the losses to ``losses``; returns, per turn, the
    setting, the rewritten motifs, host ms a step and the profiled step's
    device ms and kernels. The switch is put back as it was."""
    import os

    from deeplearning4j_tpu_torch.autodiff.passes import fuse_two_pass_moments

    motifs = fuse_two_pass_moments(sd.ops())[1]
    before = os.environ.get("DL4J_TPU_GRAPH_OPT")
    turns = []
    try:
        for i, opt in enumerate(SD_OPT_TURNS):
            os.environ["DL4J_TPU_GRAPH_OPT"] = opt
            losses += list(sd.fit(data[0]))
            step_ms = []
            for ds in data[1:1 + SD_OPT_STEPS]:
                t = time.perf_counter()
                losses += list(sd.fit(ds))
                step_ms.append(1e3 * (time.perf_counter() - t))
            prof = profile_window(torch, f"samediff_opt{opt}_{i}",
                                  lambda: sd.fit(data[-1]),
                                  f"samediff_opt{opt}_{i}_trace.json")
            turns.append({"graph_opt": opt,
                          "motifs_rewritten": motifs if opt == "1" else 0,
                          "step_ms": step_ms,
                          "step_ms_median": float(np.median(step_ms)),
                          "device_busy_ms": prof.get("device_busy_us", 0.0)
                          / 1e3,
                          "kernels": prof.get("kernels"),
                          "busy_share": prof.get("busy_share")})
    finally:
        if before is None:
            os.environ.pop("DL4J_TPU_GRAPH_OPT", None)
        else:
            os.environ["DL4J_TPU_GRAPH_OPT"] = before
    emit(samediff_graph_opt_turns=turns)
    return turns


def sd_attention_graph(torch, dev, plain):
    """(c)'s graph: q, k, v variables at BERT-base's widths, a ragged key
    mask placeholder, the registry's attention (or, with ``plain``, its
    plain version as a lambda op) and a seeded projection as the loss."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.ops import standard as std

    b, h, t, d = SD_ATTENTION
    rng = np.random.default_rng(SEED + 3)
    sd = SameDiff.create(dev)
    q, k, v = (sd.var(n, init=rng.standard_normal((b, h, t, d)).astype(
        np.float32)) for n in ("q", "k", "v"))
    mask = sd.placeholder("mask", (b, 1, 1, t), torch.bool)
    if plain:
        att = sd.lambda_op(std.dot_product_attention_plain, q, k, v, mask)
    else:
        att = sd.nn.multi_head_dot_product_attention(q, k, v, mask)
    proj = sd.constant(rng.standard_normal((b, h, t, d)).astype(np.float32))
    (att * proj).sum().rename("loss")
    att.rename("att")
    sd.set_loss_variables("loss")
    keep = rng.integers(t // 2, t + 1, b)
    feed = {"mask": (np.arange(t)[None, :] < keep[:, None])[:, None, None]}
    return sd, feed


def sd_attention_check(torch):
    """(c): the registry's attention in a SameDiff graph on the card (K1 in
    output, K2 in calculate_gradients) against the same graph on the op's
    plain version, at the f32 K1/K2 rows; returns the launches."""
    sd, feed = sd_attention_graph(torch, None, plain=False)
    ref, _ = sd_attention_graph(torch, None, plain=True)
    before = all_counts()
    o = sd.output(feed, "att")["att"]
    g = sd.calculate_gradients(feed)
    torch.cuda.synchronize()
    launched = delta(before)
    o_ref = ref.output(feed, "att")["att"]
    g_ref = ref.calculate_gradients(feed)
    err_o = float((o - o_ref).abs().max())
    err_g = {n: float((g[n] - g_ref[n]).abs().max()
                      / max(1.0, float(g_ref[n].abs().max())))
             for n in ("q", "k", "v")}
    named = dict(zip(ALL_KERNELS, launched))
    emit(samediff_attention={"shape": SD_ATTENTION, "max_abs_err_o": err_o,
                             "grad_err": err_g, "launches": named,
                             "tol_o": TOL_O["float32"],
                             "tol_grad": TOL_GRAD["float32"]})
    check(err_o <= TOL_O["float32"], f"(c) SameDiff attention output "
          f"{err_o} over {TOL_O['float32']}")
    check(max(err_g.values()) <= TOL_GRAD["float32"], f"(c) SameDiff "
          f"attention gradients {err_g} over {TOL_GRAD['float32']}")
    check(named["simple"] >= 1 and named["bwd"] >= 1,
          f"(c) the SameDiff attention graph did not launch K1 and K2: "
          f"{named}")
    return launched


def samediff_phase(torch, smi=None):
    """SameDiff and TF import on the card: (a) the imported BERT-base
    against the port's CPU, (b) its fine-tune at (32, 128), (c) the
    registry's attention op through SameDiff on K1/K2. Returns (the
    imported path's launches over (a) and (b), (c)'s launches); the
    imported path must launch no port kernel (its attention is
    BatchMatMulV2 + Softmax)."""
    reset_all_counts()
    sd_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    sd_fine_tune(torch, smi)
    imported = all_counts()
    torch.cuda.empty_cache()
    check(not any(imported), f"the imported BERT path launched port "
          f"kernels: {dict(zip(ALL_KERNELS, imported))}")
    reset_all_counts()
    attention = sd_attention_check(torch)
    torch.cuda.empty_cache()
    return imported, attention


# ------------------------------------------- ONNX import (the op registry)
# The zoo's ResNet-50 (network_phase's configuration: 224²x3, 1000
# classes, numpy-seeded N(0, 1) images) authored as an ONNX model in NCHW
# by tools/onnx_resnet.py from the net's seeded weights, its
# BatchNormalization statistics first set from ONNX_CALIB images
# (calibrate_bn), then imported by the port's ONNX importer
ONNX_CHECK_BATCH = 2                 # (a) card against the port's CPU
ONNX_BATCH = 32                      # (b) and (c)
ONNX_CALIB = 32
ONNX_CHECK_STEPS = 3
ONNX_LR = 1e-4
ONNX_WARM, ONNX_TIMED = 2, 10        # (c) output calls
ONNX_FIT_WARM, ONNX_FIT_TIMED = 2, 5  # (c) fit steps
# (a) and (b) are the same f32 function with sums in another order over 53
# convolutions: network_phase's ResNet-50 f32 card-vs-CPU rows
# (TOL_NET_F32: probabilities max |Δ| 1e-3, loss 1e-4, the worst
# gradient leaf's relative L2 0.2), logits by relative L2 at the
# probabilities' 1e-3
TOL_ONNX = {"probs": TOL_NET_F32["probs"], "logits": 1e-3,
            "loss": TOL_NET_F32["loss"], "grad": TOL_NET_F32["grad"]}
# (b) the logits must separate the 32 images: their standard deviation
# over the batch, averaged over the classes, above this floor (constant
# outputs read 0)
ONNX_SPREAD_FLOOR = 1e-2
# (d) the registry's fused attention ops at BERT-base's widths
# (SD_ATTENTION: B, heads, T, head dim), f32 and bf16, (causal, masked)
# on the kernels against the same graph on the ops' plain versions, at
# the K1/K2 rows (TOL_O, TOL_GRAD): outputs max |Δ|, gradients max |Δ|
# over max(1, max |g|)
ONNX_ATT_VARIANTS = ((False, True), (True, False))
# a bf16 gradient leaves the kernels through a bf16 projection, one more
# rounding of the output's size: the bf16 output row holds it
TOL_ONNX_GRAD = {"float32": TOL_GRAD["float32"], "bfloat16": TOL_O["bfloat16"]}
K1_NAMES, K2_NAMES = ("wgmma", "simple"), ("bwd_wgmma", "bwd")


def onnx_net(torch, dev):
    """The zoo ResNet-50 on ``dev`` with its BN statistics calibrated on
    ONNX_CALIB seeded images."""
    net = zoo_resnet("float32").init_model(device=dev)
    x, _ = network_data(ONNX_CALIB, seed=SEED + 41)
    calibrate_bn(torch, net, x)
    return net


def onnx_logits(torch, net, x):
    """The NHWC net's logits: the output layer's affine map of its
    input."""
    with torch.no_grad():
        acts, _, _ = net._forward(net._params, net._states,
                                  (net._to_device(x),), False, None)
        node = net.conf.nodes["output"]
        p = net._params["output"]
        return (acts[node.inputs[0]].float() @ p["W"] + p["b"]).cpu().numpy()


def onnx_trainable(sd):
    """Labels, softmax cross-entropy on the imported logits, Adam."""
    from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
    from deeplearning4j_tpu_torch.optim.updaters import Adam

    lab = sd.placeholder("labels", (None, NET_CLASSES))
    sd.loss.softmax_cross_entropy(lab, sd.get_variable("logits")).rename(
        "loss")
    sd.set_training_config(TrainingConfig(
        updater=Adam(ONNX_LR), data_set_feature_mapping=["input"],
        data_set_label_mapping=["labels"], loss_variables=["loss"]))
    return sd


def onnx_batches(n, batch, seed):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    out = []
    for i in range(n):
        x, y = network_data(batch, seed=seed + i)
        out.append(DataSet(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y))
    return out


def moved(tree, device):
    """``tree`` (dicts, lists, tuples and named tuples of tensors) with
    every tensor on ``device``, its containers' types kept."""
    if hasattr(tree, "to") and hasattr(tree, "device"):
        return tree.to(device)
    if isinstance(tree, dict):
        return type(tree)((k, moved(v, device)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(moved(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(moved(v, device) for v in tree)
    return tree


def onnx_card_vs_cpu(torch, model):
    """(a): the authored model imported on the card and on the port's CPU
    at (2, 3, 224, 224): logits and probabilities; then imported
    trainable, the first gradient's per-leaf relative L2 and 3 Adam steps'
    losses in lock-step: after each step the card takes the CPU's
    parameters and Adam state, so every step's loss is the same function
    of the same state on both sides. (Run free, the two trajectories part:
    the first gradient's leaves already differ by ~2 % between two f32
    computations, the chaotic regime network_phase's rows record, and
    Adam turns that into losses 0.03-0.1 apart by the third step.)"""
    from deeplearning4j_tpu_torch.modelimport.onnximport import (
        OnnxGraphMapper)
    data = onnx_batches(ONNX_CHECK_STEPS, ONNX_CHECK_BATCH, SEED + 43)
    feed = {"input": data[0].features}
    outs = []
    for dev in (None, "cpu"):
        sd = OnnxGraphMapper.import_model(model, device=dev)
        got = sd.output(feed, ["logits", "output"])
        outs.append({k: v.float().cpu().numpy() for k, v in got.items()})
        del sd
    card, cpu = outs
    check(all(np.isfinite(v).all() for v in card.values()),
          "(a) non-finite imported outputs on the card")
    sds = [onnx_trainable(OnnxGraphMapper.import_model(
        model, trainable=True, device=dev)) for dev in (None, "cpu")]
    grads = []
    for sd in sds:
        g = sd.calculate_gradients(dict(feed, labels=data[0].labels))
        grads.append({n: t.float().cpu().numpy() for n, t in g.items()})
    losses = [[], []]
    for ds in data:
        for side, sd in zip(losses, sds):
            side += [float(v) for v in sd.fit([ds])]
        on_card, on_cpu = sds
        for n in on_cpu.trainable_names():
            on_card._values[n] = on_cpu._values[n].to(on_card.device)
        on_card._opt_state = moved(on_cpu._opt_state, on_card.device)
    del sds
    torch.cuda.empty_cache()
    leaf = {n: rel_l2(grads[0][n], grads[1][n]) for n in grads[1]}
    report = {"probs": float(np.abs(card["output"] - cpu["output"]).max()),
              "logits": rel_l2(card["logits"], cpu["logits"]),
              "loss": max(abs(a - b) for a, b in zip(*losses)),
              "grad": max(leaf.values())}
    failed = rows_failed(report, TOL_ONNX)
    worst = max(leaf, key=leaf.get)
    emit(onnx_card_vs_cpu=report, rows=TOL_ONNX, failed=failed,
         trainable=len(leaf), worst_grad_leaf=worst,
         median_grad_leaf=statistics.median(leaf.values()),
         losses_card=losses[0], losses_cpu=losses[1])
    check(all(math.isfinite(v) for v in losses[0]),
          f"(a) non-finite losses {losses[0]}")
    check(not failed, f"(a) the imported ResNet-50 on the card against the "
          f"CPU's: {failed} over {TOL_ONNX}: {report} (worst leaf {worst})")
    return report


def onnx_vs_graph(torch, net, model):
    """(b): the imported graph's output on the card against the port's
    NHWC ComputationGraph on the same weights, ONNX_BATCH images; the
    logits must separate the images."""
    from deeplearning4j_tpu_torch.modelimport.onnximport import (
        OnnxGraphMapper)
    x, _ = network_data(ONNX_BATCH, seed=SEED + 47)
    sd = OnnxGraphMapper.import_model(model)
    got = sd.output({"input": np.ascontiguousarray(x.transpose(0, 3, 1, 2))},
                    ["logits", "output"])
    probs = got["output"].float().cpu().numpy()
    logits = got["logits"].float().cpu().numpy()
    want_p = net.output(x).float().cpu().numpy()
    want_l = onnx_logits(torch, net, x)
    spread = float(np.std(logits, axis=0).mean())
    report = {"probs": float(np.abs(probs - want_p).max()),
              "logits": rel_l2(logits, want_l)}
    failed = rows_failed(report, {k: TOL_ONNX[k] for k in report})
    emit(onnx_vs_graph=report, logit_spread=spread,
         spread_floor=ONNX_SPREAD_FLOOR, failed=failed,
         top1_agree=float((probs.argmax(1) == want_p.argmax(1)).mean()))
    check(not failed, f"(b) the imported ResNet-50 against the NHWC "
          f"ComputationGraph: {failed}: {report}")
    check(spread > ONNX_SPREAD_FLOOR, f"(b) the logits do not separate the "
          f"images: spread {spread} <= {ONNX_SPREAD_FLOOR}")
    del sd
    return report


def onnx_serve_and_fit(torch, model, smi):
    """(c): the imported graph served at ONNX_BATCH, 224², f32:
    ONNX_WARM + ONNX_TIMED output calls; then imported trainable and fit,
    ONNX_FIT_WARM + ONNX_FIT_TIMED steps; host ms, device ms and kernels
    per call and step, the busy share, images/s, every loss."""
    from deeplearning4j_tpu_torch.modelimport.onnximport import (
        OnnxGraphMapper)
    t0 = time.perf_counter()
    sd = OnnxGraphMapper.import_model(model)
    import_s = time.perf_counter() - t0
    data = onnx_batches(ONNX_FIT_WARM + ONNX_FIT_TIMED, ONNX_BATCH,
                        SEED + 53)
    feed = {"input": data[0].features}

    def call():
        sd.output(feed, "output")

    for _ in range(ONNX_WARM):
        call()
    torch.cuda.synchronize()
    host = []
    for _ in range(ONNX_TIMED):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t))
    prof = profile_window(torch, "onnx_output",
                          lambda: [call() for _ in range(3)],
                          "onnx_output_trace.json")
    serve = {"host_ms": statistics.median(host), "host_ms_all": host,
             "images_per_s": ONNX_BATCH * 1e3 / statistics.median(host),
             "device_ms": prof.get("device_busy_us", 0) / 3e3,
             "kernels_per_call": prof.get("kernels", 0) / 3,
             "busy_share": prof.get("busy_share"),
             "top_kernels": prof.get("top_kernels")}
    del sd
    torch.cuda.empty_cache()
    sd = onnx_trainable(OnnxGraphMapper.import_model(model, trainable=True))
    losses, host = [], []
    for i, ds in enumerate(data):
        t = time.perf_counter()
        losses += [float(v) for v in sd.fit([ds])]
        torch.cuda.synchronize()
        if i >= ONNX_FIT_WARM:
            host.append(1e3 * (time.perf_counter() - t))
    prof = profile_window(torch, "onnx_fit", lambda: sd.fit([data[-1]]),
                          "onnx_fit_trace.json")
    fit = {"host_ms": statistics.median(host), "host_ms_all": host,
           "images_per_s": ONNX_BATCH * 1e3 / statistics.median(host),
           "device_ms": prof.get("device_busy_us", 0) / 1e3,
           "kernels_per_step": prof.get("kernels", 0),
           "busy_share": prof.get("busy_share"),
           "top_kernels": prof.get("top_kernels"), "losses": losses}
    del sd
    torch.cuda.empty_cache()
    emit(onnx_serve={"gpu": smi, "batch": ONNX_BATCH, "import_s": import_s,
                     **serve},
         onnx_fit={"gpu": smi, "batch": ONNX_BATCH, "lr": ONNX_LR, **fit})
    check(all(math.isfinite(v) for v in losses),
          f"(c) non-finite fit losses {losses}")
    return serve, fit


def plain_mha(q, k, v, wq, wk, wv, wo, mask=None, causal=False):
    """The fused attention op's plain version (ops.standard
    .attention_plain for its core), for the comparison only."""
    import torch
    from deeplearning4j_tpu_torch.ops import standard as std

    def proj(x, w):
        return torch.einsum("ntd,dhk->nhtk", x, w)

    o = std.attention_plain(proj(q, wq), proj(k, wk), proj(v, wv), mask,
                            causal)
    return torch.einsum("nhtk,hkd->ntd", o, wo)


def onnx_attention_graph(torch, op, dtype, causal, masked, plain):
    """One SameDiff graph at SD_ATTENTION's widths running ``op`` (the
    registry's op, or with ``plain`` its plain version as a lambda op)
    over seeded variables, with a ragged key mask placeholder when
    ``masked``; a seeded projection of its output is the loss."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.ops import standard as std

    b, h, t, d = SD_ATTENTION
    dm = h * d
    rng = np.random.default_rng(SEED + 61)
    sd = SameDiff.create()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def var(name, shape, scale=1.0):
        v = sd.var(name, init=(rng.standard_normal(shape) * scale).astype(
            np.float32))
        return sd._op("cast", v, dtype=dtype) if dtype != "float32" else v

    mask = (sd.placeholder("mask", (b, 1, 1, t), torch.bool) if masked
            else None)
    if op == "dot_product_attention_v2":
        ins = [var(n, (b, h, t, d)) for n in ("q", "k", "v")]
        shape_out = (b, h, t, d)
        if plain:
            out = sd.lambda_op(lambda q, k, v, *m: std.attention_plain(
                q, k, v, m[0] if m else None, causal, 1.0 / math.sqrt(d)),
                *ins, *([mask] if masked else []))
        elif masked:
            # the op takes its mask by keyword (its fourth place is scale)
            out = sd.lambda_op(lambda q, k, v, m: registry.exec_op(
                op, q, k, v, causal=causal, mask=m), *ins, mask)
        else:
            out = sd._op(op, *ins, causal=causal)
    else:
        ins = [var(n, (b, t, dm)) for n in ("q", "k", "v")]
        ins += [var(n, (dm, h, d), 1 / math.sqrt(dm))
                for n in ("wq", "wk", "wv")]
        ins += [var("wo", (h, d, dm), 1 / math.sqrt(dm))]
        shape_out = (b, t, dm)
        args = ins + ([mask] if masked else [])
        if plain:
            out = sd.lambda_op(lambda *a: plain_mha(*a, causal=causal),
                               *args)
        else:
            out = sd._op(op, *args, causal=causal)
    out.rename("att")
    proj = sd.constant(rng.standard_normal(shape_out).astype(np.float32))
    (sd._op("cast", out, dtype="float32") * proj).sum().rename("loss")
    sd.set_loss_variables("loss")
    keep = rng.integers(t // 2, t + 1, b)
    feed = ({"mask": (np.arange(t)[None, :] < keep[:, None])[:, None, None]}
            if masked else {})
    return sd, feed


def onnx_bp_graph(torch, dtype, causal, masked, plain):
    """``multi_head_dot_product_attention_bp`` in a graph (or, with
    ``plain``, autograd of the plain version as a lambda op): the seven
    gradients of a seeded cotangent."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    from deeplearning4j_tpu_torch.ops.tranche4 import vjp

    b, h, t, d = SD_ATTENTION
    dm = h * d
    rng = np.random.default_rng(SEED + 67)
    sd = SameDiff.create()
    arrs = [rng.standard_normal((b, t, dm)) for _ in range(3)]
    arrs += [rng.standard_normal((dm, h, d)) / math.sqrt(dm)
             for _ in range(3)]
    arrs += [rng.standard_normal((h, d, dm)) / math.sqrt(dm),
             rng.standard_normal((b, t, dm))]
    ins = [sd.constant(a.astype(np.float32)) for a in arrs]
    if dtype != "float32":
        ins = [sd._op("cast", v, dtype=dtype) for v in ins]
    mask = ([sd.placeholder("mask", (b, 1, 1, t), torch.bool)] if masked
            else [])
    if plain:
        outs = sd.lambda_op(lambda *a: vjp(
            lambda *x: plain_mha(*x, *a[8:], causal=causal), a[:7], a[7]),
            *ins, *mask, n_out=7)
    else:
        outs = sd._op("multi_head_dot_product_attention_bp", *ins, *mask,
                      causal=causal)
    names = [f"d{n}" for n in ("q", "k", "v", "wq", "wk", "wv", "wo")]
    for o, n in zip(outs, names):
        o.rename(n)
    keep = rng.integers(t // 2, t + 1, b)
    feed = ({"mask": (np.arange(t)[None, :] < keep[:, None])[:, None, None]}
            if masked else {})
    return sd, feed, names


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _rel_err(got, want):
    return _max_err(got, want) / max(1.0, float(want.float().abs().max()))


def onnx_attention_check(torch):
    """(d): the fused attention ops of the registry on the card at
    BERT-base's widths, f32 and bf16, causal and key-masked: each graph's
    output (K1) and gradients (K2), and the ``_bp`` op (K1 and K2), against
    the same graphs on the ops' plain versions; every path must launch K1
    and K2 and take no plain route. Returns the launches summed."""
    total = [0] * len(ALL_KERNELS)
    rows = []
    for dtype in ("float32", "bfloat16"):
        for causal, masked in ONNX_ATT_VARIANTS:
            for op in ("multi_head_dot_product_attention",
                       "dot_product_attention_v2", "bp"):
                if op == "bp":
                    sd, feed, names = onnx_bp_graph(torch, dtype, causal,
                                                    masked, False)
                    ref, _, _ = onnx_bp_graph(torch, dtype, causal, masked,
                                              True)
                    before = all_counts()
                    got = sd.output(feed, names)
                    torch.cuda.synchronize()
                    launched = delta(before)
                    want = ref.output(feed, names)
                    err_o = 0.0
                    err_g = {n: _rel_err(got[n], want[n]) for n in names}
                else:
                    sd, feed = onnx_attention_graph(torch, op, dtype, causal,
                                                    masked, False)
                    ref, _ = onnx_attention_graph(torch, op, dtype, causal,
                                                  masked, True)
                    before = all_counts()
                    o = sd.output(feed, "att")["att"]
                    g = sd.calculate_gradients(feed)
                    torch.cuda.synchronize()
                    launched = delta(before)
                    o_ref = ref.output(feed, "att")["att"]
                    g_ref = ref.calculate_gradients(feed)
                    err_o = _max_err(o, o_ref)
                    err_g = {n: _rel_err(g[n], g_ref[n]) for n in g_ref}
                named = dict(zip(ALL_KERNELS, launched))
                total = [a + b for a, b in zip(total, launched)]
                row = {"op": op, "dtype": dtype, "causal": causal,
                       "masked": masked, "max_abs_err_o": err_o,
                       "grad_err": max(err_g.values()),
                       "k1": sum(named[k] for k in K1_NAMES),
                       "k2": sum(named[k] for k in K2_NAMES),
                       "plain_routes": named["attention_plain"],
                       "tol_o": TOL_O[dtype],
                       "tol_grad": TOL_ONNX_GRAD[dtype]}
                rows.append(row)
                del sd, ref
                check(err_o <= TOL_O[dtype], f"(d) {row}: output over "
                      f"{TOL_O[dtype]}")
                check(row["grad_err"] <= TOL_ONNX_GRAD[dtype], f"(d) {row}: "
                      f"gradients over {TOL_ONNX_GRAD[dtype]}")
                check(row["k1"] >= 1 and row["k2"] >= 1
                      and row["plain_routes"] == 0,
                      f"(d) {row}: K1 and K2 not both launched, or a plain "
                      f"route taken")
    torch.cuda.empty_cache()
    emit(onnx_attention={"shape": SD_ATTENTION, "rows": rows})
    return total


def onnx_phase(torch, smi=None):
    """ONNX import on the card: (a) the authored ResNet-50 against the
    port's CPU, (b) against the NHWC ComputationGraph, (c) served at
    batch 32 and fine-tuned, (d) the registry's fused attention ops on
    K1/K2. Returns ((a)-(c)'s launches, (d)'s); (a)-(c) must launch no
    port kernel (their convolutions are cuDNN's)."""
    from deeplearning4j_tpu_torch.tools import onnx_resnet
    reset_all_counts()
    t0 = time.perf_counter()
    net = onnx_net(torch, None)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    check_model = onnx_resnet.to_onnx(net, ONNX_CHECK_BATCH)
    model = onnx_resnet.to_onnx(net, ONNX_BATCH)
    author_s = (time.perf_counter() - t1) / 2
    emit(onnx_model={"bytes": len(model), "author_s": author_s,
                     "net_s": t1 - t0})
    onnx_card_vs_cpu(torch, check_model)
    del check_model
    torch.cuda.empty_cache()
    onnx_vs_graph(torch, net, model)
    del net
    torch.cuda.empty_cache()
    onnx_serve_and_fit(torch, model, smi)
    emit(onnx_peak_memory={"bytes": torch.cuda.max_memory_allocated()})
    del model
    imported = all_counts()
    check(not any(imported), f"the imported ONNX path launched port "
          f"kernels: {dict(zip(ALL_KERNELS, imported))}")
    reset_all_counts()
    attention = onnx_attention_check(torch)
    return imported, attention



# ------------------------------------------------------------ distributed
# Data-parallel training and the compressed gradient exchange (K6): the
# zoo ResNet-50 on TinyImageNetDataSetIterator's seeded synthetic images
# (64²x3, 200 classes; the reference's BASELINE configs[4], SharedTraining-
# Master gradient sharing), batch 32 a worker, f32, through
# SharedTrainingMaster → SparkComputationGraph over a one-rank NCCL group
DIST_SHAPE = (64, 64, 3)
DIST_CLASSES = 200
DIST_BATCH = 32
DIST_STEPS = 12            # (b): compressed steps on the path
DIST_CHECK_STEPS = 3       # (c): the kill switch's dense steps
DIST_SAVE_AT = 6           # (d): steps before gradCompression.npz is saved
DIST_SD_STEPS = 3          # (e): SameDiff Adam steps
DIST_PROFILED = 4          # steps in each timing turn's profiler window
# K6's timed sizes: ResNet-50's bucket at 200 classes (the net's own count)
# and BERT-base's parameters
BERT_BASE_PARAMS = 109_482_240
K6_T = 2e-3                # 4.6 % of N(0, 1e-3) entries fire
K6_EDGE_SIZES = (1, 33, 2 ** 20 + 7)
K6_MALFORMED = ([5, 3, 3, -3, 1, 2], [4, 9, -12, 2, 100000], [50, 1, -2, 3],
                [-3, 1, 2, 3], [2, -2 ** 31, 1])
# (a): the scale terms and Σ residual'² against the plain version, relative
# (f32 sums in another order); everything else exact, NaN for NaN
TOL_K6_SCALAR = 1e-6


def nan_same(torch, a, b):
    """Equal bit for bit where not NaN, NaN where the other is NaN (the
    card's arithmetic gives NaN its own payload)."""
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a[~na].contiguous().view(torch.int32),
        b[~nb].contiguous().view(torch.int32)))


def nan_abs_err(torch, a, b):
    """max |a − b| where both are finite (0 for none)."""
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def scalar_rel(a, b):
    a, b = float(a), float(b)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def k6_values(torch, n, seed, dev, scale=1e-3, specials=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=g, device=dev) * scale
    if specials and n >= 8:
        x[:8] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                              -0.0, 0.0, 2e-3, -2e-3, 1e-3], device=dev)
    return x


def k6_dense_row(torch, K, n, t, dev, seed=SEED, specials=False):
    """K6e then K6d against their plain versions on one bucket."""
    g = k6_values(torch, n, seed, dev, specials=specials)
    r = k6_values(torch, n, seed + 1, dev, scale=1e-4)
    thr = torch.tensor(t, dtype=torch.float32, device=dev)
    s, p = K.encode_dense(g, r, thr)
    s2, p2 = K.encode_dense(g, r, thr)
    s_ref, p_ref = K.encode_dense_reference(g, r, thr)
    wire = s.clone()
    d, nr, q = K.decode_dense(g, r, s, wire, p, 1)
    d2, nr2, q2 = K.decode_dense(g, r, s, wire, p, 1)
    d_ref, nr_ref, q_ref = K.decode_dense_reference(g, r, s, wire, p, 1)
    return {"n": n, "t": t, "specials": specials,
            "fired": int((s != 0).sum()),
            "signs_exact": bool(torch.equal(s, s_ref)),
            "has_exact": float(p[1]) == float(p_ref[1]),
            "scale_rel": scalar_rel(p[0], p_ref[0]),
            "frac_rel": scalar_rel(p[2], p_ref[2]),
            "decoded_exact": nan_same(torch, d, d_ref),
            "residual_exact": nan_same(torch, nr, nr_ref),
            "res_sq_rel": scalar_rel(q, q_ref),
            "repeat_exact": (bool(torch.equal(s, s2))
                             and nan_same(torch, p, p2)
                             and nan_same(torch, d, d2)
                             and nan_same(torch, nr, nr2)
                             and nan_same(torch, q, q2)),
            "encode_err": nan_abs_err(torch, p, p_ref),
            "decode_err": max(nan_abs_err(torch, d, d_ref),
                              nan_abs_err(torch, nr, nr_ref),
                              nan_abs_err(torch, q, q_ref))}


def k6_sparse_row(torch, K, n, t, cap, dev, seed=SEED, specials=False):
    """K6s-enc (both inputs) and K6s-dec (both outputs) against their plain
    versions."""
    x = k6_values(torch, n, seed, dev, specials=specials)
    e, res = K.threshold_encode(x, t, cap)
    e2, res2 = K.threshold_encode(x, t, cap)
    e_ref, res_ref = K.threshold_encode_reference(x, t, cap)
    d = K.threshold_decode(e, t, (n,))
    d2 = K.threshold_decode(e, t, (n,))
    d_ref = K.threshold_decode_reference(e, t, (n,))
    signs = torch.where(x.abs() >= t, torch.sign(x),
                        torch.zeros((), device=dev)).to(torch.int8)
    es = K.sparse_from_dense(signs, cap)
    es_ref = K.sparse_from_dense_reference(signs, cap)
    m = K.dense_from_sparse(es, n)
    m_ref = K.dense_from_sparse_reference(es, n)
    return {"n": n, "t": t, "capacity": cap, "specials": specials,
            "kept": int(e[0]),
            "entries_exact": bool(torch.equal(e, e_ref)),
            "residual_exact": nan_same(torch, res, res_ref),
            "decode_exact": nan_same(torch, d, d_ref),
            "from_dense_exact": bool(torch.equal(es, es_ref)),
            "mask_exact": bool(torch.equal(m, m_ref)),
            "repeat_exact": (bool(torch.equal(e, e2))
                             and nan_same(torch, res, res2)
                             and nan_same(torch, d, d2)),
            "encode_err": nan_abs_err(torch, res, res_ref),
            "decode_err": nan_abs_err(torch, d, d_ref)}


def k6_malformed_row(torch, K, enc, dev):
    e = torch.tensor(enc, dtype=torch.int32, device=dev)
    size = 8
    return {"encoded": enc,
            "decode_exact": nan_same(torch, K.threshold_decode(e, 0.25,
                                                               (size,)),
                                     K.threshold_decode_reference(
                                         e, 0.25, (size,))),
            "mask_exact": bool(torch.equal(
                K.dense_from_sparse(e, size),
                K.dense_from_sparse_reference(e, size)))}


K6_EXACT = ("signs_exact", "has_exact", "decoded_exact", "residual_exact",
            "repeat_exact", "entries_exact", "decode_exact",
            "from_dense_exact", "mask_exact")


def k6_row_ok(row):
    return (all(row.get(k, True) for k in K6_EXACT)
            and all(row.get(k, 0.0) <= TOL_K6_SCALAR
                    for k in ("scale_rel", "frac_rel", "res_sq_rel")))


def k6_timing(torch, K, n, dev):
    """K6e, K6d, K6s-enc and K6s-dec at ``n`` elements: ``device_ms``
    (CUDA-graph replays), ``ms`` (host included), the plain version's ms
    and each kernel's bound (the bytes it must move at 3.35 TB/s); beside
    them NCCL's all-reduce of the int8 wire and of the f32 bucket at world
    size 1, which is a device copy, not a bandwidth."""
    import torch.distributed as dist
    g = k6_values(torch, n, SEED, dev)
    r = k6_values(torch, n, SEED + 1, dev, scale=1e-4)
    thr = torch.tensor(K6_T, dtype=torch.float32, device=dev)
    s = torch.empty(n, dtype=torch.int8, device=dev)
    p = torch.empty(3, dtype=torch.float32, device=dev)
    K.encode_dense(g, r, thr, signs=s, packed=p)
    wire = s.clone()
    dbuf, nbuf = torch.empty_like(g), torch.empty_like(g)
    qbuf = torch.empty((), dtype=torch.float32, device=dev)
    cap = n // 10
    e, _res = K.threshold_encode(g, K6_T, cap)
    fired = int(e[0])

    def enc():
        K.encode_dense(g, r, thr, signs=s, packed=p)

    def dec():
        K.decode_dense(g, r, s, wire, p, 1, decoded=dbuf, new_residual=nbuf,
                       res_sq=qbuf)

    def s_enc():
        return K.threshold_encode(g, K6_T, cap)

    def s_dec():
        return K.threshold_decode(e, K6_T, (n,))

    plain = {"encode": lambda: K.encode_dense_reference(g, r, thr),
             "decode": lambda: K.decode_dense_reference(g, r, s, wire, p, 1),
             "sparse_encode": lambda: K.threshold_encode_reference(
                 g, K6_T, cap),
             "sparse_decode": lambda: K.threshold_decode_reference(
                 e, K6_T, (n,))}
    bytes_ = {"encode": 9 * n, "decode": 18 * n,
              "sparse_encode": 8 * n + 4 * (cap + 1),
              "sparse_decode": 4 * (cap + 1) + 4 * n}
    row = {"n": n, "t": K6_T, "fired": fired, "capacity": cap}
    for name, fn in (("encode", enc), ("decode", dec),
                     ("sparse_encode", s_enc), ("sparse_decode", s_dec)):
        row[f"{name}_device_ms"] = device_ms(fn, torch)
        row[f"{name}_ms"] = time_ms(fn, torch)
        row[f"{name}_plain_ms"] = time_ms(plain[name], torch, iters=5,
                                          repeats=3)
        row[f"{name}_bound_ms"] = 1e3 * bytes_[name] / PEAK_BYTES
        row[f"{name}_bound_by"] = "bytes"
    if dist.is_initialized():
        row["nccl_allreduce_int8_ms"] = time_ms(
            lambda: dist.all_reduce(wire), torch)
        row["nccl_allreduce_f32_ms"] = time_ms(
            lambda: dist.all_reduce(dbuf), torch)
        row["nccl_note"] = ("world size 1: NCCL's all-reduce is a device "
                            "copy, not a bandwidth")
    del g, r, s, wire, dbuf, nbuf, e
    return row


def k6_phase(torch, bucket, dev):
    """(a): K6 against its plain versions at the ResNet-50 bucket, BERT-
    base's size and the edges, and timed at the two sizes."""
    from deeplearning4j_tpu_torch.kernels import threshold as K
    rows = []
    for n in (bucket, BERT_BASE_PARAMS):
        rows.append(k6_dense_row(torch, K, n, K6_T, dev))
        torch.cuda.empty_cache()
    for n in K6_EDGE_SIZES:
        for t in (1e-3, 0.0, 1.0):         # some, every and no hits
            rows.append(k6_dense_row(torch, K, n, t, dev, seed=n))
    for t in (1e-3, 0.0):
        rows.append(k6_dense_row(torch, K, 33, t, dev, specials=True))
    for n, t, cap in ((bucket, K6_T, bucket // 10), (1, 5e-4, 1),
                      (33, 1e-3, 40), (2 ** 20 + 7, K6_T, 2 ** 17),
                      (2 ** 20 + 7, 5e-4, 1000), (33, 1.0, 40),
                      (33, 0.0, 40), (33, 1e-3, 0)):
        rows.append(k6_sparse_row(torch, K, n, t, cap, dev, seed=n))
    for t in (1e-3, 0.0, float("inf")):
        rows.append(k6_sparse_row(torch, K, 33, t, 40, dev, specials=True))
    rows += [k6_malformed_row(torch, K, enc, dev) for enc in K6_MALFORMED]
    failed = [r for r in rows if not k6_row_ok(r)]
    emit(k6_rows=rows, rows={"exact": list(K6_EXACT),
                             "scalar_rel": TOL_K6_SCALAR})
    check(not failed, f"(a) K6 against its plain versions: {failed}")
    timing = [k6_timing(torch, K, n, dev) for n in (bucket,
                                                    BERT_BASE_PARAMS)]
    torch.cuda.empty_cache()
    emit(k6_timing=timing)
    return rows, timing


def dist_net(dev):
    from deeplearning4j_tpu_torch.models.zoo.resnet import ResNet50
    return ResNet50(num_classes=DIST_CLASSES, input_shape=DIST_SHAPE,
                    data_type="float32").init_model(device=dev)


def dist_batches(n, seed=SEED):
    return network_data(n * DIST_BATCH, DIST_SHAPE, DIST_CLASSES, seed)


class _Scores:
    """A listener that keeps every step's loss."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration, epoch, score):
        self.scores.append(float(score))

    def on_epoch_start(self, net, epoch):
        pass

    def on_epoch_end(self, net, epoch):
        pass


def dist_path(torch, dev):
    """(b): SharedTrainingMaster (adaptive threshold) over
    SparkComputationGraph and the zoo ResNet-50 on TinyImageNet, one-rank
    NCCL group, DIST_STEPS steps; every exchange held against the plain
    one on the same captured g and residual. Returns (the path's launches,
    its report)."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data.vision import (
        TinyImageNetDataSetIterator)
    from deeplearning4j_tpu_torch.kernels import threshold as K
    from deeplearning4j_tpu_torch.observability import global_registry
    from deeplearning4j_tpu_torch.parallel import compression as comp
    from deeplearning4j_tpu_torch.parallel.master import (
        SharedTrainingMaster, SparkComputationGraph)
    net = dist_net(dev)
    scores = _Scores()
    net.setListeners(scores)
    tm = (SharedTrainingMaster.Builder().batch_size_per_worker(DIST_BATCH)
          .threshold_algorithm("adaptive").build())
    spark = SparkComputationGraph(None, net, tm)
    data = TinyImageNetDataSetIterator(DIST_BATCH,
                                       num_examples=DIST_BATCH * DIST_STEPS,
                                       num_classes=DIST_CLASSES)
    steps = []
    real = comp.exchange_buckets

    def spy(gs, residuals, thresholds, group, n, decoded=None,
            new_residuals=None):
        g0 = [g.clone() for g in gs]
        r0 = [r.clone() for r in residuals]
        t0 = [t.clone() for t in thresholds]
        out = real(gs, residuals, thresholds, group, n, decoded,
                   new_residuals)
        for g, r, t, e in zip(g0, r0, t0, out):
            s_ref, p_ref = K.encode_dense_reference(g, r, t)
            d_ref, nr_ref, q_ref = K.decode_dense_reference(
                g, r, e.signs, e.wire, e.packed, n)
            steps.append({
                "threshold": float(t), "frac": float(e.frac),
                "fired": int((e.signs != 0).sum()),
                "signs_exact": bool(torch.equal(e.signs, s_ref)),
                "scale_rel": scalar_rel(e.packed[0], p_ref[0]),
                "frac_rel": scalar_rel(e.packed[2], p_ref[2]),
                "decoded_exact": nan_same(torch, e.decoded, d_ref),
                "residual_exact": nan_same(torch, e.residual, nr_ref),
                "res_sq_rel": scalar_rel(e.res_sq, q_ref)})
        return out

    reset_all_counts()
    comp.allreduce_calls = 0
    comp.exchange_buckets = spy
    try:
        t0 = time.perf_counter()
        spark.fit(data)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        comp.exchange_buckets = real
    launches = all_counts()
    calls = comp.allreduce_calls
    trainer = spark._trainer
    layout = trainer._comp_layout
    ratio = global_registry().get("dl4j_grad_compression_ratio")
    report = {"steps": len(scores.scores), "seconds": seconds,
              "losses": scores.scores,
              "thresholds": [s["threshold"] for s in steps],
              "encoded_fraction": [s["frac"] for s in steps],
              "fired": [s["fired"] for s in steps],
              "bucket_elements": layout.total_elements(),
              "payload_bytes": comp.payload_bytes(layout, 1),
              "dense_bytes": comp.dense_bytes(layout),
              "dl4j_grad_compression_ratio": ratio.value,
              "allreduce_calls": calls,
              "backend": dist.get_backend(),
              "rows_failed": [i for i, s in enumerate(steps)
                              if not k6_row_ok(s)],
              "launches": dict(zip(ALL_KERNELS, launches))}
    emit(distributed_path=report)
    check(dist.get_backend() == "nccl" or not TRACE_ON_DEVICE,
          f"(b) the process group runs {dist.get_backend()}, not NCCL")
    check(len(steps) == DIST_STEPS and not report["rows_failed"],
          f"(b) the exchanges against the plain one on the same g and "
          f"residual: {len(steps)} steps, failed {report['rows_failed']}: "
          f"{[steps[i] for i in report['rows_failed']]}")
    check(len(scores.scores) == DIST_STEPS
          and all(math.isfinite(x) for x in scores.scores),
          f"(b) losses {scores.scores}")
    check(calls == 3 * DIST_STEPS,
          f"(b) {calls} all-reduces over {DIST_STEPS} steps (want 3 a "
          f"step: the scalars, the signs, the loss and states)")
    check(report["payload_bytes"] < report["dense_bytes"],
          f"(b) payload {report['payload_bytes']} not under dense "
          f"{report['dense_bytes']}")
    del spark, trainer, net
    return launches, report


def _state_max_abs(torch, a, b):
    """max |a − b| over params, layer states and updater leaves."""
    from deeplearning4j_tpu_torch.optim import transforms as T
    worst = {}
    for what, ta, tb in (("params", a.param_tree(), b.param_tree()),
                         ("states", a.state_tree(), b.state_tree())):
        worst[what] = max((float((ta[k][p] - tb[k][p]).abs().max())
                           for k in ta for p in ta[k]), default=0.0)
    la = [t for t in T.state_leaves(a.updater_state())
          if isinstance(t, torch.Tensor)]
    lb = [t for t in T.state_leaves(b.updater_state())
          if isinstance(t, torch.Tensor)]
    worst["updater"] = max((float((x - y).abs().max())
                            for x, y in zip(la, lb)), default=0.0)
    return worst


@contextlib.contextmanager
def deterministic_cudnn(torch):
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def dist_kill_switch(torch, dev):
    """(c): DL4J_TPU_GRAD_COMPRESS=0 — the dense ShardedTrainer at world
    size 1 against the net's own fit, DIST_CHECK_STEPS steps on the same
    weights and batches; within what two calls of the net's own fit differ
    by (deterministic cuDNN algorithms)."""
    from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer
    x, y = dist_batches(DIST_CHECK_STEPS, seed=SEED + 3)
    prev = os.environ.get("DL4J_TPU_GRAD_COMPRESS")
    os.environ["DL4J_TPU_GRAD_COMPRESS"] = "0"
    try:
        with deterministic_cudnn(torch):
            a, b, c = dist_net(dev), dist_net(dev), dist_net(dev)
            tr = ShardedTrainer(a, grad_compression="adaptive")
            for i in range(DIST_CHECK_STEPS):
                sl = slice(i * DIST_BATCH, (i + 1) * DIST_BATCH)
                xd = torch.as_tensor(x[sl], device=dev)
                yd = torch.as_tensor(y[sl], device=dev)
                tr.fit(xd, yd)
                b.fit(xd, yd)
                c.fit(xd, yd)
            compressed = tr._compression is not None
            got = _state_max_abs(torch, a, b)
            floor = _state_max_abs(torch, b, c)
    finally:
        if prev is None:
            os.environ.pop("DL4J_TPU_GRAD_COMPRESS", None)
        else:
            os.environ["DL4J_TPU_GRAD_COMPRESS"] = prev
    report = {"dense_vs_own_fit": got, "own_fit_twice": floor,
              "compressed": compressed, "steps": DIST_CHECK_STEPS}
    emit(distributed_kill_switch=report)
    check(not compressed, "(c) the kill switch left compression on")
    check(all(got[k] <= floor[k] for k in got),
          f"(c) the dense trainer against the net's own fit {got}, two "
          f"fits {floor}")
    return report


def _comp_snapshot(torch, net):
    st = net._grad_compression_state
    return {"params": {k: {p: t.clone() for p, t in layer.items()}
                       for k, layer in net.param_tree().items()},
            "residual": [r.clone() for r in st["residual"]],
            "threshold": [t.clone() for t in st["threshold"]]}


def _snap_diff(a, b):
    return {"params": max(float((a["params"][k][p] - b["params"][k][p])
                                .abs().max())
                          for k in a["params"] for p in a["params"][k]),
            "residual": max(float((x - y).abs().max())
                            for x, y in zip(a["residual"], b["residual"])),
            "threshold": max(abs(float(x) - float(y))
                             for x, y in zip(a["threshold"],
                                             b["threshold"]))}


def dist_checkpoint(torch, dev):
    """(d): gradCompression.npz — DIST_SAVE_AT compressed steps, save,
    then one step in memory against one step of each of two restored
    copies."""
    import tempfile
    from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer
    from deeplearning4j_tpu_torch.utils.serialization import ModelSerializer
    x, y = dist_batches(DIST_SAVE_AT + 1, seed=SEED + 4)

    def batch(i):
        sl = slice(i * DIST_BATCH, (i + 1) * DIST_BATCH)
        return (torch.as_tensor(x[sl], device=dev),
                torch.as_tensor(y[sl], device=dev))

    with deterministic_cudnn(torch), tempfile.TemporaryDirectory() as tmp:
        net = dist_net(dev)
        tr = ShardedTrainer(net, grad_compression="adaptive")
        for i in range(DIST_SAVE_AT):
            tr.fit(*batch(i))
        path = os.path.join(tmp, "resnet50_compressed.zip")
        net.save(path)
        with zipfile.ZipFile(path) as zf:
            members = zf.namelist()
        tr.fit(*batch(DIST_SAVE_AT))
        memory = _comp_snapshot(torch, net)
        del tr, net
        copies = []
        for _ in range(2):
            back = ModelSerializer.restore(path)
            ShardedTrainer(back, grad_compression="adaptive").fit(
                *batch(DIST_SAVE_AT))
            copies.append(_comp_snapshot(torch, back))
            del back
    got = _snap_diff(memory, copies[0])
    floor = _snap_diff(copies[0], copies[1])
    report = {"restored_vs_memory": got, "two_copies": floor,
              "zip_has_grad_compression": "gradCompression.npz" in members}
    emit(distributed_checkpoint=report)
    check(report["zip_has_grad_compression"],
          "(d) the zip holds no gradCompression.npz")
    check(all(got[k] <= floor[k] for k in got),
          f"(d) restore-resume against the in-memory continuation {got}, "
          f"two restored copies {floor}")
    return report


def dist_samediff(torch, dev):
    """(e): set_mesh at world size 1 on the filled BERT-base skeleton at
    (2, 128), DIST_SD_STEPS Adam steps against the same graph without a
    mesh; losses within samediff_phase (a)'s row."""
    from deeplearning4j_tpu_torch.modelimport import tf_skeleton
    from deeplearning4j_tpu_torch.modelimport.tfimport import TFGraphMapper
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec
    gd = tf_skeleton.fill_skeleton(
        tf_skeleton.load_skeleton(SD_CHECK_SKELETON), SEED)
    data = sd_batches(DIST_SD_STEPS, *SD_CHECK_SHAPE, seed=SEED + 5)
    losses = {}
    for mesh in (True, False):
        sd = TFGraphMapper.import_graph(gd, device=dev)
        sd_promote(sd)
        sd_attach_head(sd, gd)
        if mesh:
            sd.set_mesh(MeshSpec.data_parallel().build(device=dev))
        losses["mesh" if mesh else "alone"] = list(sd.fit(data))
        del sd
        torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(losses["mesh"], losses["alone"]))
    report = {"losses": losses, "max_loss_diff": err,
              "row": TOL_SD["loss"]}
    emit(distributed_samediff=report)
    check(err <= TOL_SD["loss"] and all(math.isfinite(v) for v in
                                        losses["mesh"]),
          f"(e) SameDiff under set_mesh against no mesh: {report}")
    return report


def dist_timing(torch, dev, smi):
    """The net's own fit, the dense ShardedTrainer and the compressed one
    on one fixed batch, in turns (own, dense, compressed, compressed,
    dense, own): host ms a step and images/s; then a profiler window of
    DIST_PROFILED steps of each: device ms a step, busy share, kernels a
    step, and K6's share of the compressed step's device time."""
    from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer
    x, y = dist_batches(1, seed=SEED + 6)
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    own, dense, compressed = dist_net(dev), dist_net(dev), dist_net(dev)
    tr_dense = ShardedTrainer(dense)
    tr_comp = ShardedTrainer(compressed, grad_compression="adaptive")
    runs = {"own_fit": lambda: own.fit(xd, yd),
            "dense_trainer": lambda: tr_dense.fit(xd, yd),
            "compressed_trainer": lambda: tr_comp.fit(xd, yd)}
    timed = {k: [] for k in runs}
    for who in ("own_fit", "dense_trainer", "compressed_trainer",
                "compressed_trainer", "dense_trainer", "own_fit"):
        ms, _all = step_timing(torch, runs[who])
        timed[who].append(ms)
    rows = []
    for who, fn in runs.items():
        p = profile_window(
            torch, f"distributed_{who}",
            lambda f=fn: [f() for _ in range(DIST_PROFILED)],
            f"distributed_{who}_trace.json", top=8)
        ms = statistics.median(timed[who])
        row = {"path": who, "gpu": smi, "host_ms_per_step": ms,
               "turns_ms": timed[who],
               "images_per_s": DIST_BATCH / (ms / 1e3),
               "device_ms_per_step": (p["device_busy_us"] / 1e3
                                      / DIST_PROFILED
                                      if "device_busy_us" in p else None),
               "busy_share": p.get("busy_share"),
               "kernels_per_step": (p["kernels"] / DIST_PROFILED
                                    if "kernels" in p else None),
               "top_ops": p.get("top_ops")}
        k6 = p.get("k6_kernels")
        if who == "compressed_trainer" and k6 is not None \
                and p.get("device_busy_us"):
            k6_us = sum(v["us"] for v in k6)
            row["k6_kernels"] = k6
            row["k6_share_of_device"] = k6_us / p["device_busy_us"]
        rows.append(row)
    emit(distributed_timing=rows)
    del own, dense, compressed, tr_dense, tr_comp
    torch.cuda.empty_cache()
    return rows


def distributed_phase(torch, smi=None):
    """Data-parallel training on the card: the one-rank NCCL group, (a)
    K6 against its plain versions and timed, (b) the path (its launches:
    the phase's return), (c) the kill switch, (d) gradCompression.npz,
    (e) SameDiff under set_mesh, then the timing turns. Returns (the
    path's launches, (a)'s rows, (a)'s timing, the timing rows)."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.parallel.mesh import ensure_group
    dev = resolve_device(None)
    ensure_group(dev)
    try:
        return _distributed_phase(torch, dev, smi)
    finally:
        # the one-rank group this phase started
        dist.destroy_process_group()


def _distributed_phase(torch, dev, smi):
    bucket = dist_net(dev).numParams()
    torch.cuda.empty_cache()
    reset_all_counts()
    rows, timing = k6_phase(torch, bucket, dev)
    checked = all_counts()
    check(not TRACE_ON_DEVICE or all(
        checked[ALL_KERNELS.index(k)] > 0
        for k in ("k6_encode", "k6_decode", "k6s_encode", "k6s_decode")),
        f"(a) a K6 kernel did not launch: {dict(zip(ALL_KERNELS, checked))}")
    torch.cuda.empty_cache()
    launches, path = dist_path(torch, dev)
    torch.cuda.empty_cache()
    dist_kill_switch(torch, dev)
    torch.cuda.empty_cache()
    dist_checkpoint(torch, dev)
    torch.cuda.empty_cache()
    dist_samediff(torch, dev)
    torch.cuda.empty_cache()
    timing_rows = dist_timing(torch, dev, smi)
    return launches, {"rows": rows, "timing": timing, "path": path,
                      "checked": dict(zip(ALL_KERNELS, checked)),
                      "turns": timing_rows}


def check_distributed_launches(launches):
    """The path launched K6e and K6d once a compressed step and nothing
    else of the port."""
    check(launches == launch_counts(k6_encode=DIST_STEPS,
                                    k6_decode=DIST_STEPS),
          f"the distributed path launched "
          f"{dict(zip(ALL_KERNELS, launches))}")


K6_REPLACES = {"k6_encode": "deeplearning4j_tpu/parallel/compression.py:259",
               "k6_decode": "deeplearning4j_tpu/parallel/compression.py:266",
               "k6s_encode": "deeplearning4j_tpu/kernels/threshold.py:36",
               "k6s_decode": "deeplearning4j_tpu/kernels/threshold.py:61"}
K6_TIMED = {"k6_encode": "encode", "k6_decode": "decode",
            "k6s_encode": "sparse_encode", "k6s_decode": "sparse_decode"}


def k6_kernel_entries(launches, dist):
    """The kernels-line entries of K6e, K6d, K6s-enc and K6s-dec, their
    numbers at ResNet-50's bucket (BERT-base's beside them);
    ``launches`` maps each kernel to its launches by path."""
    rows, (main, bert) = dist["rows"], dist["timing"]
    out = []
    for name, part in K6_TIMED.items():
        sparse = name.startswith("k6s")
        errs = [r.get("decode_err" if "decode" in part else "encode_err",
                      0.0) for r in rows
                if ("capacity" in r) == sparse and "n" in r]
        on_path = not sparse
        out.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/kernels/csrc/threshold.cu",
            "replaces": K6_REPLACES[name],
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "on_main_path": on_path,
            "checked_launches": dist["checked"][name],
            "max_abs_err": max(errs, default=0.0),
            "ms": main[f"{part}_ms"], "device_ms": main[f"{part}_device_ms"],
            "plain_ms": main[f"{part}_plain_ms"],
            "bound_ms": main[f"{part}_bound_ms"],
            "bound_by": main[f"{part}_bound_by"],
            "library": "none (no one call)", "library_ms": None,
            "bert_base": {k: bert[f"{part}_{k}"] for k in
                          ("ms", "device_ms", "plain_ms", "bound_ms")},
            "at": {"n": main["n"], "t": main["t"],
                   "capacity": main["capacity"] if sparse else None}})
    return out


# ------------------------------------------------ several cards (--ranks N)
RANKS_STEPS = 3            # dense steps, held across ranks and to one card
RANKS_COMP_STEPS = 12      # compressed steps
RANKS_TIMEOUT_S = 600.0
#: the ranks' first dense step may sit this many times the largest of the
#: one-card floors from rank 0's params: the same fit twice (cuDNN's own
#: spread), and the fits of the batch with its rows reversed and in
#: RANKS_PERMUTATIONS seeded orders (the same function, its sums in another
#: order; at init the net amplifies them, and heavy-tailed)
RANKS_FLOOR_FACTOR = 4.0
RANKS_PERMUTATIONS = 5


def ranks_phase(n):
    """``--ranks N``: N processes of this script, one card each, joined by
    NCCL (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT`` on 127.0.0.1); each runs :func:`rank_worker`. Rank 0's
    lines are printed; any rank's failure (or the time limit) fails."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        f = open(OUT_DIR / f"rank{r}.log", "w")
        files.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker"],
            env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.time() + RANKS_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    for line in (OUT_DIR / "rank0.log").read_text().splitlines():
        if line.startswith("{"):
            print(line, flush=True)
    rcs = [p.returncode for p in procs]
    bad = [r for r, rc in enumerate(rcs) if rc != 0]
    check(not bad, f"ranks exited {rcs}: " + " | ".join(
        (OUT_DIR / f"rank{r}.log").read_text()[-2000:] for r in bad))


def _rank_spread(torch, t):
    """max |t_r − t_0| over the ranks (every rank gets it)."""
    import torch.distributed as dist
    rows = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, t.contiguous())
    return max(float((r - rows[0]).abs().max()) for r in rows)


def _allreduce_ms(torch, t, calls=20, repeats=7):
    """Median CUDA-event ms of one all-reduce of ``t`` over the group."""
    import torch.distributed as dist
    dist.all_reduce(t)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            dist.all_reduce(t)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def rank_worker(torch, smi):
    """One rank of ``--ranks N``: (i) the dense trainer, RANKS_STEPS steps
    of DIST_BATCH a rank: the ranks' params identical, and rank 0's beside
    the net's own fit of the global batch on one card, held after the
    first step to RANKS_FLOOR_FACTOR times the largest one-card floor
    (that fit twice; the batch's rows reversed or permuted); (ii) the
    compressed
    trainer (adaptive), RANKS_COMP_STEPS steps: params and thresholds
    identical on every rank, each rank its own residual; (iii) NCCL's
    all-reduce of ResNet-50's bucket as the int8 wire and as f32, and the
    dense against the compressed step in turns."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.master import DistributedConfig
    from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer
    dev = DistributedConfig().initialize()
    n, rank = dist.get_world_size(), dist.get_rank()
    gb = DIST_BATCH * n
    try:
        x, y = dist_batches(RANKS_STEPS * n, seed=SEED + 7)
        net = dist_net(dev)
        tr = ShardedTrainer(net)
        # rank 0: the same global batch through the net's own fit on one
        # card (the reference's global program), that fit again, and the
        # fit of the batch with its rows reversed
        ones = ([dist_net(dev) for _ in range(3)] if rank == 0 else [])
        p0 = ones[0].params().clone() if ones else None
        losses, one_losses, vs_one = [], [], []
        twice, reversed_rows, permuted, first_step = [], [], [], None
        for i in range(RANKS_STEPS):
            xb, yb = x[i * gb:(i + 1) * gb], y[i * gb:(i + 1) * gb]
            tr.fit(xb, yb)
            losses.append(tr.score())
            if ones:
                one, again, rev = ones
                one.fit(xb, yb)
                again.fit(xb, yb)
                rev.fit(xb[::-1].copy(), yb[::-1].copy())
                one_losses.append(one.score())
                p1 = one.params()
                vs_one.append(float((p1 - net.params()).abs().max()))
                twice.append(float((p1 - again.params()).abs().max()))
                reversed_rows.append(float((p1 - rev.params()).abs().max()))
            if ones and i == 0:
                first_step = float((p1 - p0).abs().max())
                order = np.random.default_rng(SEED + 9)
                for _ in range(RANKS_PERMUTATIONS):
                    perm = order.permutation(gb)
                    other = dist_net(dev)
                    other.fit(xb[perm], yb[perm])
                    permuted.append(float((p1 - other.params())
                                          .abs().max()))
                    del other
        dense = {"losses": losses,
                 "rank_spread": _rank_spread(torch, net.params()),
                 "backend": dist.get_backend(),
                 "one_card_losses": one_losses,
                 "params_vs_one_card_by_step": vs_one,
                 "one_card_twice_by_step": twice,
                 "one_card_rows_reversed_by_step": reversed_rows,
                 "one_card_rows_permuted_step1": permuted,
                 "one_card_first_step_max_abs": first_step}
        del ones
        x2, y2 = dist_batches(RANKS_COMP_STEPS * n, seed=SEED + 8)
        net2 = dist_net(dev)
        tr2 = ShardedTrainer(net2, grad_compression="adaptive")
        losses2 = []
        for i in range(RANKS_COMP_STEPS):
            tr2.fit(x2[i * gb:(i + 1) * gb], y2[i * gb:(i + 1) * gb])
            losses2.append(tr2.score())
        state = net2._grad_compression_state
        thr = torch.stack([t.reshape(()) for t in state["threshold"]])
        comp = {"losses": losses2,
                "rank_spread": _rank_spread(torch, net2.params()),
                "threshold_spread": _rank_spread(torch, thr),
                "thresholds": [float(t) for t in thr],
                "residual_spread": _rank_spread(torch, state["residual"][0]),
                "launches": {k: v for k, v in zip(ALL_KERNELS, all_counts())
                             if v}}
        size = net2.numParams()
        wire = torch.ones(size, dtype=torch.int8, device=dev)
        bucket = torch.ones(size, dtype=torch.float32, device=dev)
        wire_ms = _allreduce_ms(torch, wire)
        f32_ms = _allreduce_ms(torch, bucket)
        bus = 2 * (n - 1) / n
        xd = torch.as_tensor(x[:gb], device=dev)
        yd = torch.as_tensor(y[:gb], device=dev)
        timed = {"dense": [], "compressed": []}
        for who in ("dense", "compressed", "compressed", "dense"):
            step = ((lambda: tr.fit(xd, yd)) if who == "dense"
                    else (lambda: tr2.fit(xd, yd)))
            ms, _all = step_timing(torch, step)
            timed[who].append(ms)
        timing = {"gpu": smi, "elements": size,
                  "allreduce_int8_ms": wire_ms, "allreduce_f32_ms": f32_ms,
                  "int8_bus_gb_s": bus * size / (wire_ms * 1e-3) / 1e9,
                  "f32_bus_gb_s": bus * 4 * size / (f32_ms * 1e-3) / 1e9}
        for who, ms in timed.items():
            med = statistics.median(ms)
            timing[who] = {"host_ms_per_step": med, "turns_ms": ms,
                           "images_per_s": gb / (med / 1e3)}
        report = {"world": n, "dense": dense, "compressed": comp,
                  "timing": timing}
        if rank == 0:
            emit(ranks=report)
        check(dense["backend"] == "nccl", f"the group runs {dense['backend']}")
        check(dense["rank_spread"] == 0.0 and comp["rank_spread"] == 0.0
              and comp["threshold_spread"] == 0.0,
              f"the ranks' params or thresholds differ: {report}")
        check(all(math.isfinite(v) for v in losses + losses2),
              f"losses {losses} {losses2}")
        if rank == 0:
            floor = max([twice[0], reversed_rows[0]] + permuted)
            check(vs_one[0] <= RANKS_FLOOR_FACTOR * floor,
                  f"(i) the ranks' first step sits {vs_one[0]} from one "
                  f"card's, above {RANKS_FLOOR_FACTOR} x its floor {floor}")
        check(comp["launches"].get("k6_encode") == RANKS_COMP_STEPS
              and comp["launches"].get("k6_decode") == RANKS_COMP_STEPS,
              f"K6 launches {comp['launches']}")
    finally:
        dist.destroy_process_group()


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-bwd", metavar="OTHER", type=Path,
                        help="time K1 and K2 here and in the checkout at "
                        "OTHER in turns, and nothing else")
    parser.add_argument("--compare-f32", metavar="OTHER", type=Path,
                        help="the same for the simple forward and the "
                        "mma.sync / FMA backward at F32_COMPARE_CASES")
    parser.add_argument("--compare-decode", metavar="OTHER", type=Path,
                        help="profile and time decode steps over bf16 and "
                        "int8 pages here and in the checkout at OTHER in "
                        "turns, and nothing else")
    parser.add_argument("--precision-f32", action="store_true",
                        help="measure the f32 kernels and the plain "
                        "versions against f64, and nothing else")
    parser.add_argument("--network", action="store_true",
                        help="run only the DL4J network phase (ResNet-50, "
                        "LeNet and the zoo), which builds no kernel")
    parser.add_argument("--detection", action="store_true",
                        help="run only the detection phase (YOLO2, the "
                        "VAE's pretraining, DropConnect, deconvolution), "
                        "which builds no kernel")
    parser.add_argument("--readings", nargs="*", metavar="MODEL",
                        help="take the CPU readings of the new zoo models' "
                        "(these MODELs', else every one's) and the small "
                        "paths' rows (f32 against f64, bf16 against f32), "
                        "and nothing else; needs no card")
    parser.add_argument("--transfer", action="store_true",
                        help="run only the transfer phase (a pretrained "
                        "ResNet-50's zip round trip, fine-tuning under early "
                        "stopping and checkpoints, resume, evaluation; "
                        "LeNet's transfer, solvers and DL4J zip), which "
                        "builds no kernel")
    parser.add_argument("--scoring", action="store_true",
                        help="run only the scoring phase (a ResilientTrainer "
                        "healing drill, ParallelInference traffic, a canary "
                        "over /v1/classify, a profile capture), which "
                        "builds no kernel")
    parser.add_argument("--recurrent", action="store_true",
                        help="run only the recurrent phase (the char-RNNs "
                        "R1-R4, K11 and K11L), which builds only "
                        "rnn_cell.cu")
    parser.add_argument("--compare-k11l", metavar="OTHER", type=Path,
                        nargs="+", help="time K11Lf and K11Lb here and in "
                        "the checkouts at OTHER in turns, and nothing else")
    parser.add_argument("--attention", action="store_true",
                        help="run only the attention phase (masked K1/K2, "
                        "A1 and A2) after building the kernels")
    parser.add_argument("--samediff", action="store_true",
                        help="run only the SameDiff phase (the TF-imported "
                        "BERT-base against the CPU and fine-tuned at (32, "
                        "128), the attention op through SameDiff on K1/K2) "
                        "after building the flash kernels")
    parser.add_argument("--onnx", action="store_true",
                        help="run only the ONNX phase (the authored "
                        "ResNet-50 imported against the CPU and the NHWC "
                        "graph, served and fine-tuned at batch 32, the "
                        "registry's fused attention ops on K1/K2) after "
                        "building the flash kernels")
    parser.add_argument("--distributed", action="store_true",
                        help="run only the distributed phase (K6 against "
                        "its plain versions, ResNet-50 through "
                        "SharedTrainingMaster over a one-rank NCCL group, "
                        "the kill switch, gradCompression.npz, SameDiff "
                        "under set_mesh, the timing turns) after building "
                        "threshold.cu and the flash sources")
    parser.add_argument("--ranks", type=int, metavar="N",
                        help="train data-parallel over N cards, one "
                        "process each over NCCL (ResNet-50 on 64² at "
                        "batch 32 a rank: the dense and the compressed "
                        "trainer, NCCL's all-reduce timed), and nothing "
                        "else")
    parser.add_argument("--rank-worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--precision-ce-f32", action="store_true",
                        help="measure the f32 K3 kernels and their plain "
                        "versions against f64 at the training shape, and "
                        "nothing else")
    args = parser.parse_args()
    import torch
    if args.readings is not None:
        name = "zoo_readings.json"
        if args.readings == ["transfer"]:
            readings, name = transfer_readings(), "transfer_readings.json"
        elif args.readings == ["scoring"]:
            readings, name = scoring_readings(), "scoring_readings.json"
        else:
            readings = (zoo_readings(tuple(args.readings)) if args.readings
                        else zoo_readings())
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / name).write_text(
            json.dumps(readings, default=str, indent=1))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port runs on the "
              "card", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch.kernels import _build
        from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda)
    if args.compare_bwd is not None:
        emit(compare_turns=compare_turns(args.compare_bwd.resolve()))
        return 0
    if args.compare_f32 is not None:
        emit(compare_turns=compare_turns(args.compare_f32.resolve(),
                                         fwd=F32_COMPARE_CASES,
                                         bwd=F32_COMPARE_CASES))
        return 0
    if args.compare_k11l is not None:
        emit(compare_k11l=compare_k11l([o.resolve()
                                        for o in args.compare_k11l]))
        return 0
    if args.compare_decode is not None:
        emit(compare_decode=compare_decode(args.compare_decode.resolve()))
        return 0
    if args.precision_f32:
        precision_f32(torch, fa)
        return 0
    if args.precision_ce_f32:
        precision_ce_f32(torch)
        return 0
    if args.network:
        network = network_phase(torch)
        check(not any(network), f"the network paths launched port kernels: "
              f"{dict(zip(ALL_KERNELS, network))}")
        return 0
    if args.detection:
        detection, _rows = detection_phase(torch, smi)
        check(not any(detection), f"the detection path launched port "
              f"kernels: {dict(zip(ALL_KERNELS, detection))}")
        return 0
    if args.transfer:
        t0 = time.perf_counter()
        transfer = transfer_phase(torch, smi)
        check(not any(transfer), f"the transfer path launched port "
              f"kernels: {dict(zip(ALL_KERNELS, transfer))}")
        emit(phase_seconds={"transfer_phase": time.perf_counter() - t0})
        return 0
    if args.scoring:
        t0 = time.perf_counter()
        scoring = scoring_phase(torch, smi)
        check_scoring_launches(scoring)
        emit(phase_seconds={"scoring_phase": time.perf_counter() - t0})
        return 0
    if args.samediff:
        t0 = time.perf_counter()
        _build.load("flash_attention_fwd")
        _build.load("flash_attention_bwd")
        emit(build={"seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        imported, attention = samediff_phase(torch, smi)
        emit(samediff_launches={
            "samediff_import": dict(zip(ALL_KERNELS, imported)),
            "samediff_attention": dict(zip(ALL_KERNELS, attention))},
            phase_seconds={"samediff_phase": time.perf_counter() - t0})
        return 0
    if args.onnx:
        t0 = time.perf_counter()
        # the four flash libraries, one nvcc each, all started together
        started = {n: _build._start(n) for n in (
            "flash_attention_fwd", "flash_attention_bwd",
            "flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma")}
        for n, st in started.items():
            if st is not None:
                _build._finish(n, st)
        emit(build={"seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        imported, attention = onnx_phase(torch, smi)
        emit(onnx_launches={
            "onnx_import": dict(zip(ALL_KERNELS, imported)),
            "onnx_attention": dict(zip(ALL_KERNELS, attention))},
            phase_seconds={"onnx_phase": time.perf_counter() - t0})
        return 0
    if args.rank_worker:
        rank_worker(torch, smi)
        return 0
    if args.ranks is not None:
        check(torch.cuda.device_count() >= args.ranks,
              f"--ranks {args.ranks} on {torch.cuda.device_count()} cards")
        _build.load("threshold")        # built once, before the ranks start
        t0 = time.perf_counter()
        ranks_phase(args.ranks)
        emit(phase_seconds={"ranks_phase": time.perf_counter() - t0})
        return 0
    if args.distributed:
        t0 = time.perf_counter()
        started = {n: _build._start(n) for n in (
            "threshold", "flash_attention_fwd", "flash_attention_bwd")}
        for n, st in started.items():
            if st is not None:
                _build._finish(n, st)
        emit(build={"seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        distributed, dist = distributed_phase(torch, smi)
        check_distributed_launches(distributed)
        emit(kernels=k6_kernel_entries(
            {k: {"distributed": distributed[i]}
             for i, k in enumerate(ALL_KERNELS)}, dist),
            phase_seconds={"distributed_phase": time.perf_counter() - t0})
        return 0
    if args.recurrent:
        t0 = time.perf_counter()
        _build.load("rnn_cell")
        emit(build={"seconds": time.perf_counter() - t0})
        check_rnn_cell_build(_build)
        recurrent, wide, k11_rows, k11l_rows = recurrent_phase(torch)
        check_recurrent_launches(recurrent, wide)
        emit(kernels=recurrent_kernel_entries(
            {k: {"recurrent": recurrent[i], "wide_layer": wide[i]}
             for i, k in enumerate(ALL_KERNELS)}, k11_rows, k11l_rows))
        return 0

    t_script = time.perf_counter()
    t0 = time.perf_counter()
    compiled = _build.build_all()
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln
             or "C75" in ln]
    emit(build={"seconds": time.perf_counter() - t0, "compiled": compiled,
                "ptxas": ptxas})
    for name in ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma",
                 "chunked_ce_wgmma", "chunked_ce_tf32"):
        warned = serialized_wgmma(_build.build_logs.get(name, ""))
        check(not warned, f"{name}: ptxas serialized wgmma: {warned}")
    log = _build.build_logs.get("flash_attention_fwd_wgmma")
    if log is not None:     # compiled in this run, not an earlier library
        report = wgmma_ptxas(log)
        emit(wgmma_ptxas=report)
        check(set(report) == set(WGMMA_INSTANTIATIONS) and all(
            r.get("registers") == WGMMA_ENTRY_REGISTERS
            and r.get("spill_bytes") == 0 for r in report.values()),
            f"wgmma kernel: want {WGMMA_ENTRY_REGISTERS} registers and no "
            f"spills at d 64 and 128, unmasked and masked, ptxas gave "
            f"{report}")
    log = _build.build_logs.get("flash_attention_bwd_wgmma")
    if log is not None:
        report = bwd_wgmma_ptxas(log)
        emit(bwd_wgmma_ptxas=report)
        check(set(report) == set(BWD_WGMMA_INSTANTIATIONS)
              and all("registers" in r and r.get("spill_bytes") == 0
                      for r in report.values()),
              f"wgmma backward: want no spills in its eight kernels, ptxas "
              f"gave {report}")
    log = _build.build_logs.get("chunked_ce_wgmma")
    if log is not None:
        report = ce_wgmma_ptxas(log)
        emit(ce_wgmma_ptxas=report)
        check(sorted(report) == ["dlogits", "fwd"]
              and all("registers" in r and r.get("spill_bytes") == 0
                      for r in report.values()),
              f"wgmma K3: want no spills in its two kernels, ptxas gave "
              f"{report}")
    log = _build.build_logs.get("chunked_ce_tf32")
    if log is not None:
        report = ce_tf32_ptxas(log)
        emit(ce_tf32_ptxas=report)
        check(spill_free(report, CE_TF32_INSTANTIATIONS),
              f"tf32 K3: want no spills in its "
              f"{len(CE_TF32_INSTANTIATIONS)} kernels, ptxas gave {report}")
    for name, parse, want in (("flash_attention_fwd", simple_ptxas,
                               SIMPLE_INSTANTIATIONS
                               + SIMPLE_MASKED_INSTANTIATIONS),
                              ("flash_attention_bwd", bwd_ptxas,
                               BWD_INSTANTIATIONS
                               + BWD_MASKED_INSTANTIATIONS)):
        log = _build.build_logs.get(name)
        if log is not None:
            report = parse(log)
            emit(**{f"{name}_ptxas": report})
            check(spill_free(report, want),
                  f"{name}: want no spills in its {len(want)} kernels, "
                  f"ptxas gave {report}")
    check_rnn_cell_build(_build)
    log = _build.build_logs.get("paged_attention")
    if log is not None:
        report = k4a_ptxas(log)
        emit(k4a_ptxas=report)
        check(spill_free(report, K4A_INSTANTIATIONS),
              f"K4a: want no spills in its {len(K4A_INSTANTIATIONS)} "
              f"instantiations, ptxas gave {report}")
        report = k4w_ptxas(log)
        emit(k4w_ptxas=report)
        check(spill_free(report, K4W_INSTANTIATIONS),
              f"K4w: want no spills in its {len(K4W_INSTANTIATIONS)} "
              f"instantiations, ptxas gave {report}")
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._target("paged_attention"))], capture_output=True,
            text=True, check=True, timeout=300).stdout
        loads = k4a_readonly_loads(sass)
        emit(k4a_readonly_loads=sum(loads.values()), functions=len(loads))
        check(len(loads) == len(K4A_INSTANTIATIONS)
              and not any(loads.values()),
              f"K4a: pool loads through the read-only path {loads}")

    if args.attention:
        masked, _timing, a1, a2 = attention_phase(torch, fa)
        emit(attention_launches={"attention": dict(zip(ALL_KERNELS, a1)),
                                 "attention_modules": dict(zip(ALL_KERNELS,
                                                               a2))})
        return 0

    def allocated(after):
        emit(allocated={"after": after,
                        "bytes": torch.cuda.memory_allocated()})

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    cases = timed("kernel_phase", kernel_phase, torch, fa)
    allocated("kernel_phase")
    bwd_cases = timed("bwd_phase", bwd_phase, torch, fa)
    allocated("bwd_phase")
    timed("head_phase", head_phase, torch)
    allocated("head_phase")
    ce_cases = timed("ce_phase", ce_phase, torch)
    allocated("ce_phase")
    moe_cases = timed("moe_phase", moe_phase, torch)
    allocated("moe_phase")
    decode_cases = timed("decode_kernel_phase", decode_kernel_phase, torch)
    allocated("decode_kernel_phase")
    torch.cuda.empty_cache()
    engine, _model, serve = timed("slice_phase", slice_phase, torch, fa)
    timed("profile_phase", profile_phase, torch, fa, engine)
    timed("decode_profile_phase", decode_profile_phase, torch, engine)
    modes = timed("serve_phase", serve_phase, torch, _model, engine)
    pipeline = timed("pipeline_phase", pipeline_phase, torch, _model, engine)
    frontdoor = timed("frontdoor_phase", frontdoor_phase, torch, _model,
                      engine)
    del engine, _model
    torch.cuda.empty_cache()
    allocated("slice_phase")
    fleet = timed("fleet_phase", fleet_phase, torch)
    allocated("fleet_phase")
    train = timed("train_phase", train_phase, torch, fa)
    moe = timed("moe_train_phase", moe_train_phase, torch, fa)
    allocated("moe_train_phase")
    f32_serve = timed("f32_serve_phase", f32_serve_phase, torch)
    f32_train = timed("f32_train_phase", f32_train_phase, torch, fa)
    torch.cuda.empty_cache()
    allocated("f32_train_phase")
    masked, _timing, attention, attention_modules = timed(
        "attention_phase", attention_phase, torch, fa)
    torch.cuda.empty_cache()
    allocated("attention_phase")
    network = timed("network_phase", network_phase, torch)
    torch.cuda.empty_cache()
    detection, _rows = timed("detection_phase", detection_phase, torch, smi)
    torch.cuda.empty_cache()
    transfer = timed("transfer_phase", transfer_phase, torch, smi)
    torch.cuda.empty_cache()
    scoring = timed("scoring_phase", scoring_phase, torch, smi)
    torch.cuda.empty_cache()
    recurrent, wide, k11_rows, k11l_rows = timed(
        "recurrent_phase", recurrent_phase, torch)
    torch.cuda.empty_cache()
    samediff_import, samediff_attention = timed(
        "samediff_phase", samediff_phase, torch, smi)
    torch.cuda.empty_cache()
    onnx_import, onnx_attention = timed("onnx_phase", onnx_phase, torch, smi)
    torch.cuda.empty_cache()
    distributed, dist = timed("distributed_phase", distributed_phase, torch,
                              smi)
    paths = {"serve": serve, "serve_modes": modes, "pipeline": pipeline,
             "frontdoor": frontdoor, "fleet": fleet, "train": train,
             "moe": moe, "f32_serve": f32_serve, "f32_train": f32_train,
             "network": network, "recurrent": recurrent, "wide_layer": wide,
             "attention": attention, "attention_modules": attention_modules,
             "detection": detection, "transfer": transfer,
             "scoring": scoring, "samediff_import": samediff_import,
             "samediff_attention": samediff_attention,
             "onnx_import": onnx_import, "onnx_attention": onnx_attention,
             "distributed": distributed}
    launches = {name: {path: counts_[i] for path, counts_ in paths.items()}
                for i, name in enumerate(ALL_KERNELS)}
    emit(main_path_launches=launches)
    check_path_launches(serve, modes, train, moe, f32_serve, f32_train,
                        pipeline, frontdoor, fleet, network, recurrent,
                        wide, detection, transfer, scoring)
    check(not any(launches["attention_plain"].values()),
          f"the attention op took its plain route on the card: "
          f"{launches['attention_plain']}")
    check_recurrent_launches(recurrent, wide, (attention, attention_modules,
                                               onnx_attention))
    check_distributed_launches(distributed)
    emit(kernels=[kernel_entry("wgmma", cases, launches["wgmma"], masked),
                  kernel_entry("simple", cases, launches["simple"], masked),
                  bwd_kernel_entry("bwd_wgmma", bwd_cases,
                                   launches["bwd_wgmma"], masked),
                  bwd_kernel_entry("bwd", bwd_cases, launches["bwd"],
                                   masked),
                  ce_kernel_entry("ce_fwd", ce_cases, launches["ce_fwd"]),
                  ce_kernel_entry("ce_dlogits", ce_cases,
                                  launches["ce_dlogits"]),
                  moe_kernel_entry("moe_dispatch", moe_cases,
                                   launches["moe_dispatch"]),
                  moe_kernel_entry("moe_combine", moe_cases,
                                   launches["moe_combine"]),
                  ce_kernel_entry("ce_fwd_wgmma", ce_cases,
                                  launches["ce_fwd_wgmma"]),
                  ce_kernel_entry("ce_dlogits_wgmma", ce_cases,
                                  launches["ce_dlogits_wgmma"]),
                  decode_kernel_entry("paged_attention", decode_cases,
                                      launches["paged_attention"]),
                  decode_kernel_entry("kv_quant_write", decode_cases,
                                      launches["kv_quant_write"])]
         + [ce_kernel_entry(k, ce_cases, launches[k])
            for k in ("ce_fwd_tf32", "ce_dlogits_tf32", "ce_split_tf32")]
         + [decode_kernel_entry("paged_attention_write", decode_cases,
                                launches["paged_attention_write"])]
         + recurrent_kernel_entries(launches, k11_rows, k11l_rows)
         + k6_kernel_entries(launches, dist))
    seconds["script"] = time.perf_counter() - t_script
    emit(phase_seconds=seconds)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

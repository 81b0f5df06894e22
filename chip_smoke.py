#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases (any failure raises and the exit code is not 0):
  1. build the CUDA kernels of ``scanobjectnn_torch/csrc`` with nvcc; print
     the registers, local memory and blocks per SM of each instantiation of
     the fused SA kernels (#3/#10 and #4, f32 and bf16) at the main paths'
     shapes, of #17's walk and pool kernels as their plans build them at
     phase 11's calls (``satrain_kernel.kernel_info``), of the self-kNN
     graph kernel at C = 3, 64 and 128 (``knn_kernel.graph_kernel_info``),
     of #13's kernels on every route as the main paths' plans build them
     (``knn_kernel.point_kernel_info``: the group route at BGA's fp3 and
     fp2 and PointCNN's k = 8, the warp route at PointCNN's k = 24 and 48
     and DGCNN's k = 40 graph at C = 64, the selection at k = 128 on 1024
     and 50000 keys, the full sort at k = 20000),
     of the FPS kernels at N = 512, 1024, 2048, 8192 and 40000
     (``fps_kernel.kernel_info``, with their threads), of the fused graph
     and gather (#15: the graph kernel built with its gather epilogue, at
     C = 3 and 64; ``knn_kernel.graph_kernel_info(c, gather=True)``), of the
     ball query (#8/#9, ``ballgroup_kernel.kernel_info``) on the plans of
     the SSG step's SA1 and SA2 calls and phase 10c's, of every build of
     ``edge.cu`` (``edge_kernel.kernel_info``: the staged backward at slice
     widths 8, 4, 2 and 1 at the largest cloud each takes, its per-edge
     route and the forward at 1, 2 and 4 floats a lane, the forward at a
     warp and a half-warp a query) and of the
     duplicate mask (``dupmask_kernel.kernel_info``) and of #18 at the plans
     of its main paths' calls (``poolkey_kernel.kernel_info``), and require
     no local memory;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (FPS 2048->512 and 512->128; the fused SA1 and
     SA2 layers at B=128 in f32 and bf16), and time both with CUDA events;
     FPS's time a step is printed in us and in SM cycles at the clock
     ``nvidia-smi`` reads right after the timed window (here and for the
     training step's two calls in phase 4);
     every timed fused SA call (#3 here and in phase 9, #10 in phase 10, #4
     in phase 12) prints its MLP's FLOPs, their f32 FMA bound (over 67
     TFLOP/s) and the TFLOP/s it reached;
  3. answer a few batches of a 15-class synthetic dataset (N=2048, B=128)
     with the full-width ``pointnet2_cls_ssg`` built by ``get_model`` (seeded
     weights; random positive BN running stats, so the BN fold matters,
     sized so the activations neither vanish nor blow up), in
     bf16 and f32, counting the kernels' launches (under ``sa_bucket``
     "auto", the default, SA1 runs #5 twice and #4, SA2 #3); hold the logits
     bit-equal to the "off" forward's (SA1 through #3); then run the same
     model on the plain path on the same card and compare the logits; time
     the forward under "auto" and "off";
  4. training, f32, B=16 clouds of N=1024 points (``Trainer`` defaults:
     Adam, the LR and BN-momentum schedules, y-rotation + jitter, dropout
     0.5): hold the training kernels against their plain versions at the
     step's shapes (ball group SA1 and SA2, plus empty balls and duplicated
     points; the SA2 neighbour gather and its scatter-add backward, which
     must also be bit-stable and equal bit for bit to the CPU's sequential
     ``index_add_``; its counting sort timed alone, and the most rows
     aimed at one point printed) and time them and FPS indices-only; the
     scatter-add at SpiderCNN's three ``dfeat`` shapes (B=32, R=20480 rows
     onto 1024 points, C = 32, 64, 128), bit-equal to the CPU's sum and
     timed beside ``index_add_``; run a few
     ``train_step``s of a ``Trainer`` built from ``get_model`` (seeded
     weights) on synthetic batches, counting the launches; run one step on
     the kernel path and one on the plain path from the same weights,
     batch and random draws, and compare the loss, every gradient and the
     BN running stats; time a step on both paths;
  5. BGA and part segmentation (``pointnet2_cls_bga``,
     ``pointnet2_cls_partseg``, N=1024 clouds of the synthetic dataset with
     background points):
     a. the kNN kernel against its plain version (indices and squared
        distances equal) at the FP decoder's three shapes (fp1, fp2, fp3) at
        B=32 and B=16, on a cloud with duplicated points, at k=16 with a
        bias and at C=64; timed;
     b. BGA inference at B=32 in f32 and bf16 from ``get_model`` (on the
        card), counting launches, against the plain path on the same card
        (``logits`` and ``seg_logits``), and the fused SA kernel at BGA's
        SA1 shape (K=64, no features); the forward timed;
     c. BGA training, f32, B=16 (``TrainerConfig(model="pointnet2_cls_bga")``,
        seg_weight 0.5): three steps with finite losses, counting launches;
        one step on the kernel path against the plain path; a step timed;
     d. part segmentation at B=8: one forward and one training step, kernel
        path against plain path;
  6. DGCNN and DGCNN-BGA (``dgcnn``, ``dgcnn_bga``: k=20, EdgeConv 64, 64,
     64, 128, agg 1024), B=32 clouds of N=1024 points of the synthetic
     dataset with background points, on the layer inputs that one forward
     of the f32 ``dgcnn`` hands its kernels:
     a. the self-kNN graph kernel against its plain version (indices equal)
        on the T-Net's and EdgeConv 1-4's inputs (C = 3, 3, 64, 64, 64) and
        on clouds of duplicated points at C=3 and C=64; timed, each call
        beside its bound and its no-contraction issue bound (2C + 4
        separate f32 instructions a pair at 33.5 T instructions/s);
     b. the edge-reduce forward kernel against its plain version at
        EdgeConv 1-4's (Cf, Cv) = (3, 64), (64, 64), (64, 64), (64, 128):
        every output equal; timed;
     c. its backward kernel against autograd through the plain version,
        bit-stable across two calls and equal to ``edge_reduce_bwd_ordered``;
        timed, and its device time split into the counting sort and the sum
        (a profiler trace), beside the bytes the sum moves and the per-edge
        kernel's 32 Cv bytes an edge;
     d. the T-Net's neighbour gather (#15: one kernel, the graph kernel
        with its gather epilogue) against its plain version, forward equal
        and backward (the scatter-add); timed by CUDA events (its traces
        lost kernels) and device time, and SpiderCNN's call (B=32, C = Cv =
        3) beside it;
     e. ``dgcnn`` inference in f32 and bf16 from ``get_model``, counting
        launches, against the plain path on the same card; the forward
        timed;
     f. ``dgcnn`` training, f32 (``TrainerConfig(model="dgcnn",
        batch_size=32)``): three steps with finite losses, counting
        launches; one step on the kernel path against the plain path; a
        step timed; then bf16 training (``bf16_steps``: one step counting
        #11, #14's forward and backward, #15 and #7, each required to
        launch; one against the plain path by the bf16 step bounds; two
        equal steps bit-equal; timed beside the f32 step);
     g. ``dgcnn_bga``: inference in f32 and bf16 and one training step, each
        against the plain path; timed; then its bf16 steps as in f;
  7. SpiderCNN (``spidercnn_cls_xyz``: one xyz kNN, k=20, SpiderConv 32, 64,
     128, 256 with T=5, GroupNorm, top-2 pooling, fc 1024, 512), B=32 clouds
     of N=1024 points of the synthetic dataset:
     a. the SpiderConv forward kernel (#16) against its plain version at
        conv1-4's shapes, on the inputs that one forward of the f32 model
        hands them; at conv4 both printed against a float64 product; timed
        (CUDA events) beside the plain version and the one ``torch.matmul``
        of its materialised outer product; its bound in f32 and, beside it,
        as three TF32 products;
     b. its backward (dfeat through the scatter-add, dg, dkernel) against
        autograd through the plain version, and bit-stable; timed, and its
        data and weight halves timed apart, each beside the one
        ``torch.matmul`` that computes its product (``dout @ Wᵀ``; ``pᵀ @
        dout`` with p formed outside the timed call), TF32 off, each read
        three times (10 calls a read, CUDA events), its mean and spread
        printed;
     c. ``spidercnn_cls_xyz`` inference in f32 and bf16 from ``get_model``,
        counting launches, against the plain path on the same card; timed;
     d. training, f32 (``TrainerConfig(model="spidercnn_cls_xyz",
        batch_size=32)``): three steps with finite losses, counting launches;
        one step on the kernel path against the plain path; a step timed;
        then bf16 training as in 6f (#15, #16's forward and backward, #7),
        held to the plain path by ``spider_bf16_gate``: the loss within
        SPIDER_BF16_LOSS_RTOL, each tensor within the bf16 step bound or
        three times what a float64 contraction moves it on the plain path;
  8. PointCNN (``pointcnn_cls``: ``modelnet_x3_l4``, ``pointcnn_seg``:
     ``object_dataset_x3``, x=3), B=32 clouds of N=1024 points of the
     synthetic dataset with background masks, with exact copies of earlier
     points (inside the first 384, so the 384-point layer has them too) and
     a -0.0/0.0 pair injected, on the inputs that one f32 ``pointcnn_seg``
     forward hands its kernels (the kernel branch of its unique kNN, every
     call with k <= 64: ``xconv_1-4``, ``xdconv_4``, ``xdconv_5``):
     a. the duplicate mask #12 on the [32, 1024|384|128, 3] clouds,
        equal to its plain version; timed (CUDA events, and device time)
        beside an empty kernel of the same grid launched the same way, the
        floor of a call this small;
     b. the kNN #13 at the six calls (k = 8, 24, 32, 48, 48, 32) with the
        duplicate bias, equal to ``knn_point_plain``; timed; then both
        branches of ``knn_indices_general`` (#12 + #13, and the full sort)
        timed at every call of the forward with k <= 64, the dispatch's
        crossover;
     c. ``pointcnn_cls`` and ``pointcnn_seg`` inference in f32 and bf16 from
        ``get_model``, counting launches, against the plain path on the
        same card; the forward timed;
     d. training, f32, with PointCNN's recipe (``TrainerConfig(model=...,
        batch_size=32)``: step LR, Adam eps 1e-2, L2 1e-5, the PointCNN
        augmentation): three steps of ``pointcnn_cls`` with finite losses
        and one of ``pointcnn_seg``, counting launches; one step of each on
        the kernel path against the plain path; a step timed; then bf16
        training of each as in 6f (#12, #13, #6 and #7).
  9. PointNet++ MSG (``pointnet2_cls_msg``: SA-MSG 512 with K = 16, 32,
     128, SA-MSG 128 with K = 32, 64, 128, group-all, the SSG head), clouds
     of N=1024 points of the synthetic dataset:
     a. one forward in f32 and one in bf16 at B=32, counting the fused SA
        layer's six launches (two of them on its chunked K > 64 path) and
        recording their inputs; each of the six calls against its plain
        version, timed;
     b. inference in f32 and bf16 from ``get_model``, against the plain path
        on the same card; the forward timed;
     c. training, f32, B=16: three steps with finite losses, counting
        launches; one step on the kernel path against the plain path; a step
        timed;
 10. the SA layer's other kernels, B=32 clouds of N=1024 points:
     a. ``SAModule`` with ``knn=True, nsample=32`` and with ``nsample=128``
        (ball) at SSG's SA1 (512, r 0.2, 64-64-128, no features) and SA2
        (128, r 0.4, 128-128-256, 128 features) shapes, f32 and bf16, seeded
        weights: FPS, the kNN kernel or the ball group, then #10
        (``sa_mlp_pool``), counting launches, against the plain path;
     b. #10 on the inputs those layers handed it, against its plain
        version; timed;
     c. #8 through ``ops.query_ball_point`` at M=512 centroids, K=32 (r 0.2)
        and 128 (r 0.4), counting launches: idx and cnt equal to
        ``ball_query_plain``; timed.
 11. mixed-precision and fused-tail training, B=16 clouds of N=1024 points:
     a. bf16 ``Trainer`` steps (``dtype="bfloat16"``, pool_precision "auto":
        exact keys) of ``pointnet2_cls_ssg`` and ``pointnet2_cls_msg``,
        counting launches and recording the inputs of #18
        (``bn_relu_exactkey_pool``: SSG's three SA layers, MSG's six scales
        and group-all); each call bit-equal to its plain version (pooled,
        kmax, cnt); timed beside its bound, with its launch plan
        (``poolkey_kernel.plan``);
     b. f32 and bf16 steps with ``fused_sa_train=True`` (pool mode native),
        recording the inputs of #17 (``grouped_bn_mlp_pool_bwd``); at SSG's
        SA1, SA2 and group-all and MSG's two K = 128 scales each call held
        to its plain backward (FUSED_* bounds) and bit-stable across two
        calls; timed beside the plain backward, with TFLOP/s against the
        3-product work (``satrain_work``) and against its own passes
        (``satrain_design_ops``), its device time by kernel and pass from a
        profiler trace, whose launches must be those its plan lays out;
     c. the bf16 steps against the plain path (``compare_steps``, BF16_*
        step bounds) and timed (``time_steps``) beside the f32 step of the
        same model;
     d. the f32 steps with ``fused_sa_train=True`` against ``False`` on the
        kernel path, from the same weights, batch and draws: the loss and
        every gradient (FUSED_STEP_* bounds); both timed, and their peak
        device memory (``torch.cuda.max_memory_allocated``);
     e. ``SAModule(knn=True, nsample=128)`` at SSG's SA1 and SA2 shapes
        (B=32), f32 and bf16, through FPS, the kNN kernel's k > 64 path (the
        selection), the gather and #10, against the plain path; the
        kNN call at k = 128 equal to ``knn_point_plain``, timed.
 12. the bucketed SA path and evaluation at N=2048:
     a. #5 (``rank_sort_points``) at SSG SA1's two calls (B=128: the points,
        N=2048, and the queries, M=512, keyed by each cloud's widest axis),
        on a tie lattice with -0.0 and NaN keys, and carrying bf16 feature
        rows; at B=8 on N = 1, 31, 32, 33, 257 and 2047 (the plan's edges)
        and 16384, on ascending, descending, all-equal, all-NaN and signed-
        zero keys, with f32 and odd-width bf16 rows: sorted rows, ids, rank
        and rows equal to its plain version; the two SA1 calls timed beside
        ``torch.argsort(stable=True)`` (device time and CUDA events);
     b. #4 (``sa_ball_mlp_pool_bucketed``) at the "auto" SA1 call (B=128,
        (W, T, G) = (896, 64, 128)), f32 and bf16: pooled bit-equal to the
        #3 kernel's and held to its plain version; the overflowed tiles
        printed out of the total (the window must have served some); timed
        beside #3 and the plain version;
     c. #4 on a cloud that forces every tile to overflow, on a dense cloud
        (more than K hits in a ball) and with 64 features at an explicit
        (W, T, G), f32 and bf16, as in b;
     d. an SSG ``Trainer.evaluate`` at N=2048 (60 clouds, batch 32, 3 votes:
        #1, #3, #4, #5 on the card), counting launches, with the same
        predictions on the plain path; both timed.
 13. the ranges the card refused before, each equal to its plain version
     and its route's launches counted (``fps.large_launches``,
     ``knn_point_kernel.tiled_launches``,
     ``knn_point_kernel.fullsort_launches``,
     ``knn_graph_kernel.routed_launches``,
     ``edge_reduce_bwd_kernel.routed_launches``,
     ``edge_gather_knn.routed_launches``; recorded beside the launches in
     the kernels line, with ``edge_gather_knn.fused_launches``, its calls
     through the one fused kernel):
     a. FPS at B=8, N=40000 -> 512 through ``ops`` (with and without
        coordinates: the kernel for clouds above 8192 points), and on a
        lattice cloud with ties and a NaN row; timed with its bound;
     b. ``knn_point_kernel`` at B=1, M=1024 queries, N=50000 keys, k=128
        (each tile's words selected, the tiles merged); timed with its
        bound; and three of those queries at k=20000 with a bias, whose
        selected words do not fit a block: the full sort
        (``knn_point_kernel.fullsort_launches``);
     c. the self-kNN graph at k=40 (the general kNN kernel) at DGCNN's
        shapes (B=32, N=1024, C=3 and 64, and duplicated points), and at
        k=100 (the sort); device time with its bound;
     d. ``dgcnn`` with k=40: inference in f32 and bf16 and one training
        step (B=32), each against the plain path by the DGCNN gates (the
        T-Net's gather through the general kNN and the gather kernel);
     e. the EdgeConv backward at B=2, N=9686, Cv=64 (a cloud whose one
        channel does not fit the staged kernel: the per-edge route), equal
        to ``edge_reduce_bwd_ordered``; device time.
 14. the data files, written by the port's writers in a temporary
     directory and read by its loaders (``data/io.py``):
     a. an h5 of the synthetic dataset with masks (15 classes x 4 clouds of
        2048 points, ``synthetic.write_synthetic_h5``), read back by
        ``io.load_withmask_h5``; on a machine without h5py (the loaders
        import it when called) the line says so, and b and c take the
        arrays that file would hold from ``make_synthetic_dataset``;
     b. an SSG ``Trainer.evaluate`` of that file at N=2048 (batch 32, 3
        votes, ``sa_bucket`` "auto"): #1, #5, #4 and #3 launched, the
        predictions equal to the plain path's;
     c. a BGA evaluation of the same file at N=1024 with its binary masks
        (``io.convert_to_binary_mask``): predictions equal, and 99% of the
        per-point argmaxes;
     d. 30 raw ``.bin`` objects of 1500-2600 points (11 floats a point,
        semantic labels 0, 1, 2 and -1 beside the object's) and a pickled
        file list, read by ``io.load_data`` with and without background
        (the clouds below 2048 points dropped), centred and normalised, and
        evaluated by SSG as ragged input: ``total_seen`` the clouds loaded,
        the predictions equal to the plain path's.
 15. the command line: each command through
     ``scanobjectnn_torch.train.cli.main(argv)`` in a temporary directory
     made the working directory (the old one restored after a failure too),
     its wall seconds printed, its launches counted and split into those of
     ``Trainer.train_epoch`` and of ``Trainer.evaluate``:
     a. 75 raw ``.bin`` objects (five a class, 1500-2600 points) and their
        pickled listing, whose file names resolve against the working
        directory;
     b. ``train`` (SSG, N=1024, B=16, 2 epochs, ``--log_dir log``): two
        epoch lines in ``log_train.txt``, ``metrics.jsonl`` epochs [0, 1],
        ``checkpoint/``, ``checkpoint_best/``, ``best.json``, ``last.json``
        at epoch 1; #2, #9, #6 and #7 launched in the training epochs, #1
        and #3 in the evaluations; the epochs' seconds from the log and the
        evaluations' from ``metrics.jsonl``;
     c. ``train --resume --max_epoch 3``: exactly one more epoch, and a
        best accuracy no lower;
     d. ``evaluate --num_votes 3``, then the same with ``--ops_backend
        lax``: the lax run launches nothing and both ``pred_label.txt``
        files are equal byte for byte;
     e. ``evaluate --num_point 2048 --num_votes 3`` (``sa_bucket`` "auto"):
        #5 and #4 launched;
     f. ``draw_cmat``: ``cmat.pdf``, or ``cmat.pdf.txt`` where matplotlib
        is missing, and which one;
     g. ``train --profile --max_epoch 1`` into a fresh log directory: the
        trace (``torch.profiler``, Chrome format) names #2's and #9's
        kernels (``fps_kernel``, ``ballgroup_kernel``).
 16. the PointNet family and 3DmFV-Net, on a 15-class synthetic dataset
     with background masks and parts (N=1024), its wall seconds printed:
     a. inference: ``pointnet_cls``, ``pointnet_cls_basic``,
        ``pointnet_seg`` and ``pointnet_partseg`` at B=32 in f32 and bf16,
        and ``3dmfv_net_cls`` (the 5³ grid) at B=32 in f32 and bf16, each built on
        the CPU from one seeded draw (weights, random positive BN running
        stats) and copied to the card: the card's logits held to the CPU
        forward's (f32 within F32_LOGIT_TOL x max(1, |ref|max), the classes
        equal; bf16 by the bf16 rule at PN_BF16_ULPS on any share of the
        elements, the classes to BF16_CLASS_AGREEMENT, 3DmFV's on every
        cloud whose top two CPU logits lie more than twice the largest
        error apart), ``seg_logits`` also
        by their per-point argmaxes (SEG_AGREEMENT); each forward timed;
     b. ``3dmfv_net_cls``'s f32 forward again with
        ``torch.backends.cudnn.allow_tf32`` True for the call: its logits
        equal to (a)'s bit for bit (the model runs its convolutions without
        TF32 whatever the flag); the flag restored; one of its convolutions
        called unscoped with TF32 on, for the size of what the scope keeps
        out;
     c. bf16 training (exact-key pooling): one ``pointnet_cls`` and one
        ``pointnet_seg`` step at B=32: #18 launches 3 times a step, each
        call equal to ``bn_relu_exactkey_pool_plain`` bit for bit and
        timed by CUDA events beside its bound and its launch plan (the
        record sums the ``pointnet_cls`` step's three); each step against
        the plain path (``compare_steps``), and timed beside the f32 step;
     d. f32 training at B=64: one step each of ``pointnet_cls``,
        ``pointnet_partseg`` and ``3dmfv_net_cls`` (the static 5³ GMM, and
        ``learnable_gmm=True`` on the 3³ grid, PN_LEARNABLE_GMM, with no
        Fisher vector feature exactly 0), no augmentation and no dropout, held to
        the same step on the CPU from the same weights and batch: the loss
        within PN_STEP_LOSS_RTOL, every gradient and BN running stat within
        TRAIN_GRAD_TOL x max(1, |ref|max) (the Dense and conv biases before
        a training BN, true gradient 0, within ZERO_GRAD_TOL); the card's
        relu gates and 3DmFV's max-pool winners are fed to the CPU step (a
        gate whose input lies within rounding of 0, or a window whose two
        largest values do, would otherwise decide otherwise on one side and
        move a whole row's or cell's gradient), each where they differ
        within PN_GATE_MARGIN there; the busy ms and idle share of each card
        step (``profile_forward.profile_one``); two equal 3DmFV steps (each
        GMM) equal bit for bit in the loss, every gradient and every BN
        statistic, and cuDNN's ``allow_tf32`` and ``deterministic`` flags as
        they were; the 3DmFV forward's peak memory; then each GMM's bf16
        step at B=64 as in 6f (against the plain path, which runs the same
        cuDNN calls; two equal steps bit-equal with cuDNN's flags as they
        were; timed beside the f32 step);
     e. the command line on phase 15's ``.bin`` clouds: ``train --model
        pointnet_cls --dtype bfloat16 --max_epoch 1`` and ``train --model
        3dmfv_net_cls --max_epoch 1``: each writes its epoch line,
        ``metrics.jsonl`` and ``checkpoint/``; the bf16 run launches #18.
 17. data parallelism (``parallel/mesh.py``, ``Trainer(mesh=...)``), at the
     SSG step's global batch (B=16, N=1024), two momentum steps each:
     a. a group of one rank (NCCL, ``cuda:0``): ``pointnet2_cls_ssg`` in
        f32 with the fused SA tail (#17's backward a pass a call) and in
        bf16 (exact keys, #18), ``dgcnn_bga`` in f32, every step's loss,
        parameters and BN statistics bit-equal to the no-group trainer's,
        the same launches;
     b. two gloo ranks sharing the card (spawned, joined within
        DP_JOIN_TIMEOUT; NCCL refuses two ranks on one device), each B=8,
        the same three cases against one process on B=16 by the rules
        beside DP_CASES (each step's update and loss), and three planted
        faults (DP_CONTROLS) that must fail them; the ranks' states equal;
        each rank's launches (#2, #9, #6, #7, #17; #18; #11, #14 both
        ways, #15) equal to the one process's, its step ms by CUDA events
        and the collectives' share of a step with each ``all_reduce``
        between synchronizes;
     c. ``python -m torch.distributed.run --standalone --nproc_per_node 1
        -m scanobjectnn_torch.train.cli train --device cuda`` on phase 15's
        kind of raw ``.bin`` clouds, one epoch, within DP_CLI_TIMEOUT (the
        launcher and its worker killed together past it): exit 0, the log
        line ``devices=1``, one epoch, a checkpoint;
     d. one device-resident epoch (``train_epoch_device``) of SSG f32 with
        the fused SA tail over 45 uploaded clouds (two global batches of
        16) on 17b's two ranks against one process, each step held by 17b's
        f32 rules; the ranks' states equal, their launches (#2, #9, #6, #7,
        #17) the one process's; the epochs' seconds printed.
 18. the device-resident path (``Trainer.upload_dataset``,
     ``train_epoch_device``, ``evaluate_device``; rules beside
     RESIDENT_CLOUDS), on 240 synthetic clouds of 2048 points, its seconds
     printed:
     a. two resident epochs of SSG f32 at B=16, N=1024, each bit-equal to
        ``train_epoch`` over the view it drew from the same state (every
        parameter, BN statistic, optimizer moment, the step, the step
        generator and the summary); the first counting #2, #9, #6 and #7,
        the second up to its readback under
        ``torch.cuda.set_sync_debug_mode("error")``, its one readback named;
     b. one ``pointnet2_cls_bga`` bf16 epoch with masks, held the same way
        (#18 and #13 launched too);
     c. ``evaluate_device(shuffle=False)`` against ``evaluate(shuffle=
        False)``: SSG at phase 12d's configuration (#1, #3, #4, #5
        launched), BGA with masks (N=1024, #1, #3, #13) and
        ``pointnet_partseg`` with parts (N=1024, 5 parts, 2 never seen):
        every key, prediction and tally equal, the mean loss within
        RESIDENT_LOSS_RTOL; each path timed, in turns;
     d. one Table-5 row through ``table5.train_and_evaluate``
        (``pointnet_cls``, one epoch, the best checkpoint restored, 12
        votes);
 19. the synthetic-hard harness (``train/synth_hard.py``) at its shapes,
     N=128 clouds of its own data (``synth_hard.build_data``), where SA1
     of the PointNet++ family asks FPS for 512 centroids; its seconds
     printed:
     a. #1 and #2 at M > N (B=2, N = 128 and 100, M = 512) against
        ``fps_plain``: indices and coordinates equal, index 0 once every
        point is taken; timed;
     b. #3 at the harness's eval calls (B=24, N=128: SSG's SA1 and SA2 and
        MSG's six scales, K = 128 = N through the chunked path), recorded
        from f32 forwards, each against its plain version; timed;
     c. ``synth_hard.main`` in a temporary directory: ``pointnet2_cls_bga``
        f32, then ``pointnet2_cls_ssg:bfloat16 --pool_f32 keys --merge``,
        SYNTH_EPOCHS epochs each, counting launches (#1, #2, #3, #6, #7,
        #9 and #13, then #18, required); both rows in the json with the
        JAX script's keys, accuracies in [0, 1], the markdown naming the
        card;
     d. every row of ``synth_hard.ROWS`` through ``run_row`` on
        SYNTH_ROW_CLOUDS training and SYNTH_BATCH test clouds, one epoch,
        its launches counted and printed by kernel (the harness's kernels
        by family); each row's accuracies in [0, 1];
     e. one training step of ``pointnet2_cls_bga`` f32 and one of
        ``pointnet2_cls_ssg`` bf16 with exact keys at B=24, N=128: every
        kernel call of the step (#1/#2, #6, #7, #9, and #13 or #18)
        recorded and held to its plain version on the same inputs (equal;
        #7 bit-stable and equal to the CPU's index-order sum), then the
        step to the plain path's (``compare_steps``, the bounds of phases 4
        and 11).

Every kernel's line in the ``{"kernels": [...]}`` record carries its
bound: the larger of the bytes it must move over 3.35 TB/s and the
operations it must do over the peak rate of their type (67 TFLOP/s f32,
989 TFLOP/s bf16), counted from this run's inputs (a scan that stops after
K hits counts the points it reaches), for the same calls as its ``ms``.

f32 products run in full f32: TF32 is switched off for matmuls and cuDNN.
Prints the card's name and power limit, the build time, per-kernel times,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

BATCH, NUM_POINT, NUM_CLASSES = 128, 2048, 15
# Tolerances (kernel vs plain version on the same card).  f32: only the
# summation order differs.  bf16: both sum the same bf16-rounded products in
# f32 and round at the same points, so they agree bit for bit (every run on
# an H100 read 0).  Allowed: a difference of at most BF16_*_ULPS bf16 ulps
# of the scale max(1, |ref|max), on at most BF16_MAX_DIFFERING of the
# elements.  A kernel that skipped a rounding between layers differs on far
# more.  The fused SA layer's bf16 MLP on the tensor cores
# (studies/sa_mma.py, H100) read 1.0e-5 to 1.7e-4 of a call's pooled
# elements differing, within this rule, but 37% of the SSG bf16 forward's
# logits (40% of MSG's) differing by an ulp: the kernels keep FMA in bf16.
F32_RTOL, F32_ATOL = 1e-4, 1e-5
F32_LOGIT_TOL = 1e-4  # x max(1, |ref|max)
BF16_SA_ULPS, BF16_LOGIT_ULPS = 1, 2
BF16_MAX_DIFFERING = 1e-3
BF16_CLASS_AGREEMENT = 0.99
# Training (f32).  Ball group and gather: equal.  Scatter-add against
# index_add_: both sum exact f32 in other orders, within SCATTER_TOL x
# max(1, |ref|max).  One step, kernel path against plain path: the forward
# is the same arithmetic (loss within TRAIN_LOSS_RTOL); the gradients differ
# only through the scatter's summation order (TRAIN_GRAD_TOL x max(1,
# |ref|max) per tensor, as the f32 SA bound).  A Dense bias that feeds a
# training-mode BN has a gradient of exactly 0 (BN subtracts the batch
# mean): the step computes rounding noise there, up to 1.4e-4 in SA1, and a
# one-ulp change of the scatter's output moves it by 1.9e-4 (CPU, at these
# shapes), while every other tensor moves by less than 3e-6 of its scale.
# Those biases are held to |g| <= ZERO_GRAD_TOL on both paths instead.
TRAIN_BATCH, TRAIN_POINT, TRAIN_STEPS = 16, 1024, 3
SCATTER_TOL = 1e-5
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, ZERO_GRAD_TOL = 1e-6, 1e-4, 1e-3
# BGA and part segmentation (phase 5): inference at the JAX package's
# "Inference by family" batch, training at its training table's batches.
# The kNN kernel must equal its plain version (the same f32 operations in
# the same order, the same tie rule); the model paths are held to the SSG
# bounds above, and the per-point argmax of seg_logits to SEG_AGREEMENT.
SEG_BATCH, SEG_POINT, SEG_TRAIN_BATCH, PARTSEG_BATCH = 32, 1024, 16, 8
SEG_AGREEMENT = 0.99
# DGCNN (phase 6): inference at the JAX package's "Inference by family"
# batch and training at its training table's, B=32, N=1024, k=20.  The graph
# kernel, the reduce kernel and the gather must equal their plain versions
# (the same f32 operations in the same order, the same tie rule).  The
# reduce backward sums the same per-edge coefficients as autograd through
# the plain version, in another order: within EDGE_BWD_TOL x max(1,
# |ref|max), bit-stable, and equal to ``edge_reduce_bwd_ordered`` (the same
# operations in the kernel's order).  The model paths are held to the SSG
# bounds.
DGCNN_BATCH, DGCNN_POINT, DGCNN_K = 32, 1024, 20
# The ranges the card once refused (phase 13): FPS on (B, N, samples), the
# general kNN on (B, queries, keys, k), the self-kNN graph and dgcnn at k;
# and the EdgeConv backward's per-edge route on (B, N, Cv), a cloud one
# point past its staged kernel's reach.
RANGE_FPS, RANGE_KNN, RANGE_GRAPH_K = (8, 40000, 512), (1, 1024, 50000, 128), 40
RANGE_FULLSORT_K = 20000  # k on RANGE_KNN's keys whose selected words do not fit a block
RANGE_EDGE = (2, 9686, 64)
EDGE_BWD_TOL = 1e-5
# SpiderCNN (phase 7): inference and training at the JAX package's B=32,
# N=1024, k=20.  The SpiderConv kernel sums the same f32 products feat·g as
# the plain version, against the kernel, in another order than cuBLAS: the
# forward within SPIDER_FWD_TOL x max(1, |ref|max) (tighter than
# F32_LOGIT_TOL), the backward within SPIDER_BWD_TOL x max(1, |ref|max) per
# tensor, and bit-stable.  In bf16 the model rounds each layer's f32 output
# to bf16, so a last-bit difference of the two paths' sums can move a
# rounding there, and the logits agree to BF16_LOGIT_ULPS on any share of
# the elements (the f32 logits hold the tight bound).
# One training step, kernel path against plain path: unlike the other
# kernels', this forward is not bit-equal to its plain version, and its
# last-bit differences move the loss by about 1.5e-6 relative (read on an
# H100), so the loss is held to SPIDER_LOSS_RTOL; every gradient and BN stat
# to TRAIN_GRAD_TOL as above.
SPIDER_BATCH, SPIDER_POINT, SPIDER_K = 32, 1024, 20
SPIDER_FWD_TOL, SPIDER_BWD_TOL, SPIDER_LOSS_RTOL = 1e-5, 1e-5, 1e-5
# A bf16 SpiderCNN step, kernel path against plain path: the f32 outputs'
# last-bit differences move the bf16 roundings of each layer's output, and
# those grow through four layers and the head's BNs, so the loss is held to
# the bf16 step bound, SPIDER_BF16_LOSS_RTOL = BF16_STEP_GRAD_TOL (2e-2),
# as every gradient and BN stat (phase 11's bf16 steps).
SPIDER_BF16_LOSS_RTOL = 2e-2
# Its gradients and BN stats: a last-bit change of the f32 contraction alone
# (the float64 product rounded to f32 in place of the f32 one, on the plain
# path) moved the bf16 step's tensors by up to 0.31 of their scale (read on
# an H100 at B=32, printed by ``spider_bf16_gate``; the kernel path read
# 0.034): the bf16 roundings of each layer's output, GroupNorm and the
# top-2 picks amplify it.
# The kernel path's forward sums in another order than cuBLAS, so it is held
# per tensor to the larger of BF16_STEP_GRAD_TOL x max(1, |ref|max) and
# BF16_TENSOR_RATIO times that change's own distance from the plain step in
# the same run (``spider_bf16_gate``; 3: two independent roundings, the CPU
# tests' mixed-train rule).
BF16_TENSOR_RATIO = 3.0
# PointCNN (phase 8): inference and training at the JAX package's B=32,
# N=1024.  #12 and #13 must equal their plain versions (float == on both
# sides; the same f32 operations in the same order, the same tie rule), so
# the kernel and plain paths are the same arithmetic but for the scatter-add
# of the training backward: the model paths are held to the SSG bounds.
PCNN_BATCH, PCNN_POINT = 32, 1024
# MSG (phase 9): inference at the JAX package's "Inference by family" batch,
# training at its training table's, held to the SSG bounds; #3 at K = 128
# to the fused SA bounds.  SAModule's kNN / K > 64 branches and the ball
# query (phase 10) at SSG's SA1 and SA2 shapes: #10 to the fused SA
# bounds, #8's idx and cnt equal to ball_query_plain.
MSG_BATCH, MSG_POINT, MSG_TRAIN_BATCH = 32, 1024, 16
# The data files (phase 14): an h5 of 4 clouds a class, evaluated at batch
# DATA_BATCH, and DATA_CLOUDS raw .bin objects of their own sizes.
DATA_BATCH, DATA_CLOUDS = 32, 30
# The command line (phase 15): CLI_CLOUDS raw .bin objects, five a class.
CLI_CLOUDS = 75
SA_LAYER_BATCH, SA_LAYER_POINT = 32, 1024
# Mixed precision and the fused tail (phase 11), B=16, N=1024.  #18 must
# equal its plain version bit for bit (the same r, the same op order without
# contraction, the same rounding).  #17 sums its products in another order
# than cuBLAS, so a relu gate or pool winner within rounding of a tie may
# flip, and in bf16 a rounding of h may move by one ulp: dz1 (per row) at
# most FUSED_FLIP_SHARE of the elements beyond FUSED_TOL x max|ref|; the
# sums over all rows (dgamma, dbeta, dW; up to 1,048,576 rows at MSG SA1's
# K=128 scale, where dW_2 read 0.14% of its elements beyond 1e-5 of the
# scale on an H100) within FUSED_SUM_TOL x max|ref|, TRAIN_GRAD_TOL, the
# step's bound for f32 gradients summed in other orders; the Dense biases
# (true gradient 0) within FUSED_ZERO_TOL x max(1, |dbeta|max) on both
# sides; two calls bit-equal.  A bf16 step, kernel path against
# plain path: the forward is the same arithmetic (#18 equal), the backward
# differs through the scatter-add's order, whose last-bit changes move bf16
# roundings of the cotangents: the loss to TRAIN_LOSS_RTOL, each gradient
# and BN stat to BF16_STEP_GRAD_TOL x max(1, |ref|max).  The Dense biases
# before a BN have a true gradient of 0, but in bf16 both paths compute
# rounding noise there (read up to 1.34, 0.23 of the layer kernel
# gradient's scale, at SSG on an H100), so they are held as the other
# gradients, kernel path against plain path.  The
# f32 step with the fused tail against the unfused one: the same forward,
# the backward's sums in other orders: FUSED_STEP_GRAD_TOL x max(1,
# |ref|max), the Dense biases before a BN to ZERO_GRAD_TOL.
MIXED_BATCH, MIXED_POINT = 16, 1024
FUSED_TOL, FUSED_FLIP_SHARE, FUSED_SUM_TOL, FUSED_ZERO_TOL = 1e-5, 1e-3, TRAIN_GRAD_TOL, 1e-3
BF16_STEP_GRAD_TOL, FUSED_STEP_GRAD_TOL = 2e-2, 1e-4
# The PointNet family and 3DmFV-Net (phase 16): inference at the JAX
# package's B=32, f32 training at its training table's B=64 (3DmFV; PointNet
# at the same batch), bf16 PointNet steps at B=32.  Card against CPU: the
# same f32 operations summed in other orders (cuBLAS, cuDNN against MKL and
# oneDNN): the loss within PN_STEP_LOSS_RTOL, the rest at the f32 bounds.
# In bf16 the two sides' f32 sums of the same bf16 products, in other
# orders, move a bf16 rounding now and then, and the moves grow through
# PointNet's 10-14 layers: the logits within PN_BF16_ULPS bf16 ulps of the
# scale on any share of the elements (read on an H100 against the CPU: up to
# 2.25, pointnet_partseg's seg_logits), the classes and the per-point
# argmaxes by the agreement bounds.
# 3DmFV's bf16 forward (seeded weights, random BN stats) gives logits up to
# 26, where a bf16 ulp is 0.125, and some clouds' top two logits lie within
# an ulp or two of each other (phase 16a prints how many): a class may flip
# between the card and the CPU within the bf16 rule, so its classes must
# agree on the clouds whose top two CPU logits lie more than twice the
# largest logit error apart.
PN_BATCH, PN_POINT, PN_TRAIN_BATCH = 32, 1024, 64
PN_STEP_LOSS_RTOL, PN_GATE_MARGIN, PN_BF16_ULPS = 1e-5, 1e-4, 4
# The learnable GMM's step on the 3³ grid: on the 5³ grid a gaussian that
# no point of a cloud reaches (its posteriors underflow to 0) gives an
# exactly-0 Fisher vector feature, whose sign·sqrt gradient is NaN, in JAX
# as here (read at B=64 on an H100: the GMM's gradients NaN).
PN_LEARNABLE_GMM = {"learnable_gmm": True, "subdivisions": (3, 3, 3)}
PN_NAMES = ("pointnet_cls", "pointnet_cls_basic", "pointnet_seg", "pointnet_partseg")
# Peak rates of one H100 SXM (NVIDIA's data sheet), for the bounds: f32 on
# the CUDA cores, TF32 and bf16 on the tensor cores (dense).
HBM_BYTES_PER_S, F32_OPS_PER_S, TF32_OPS_PER_S, BF16_OPS_PER_S = 3.35e12, 67e12, 495e12, 989e12
# f32 instructions a second on the CUDA cores: the FMA rate counts two
# operations an instruction, so a multiply and an add that may not be
# contracted take two (the self-kNN graph's issue bound).
F32_INSTR_PER_S = F32_OPS_PER_S / 2


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time per call: the union of the intervals of the device
    kernels and copies that ``fn`` launches, traced by torch.profiler
    (``profile_forward.busy_us``, the device busy time of the profile).
    Unlike ``cuda_ms`` it leaves out the gaps in which the card waits for
    the host to launch, which dominate a call of a few microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_forward import busy_us, device_spans

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(8):  # a trace now and then comes back empty (once three in a row): take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = device_spans(prof)
        if spans:
            return busy_us(spans) / 1e3 / iters
        print("device_ms: the profiler recorded no device time; tracing again")
    raise AssertionError("chip_smoke: the profiler recorded no device time")


def scale_of(ref) -> float:
    return max(1.0, float(ref.float().abs().max()))


def check_bf16(got, want, ulps: int, what: str, share: float = BF16_MAX_DIFFERING) -> tuple[float, float]:
    """Hold a bf16 result to ``want`` by the bf16 rule above (at most
    ``share`` of the elements may differ); returns (max abs error, share of
    elements that differ)."""
    diff = (got.float() - want.float()).abs()
    err, differing = float(diff.max()), float((diff > 0).float().mean())
    bound = ulps * 2.0 ** (math.floor(math.log2(scale_of(want))) - 7)  # bf16 keeps 8 bits
    print(f"{what}: max abs err {err:.3e} (bound {bound:.3e}), "
          f"{differing:.2e} of elements differ (bound {share:.0e})")
    require(err <= bound and differing <= share, f"{what} differs from the plain version")
    return err, differing


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


class Work:
    """Operations and bytes of a kernel's calls, as the least time the card
    could take for them (module doc)."""

    def __init__(self):
        self.ops_s = self.bytes_s = 0.0

    def add(self, ops: float, nbytes: float, peak: float = F32_OPS_PER_S) -> None:
        self.ops_s += ops / peak
        self.bytes_s += nbytes / HBM_BYTES_PER_S

    def record(self) -> dict:
        return {"bound_ms": max(self.ops_s, self.bytes_s) * 1e3,
                "bound_by": "operations" if self.ops_s >= self.bytes_s else "bytes"}


def scanned_points(radius: float, k: int, xyz, new_xyz) -> int:
    """Points a ball scan reaches: up to each query's K-th hit, or all N."""
    import torch

    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import ball_query_plain

    idx, cnt = ball_query_plain(radius, k, xyz, new_xyz)
    return int(torch.where(cnt >= k, idx[..., k - 1] + 1, xyz.shape[1]).sum())


def fps_work(work: Work, b: int, n: int, m: int, with_coords: bool = True) -> None:
    # Per step and point: a distance (3 sub, 3 mul, 2 add), a min, a compare.
    work.add(10.0 * b * n * m, 12 * b * n + b * m * (16 if with_coords else 4))


def sm_clock_mhz() -> int:
    """The SM clock ``nvidia-smi`` reads now (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return int(out.split()[0])


def print_fps_step(label: str, ms: float, npoint: int, smi: str) -> None:
    """FPS's time a step (its npoint - 1 serial steps) in us and in SM cycles
    at the clock read right after the timed window."""
    mhz = sm_clock_mhz()
    us = ms * 1e3 / max(npoint - 1, 1)
    print(f"fps step {label}: {us:.4f} us a step, {us * mhz:.0f} SM cycles at {mhz} MHz ({smi})")


# #13's kernels as the main paths' plans build them: (route, N, C, k, lanes)
# at BGA's fp3 and fp2, PointCNN's k = 8, 24 and 48, DGCNN's k = 40 graph
# at C = 64, SAModule's k = 128, N = 50000 at k = 128 and k = 20000.
KNN_BUILDS = (("group", 512, 3, 3, 1), ("group", 128, 3, 3, 2), ("group", 1024, 3, 8, 1), ("warp", 1024, 3, 24, 1),
              ("warp", 384, 3, 48, 1), ("warp", 1024, 64, 40, 1), ("select", 1024, 3, 128, 1),
              ("select", 50000, 3, 128, 1), ("sort", 50000, 3, 20000, 1))


# The ball query's plans at the main paths' calls (B, N, M): the SSG step's
# SA1 and SA2, phase 10c's.
BALL_CALLS = ((16, 1024, 512), (16, 512, 128), (32, 1024, 512))


def check_graph_fps_kernels(smi: str) -> None:
    """Registers, local memory and blocks per SM of the self-kNN graph
    kernel at DGCNN's widths (C = 3 takes the run-time width) and a wider
    run-time width, alone and with #15's gather epilogue, of #13's kernels
    on each route as the main paths' plans build them (``KNN_BUILDS``), of
    the ball query's on the plans of ``BALL_CALLS``, and of the FPS kernels
    at the main paths' N and above 8192 points; no local memory allowed."""
    from scanobjectnn_torch.ops.cuda import ballgroup_kernel
    from scanobjectnn_torch.ops.cuda.fps_kernel import kernel_info as fps_info
    from scanobjectnn_torch.ops.cuda.knn_kernel import graph_kernel_info, point_kernel_info

    for c, gather in ((3, False), (64, False), (128, False), (3, True), (64, True)):
        info = graph_kernel_info(c, gather)
        label = f"#15 knn_graph_tile_kernel<gather> C={c}" if gather else f"#11 knn_graph_tile_kernel C={c}"
        print(f"kernel {label}: {info['registers']} registers a thread, {info['local_bytes']} "
              f"local bytes, {info['smem_bytes']} shared bytes a block, {info['blocks_per_sm']} blocks per SM ({smi})")
        require(info["local_bytes"] == 0, f"{label} uses local memory: {info}")
        require(info["blocks_per_sm"] >= 1, f"{label} fits no block on an SM: {info}")
    for b, n, m in BALL_CALLS:
        plan = ballgroup_kernel.ball_plan(b, n, m)
        info = ballgroup_kernel.kernel_info(*plan)
        label = f"#8/#9 ballgroup_kernel B={b} N={n} M={m}, plan (queries, a warp, unroll, tile) {plan}"
        print(f"kernel {label}: {info['registers']} registers a thread, {info['local_bytes']} local bytes, "
              f"{info['smem_bytes']} shared bytes a block, {info['blocks_per_sm']} blocks per SM ({smi})")
        require(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, f"{label}: {info}")
    for route, n, c, k, lanes in KNN_BUILDS:
        info = point_kernel_info(route, n, c, k, lanes)
        label = f"kernel #13 {route} route N={n} C={c} k={k}" + (f" {lanes} lanes a query" if route == "group" else "")
        print(f"{label}: {info['registers']} registers a thread, {info['local_bytes']} local bytes, "
              f"{info['smem_bytes']} shared bytes a block, {info['blocks_per_sm']} blocks per SM ({smi})")
        require(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, f"{label}: {info}")
    for n in (512, 1024, 2048, 8192, 40000):
        info = fps_info(n)
        print(f"kernel #1/#2 fps N={n}: {info['threads']} threads, {info['registers']} registers a thread, "
              f"{info['local_bytes']} local bytes, {info['smem_bytes']} shared bytes a block, {info['blocks_per_sm']} "
              f"blocks per SM ({smi})")
        require(info["local_bytes"] == 0, f"the FPS kernel at N={n} uses local memory: {info}")
        require(info["blocks_per_sm"] >= 1, f"the FPS kernel at N={n} fits no block on an SM: {info}")


def check_edge_dup_kernels(smi: str) -> None:
    """Registers, local memory and blocks per SM of every build of
    ``edge.cu`` (the staged backward at each slice width, at the largest
    cloud it takes; its per-edge route and the forward at 1, 2 and 4 floats
    a lane, the forward at a warp and a half-warp a query), of the
    duplicate mask #12, of the rank sort #5 at its plans from N = 1 to
    16384 and of #18 at its main paths' plans; no local memory allowed."""
    import torch

    from scanobjectnn_torch.ops.cuda.dupmask_kernel import kernel_info as dupmask_info
    from scanobjectnn_torch.ops.cuda.edge_kernel import kernel_info as edge_info
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import kernel_info as poolkey_info
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import kernel_info as ranksort_info

    # #18's builds at the plans of PointNet's global pool, SSG's SA1 (the
    # column route), SA2 and group-all, one row, an f32 pool and
    # a width of 33 (one channel a lane).
    poolkey_builds = ((32, 1024, 1024, torch.bfloat16), (8192, 32, 128, torch.bfloat16),
                      (2048, 64, 256, torch.bfloat16), (16, 128, 1024, torch.bfloat16),
                      (1, 1024, 1024, torch.bfloat16), (32, 12, 40, torch.float32), (21, 5, 33, torch.bfloat16))

    builds = [("#14 backward, staged", "bwd", w, n) for w, n in ((8, 1024), (8, 1210), (4, 2048), (2, 4842),
                                                                 (1, 9685))]
    builds += [(f"#14 {name}", kernel, w, 1024) for name, kernel in (("backward, per-edge route", "bwd_edge"),
                                                                     ("forward", "fwd"), ("forward", "fwd16"))
               for w in (1, 2, 4)]
    for label, kernel, width, n in builds:
        if kernel == "fwd16":
            info, label = edge_info("fwd", width, n, lanes=16), label + ", a half-warp a query"
        else:
            info = edge_info(kernel, width, n)
        shape = f"slice {width}, N={n}" if kernel == "bwd" else f"{width} floats a lane"
        print(f"kernel {label} ({shape}): {info['registers']} registers a thread, {info['local_bytes']} local bytes, "
              f"{info['smem_bytes']} shared bytes a block, {info['blocks_per_sm']} blocks per SM ({smi})")
        require(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, f"{label} ({shape}): {info}")
    info = dupmask_info()
    print(f"kernel #12 dupmask_kernel: {info['registers']} registers a thread, {info['local_bytes']} local bytes, "
          f"{info['blocks_per_sm']} blocks of 1024 threads per SM ({smi})")
    require(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, f"the duplicate mask kernel: {info}")
    for n in (1, 64, 256, 512, 2048, 8192, 16384):
        info = ranksort_info(n)
        print(f"kernel #5 ranksort_kernel (N={n}: {info['threads']} threads x {info['per_thread']} words): "
              f"{info['registers']} registers a thread, "
              f"{info['local_bytes']} local bytes, {info['smem_bytes']} shared bytes a block, "
              f"{info['blocks_per_sm']} blocks per SM ({smi})")
        require(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, f"the rank sort kernel at N={n}: {info}")
    for rows, k, c, cdtype in poolkey_builds:
        info = poolkey_info(rows, k, c, cdtype)
        plan = {key: info[key] for key in ("vec", "lanes", "teams")}
        print(f"kernel #18 poolkey_kernel (rows {rows}, K={k}, C={c}, {str(cdtype)[6:]}: plan {plan}): "
              f"{info['registers']} registers a thread, {info['local_bytes']} local bytes, "
              f"{info['blocks_per_sm']} blocks per SM ({smi})")
        require(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, f"#18 at ({rows}, {k}, {c}): {info}")


def kernel_split_ms(fn, groups: dict, iters: int = 10) -> dict:
    """Device ms a call of ``fn``'s kernels, summed by group: ``groups``
    maps a name to (substrings of kernel names, kernels a call), from a
    torch.profiler trace of ``iters`` calls (``profile_forward.device_spans``).
    Each group is read over the last ``iters - 1`` calls' kernels: a trace
    now and then loses the first kernels of its window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_forward import device_spans

    fn()
    torch.cuda.synchronize()
    for _ in range(8):  # a trace now and then comes back empty or short
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = {g: [] for g in groups}
        for start, end, name in device_spans(prof):
            for g, (keys, _) in groups.items():
                if any(key in name for key in keys):
                    spans[g].append(end - start)
        last = {g: (iters - 1) * per_call for g, (_, per_call) in groups.items()}
        if all(len(spans[g]) >= last[g] for g in groups):
            return {g: sum(spans[g][-last[g]:]) / 1e3 / (iters - 1) for g in groups}
    raise AssertionError(f"chip_smoke: 8 traces missed kernels of {list(groups)}: "
                         f"{({g: len(v) for g, v in spans.items()})}")


# The EdgeConv backward's kernels, for kernel_split_ms: the counting sort's
# three, and the sum.
EDGE_BWD_SPLIT = {"sort": (("count_tiles_kernel", "count_scan_kernel", "count_fill_kernel"), 3),
                  "sum": (("edge_reduce_bwd",), 1)}


def edge_bwd_sum_bytes(b: int, n: int, k: int, cv: int) -> float:
    """Bytes the backward's staged sum moves from device memory or L2: each
    per-query operand, vals and dvals once, the inverse index (offsets and
    perm) once a channel slice."""
    from scanobjectnn_torch.ops.cuda.edge_kernel import bwd_slice_width

    slices = -(-cv // bwd_slice_width(n, cv))
    return 4.0 * (10 * b * n * cv + slices * b * (n + 1 + n * k))


def mlp_ops(weights, rows: int, lifted_points: int = 0) -> float:
    """The folded MLP on ``rows`` (query, slot) rows and the max-pool: per
    layer 2 operations a weight (the product) and 2 an output (bias,
    relu), 1 an output of the last layer (the max).  A prelifted layer 0
    multiplies its feature rows once a point (``lifted_points`` of them)
    and adds the gathered term on every row instead."""
    w0 = weights[0]
    per_row = sum(2 * w.shape[0] * w.shape[1] + 2 * w.shape[1] for w in weights) + weights[-1].shape[1]
    if not lifted_points:
        return float(rows * per_row)
    per_row += w0.shape[1] - 2 * (w0.shape[0] - 3) * w0.shape[1]
    return float(rows * per_row) + 2.0 * lifted_points * (w0.shape[0] - 3) * w0.shape[1]


def sa_work(work: Work, args, dtype, use_xyz: bool = True) -> None:
    """The fused SA layer: its ball scan, its folded MLP on every (query,
    slot) row (layer 0 per point when prelifted), the max-pool; operands
    of the compute dtype; idx written at K <= 64."""
    import torch

    radius, k, xyz, new_xyz, src, weights, _ = args
    b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    rows = b * m * k
    lifted = src is not None and use_xyz and src.shape[-1] > weights[0].shape[1]
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = 12 * (b * n + b * m) + (0 if src is None else src.numel() * elt) + (4 * rows if k <= 64 else 0)
    nbytes += sum(w.numel() * elt + 4 * w.shape[1] for w in weights) + b * m * weights[-1].shape[1] * elt
    work.add(9.0 * scanned_points(radius, k, xyz, new_xyz) + mlp_ops(weights, rows, b * n if lifted else 0),
             nbytes, BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)


def samlp_work(work: Work, args, dtype) -> None:
    """#10: the folded MLP on every (query, slot) row and the max-pool; the
    grouping, the indices, the source and the weights read once, the pooled
    output written once."""
    import torch

    grouped, idx, src, weights, _ = args
    b, m, k = (grouped if grouped is not None else idx).shape[:3]
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = (0 if grouped is None else 4 * grouped.numel()) + b * m * weights[-1].shape[1] * elt
    if idx is not None and src is not None:
        nbytes += 4 * idx.numel() + elt * src.numel()
    nbytes += sum(w.numel() * elt + 4 * w.shape[1] for w in weights)
    work.add(mlp_ops(weights, b * m * k), nbytes, BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)


def sa_flops(args, use_xyz: bool = True) -> float:
    """The fused SA layer's MLP FLOPs (``mlp_ops``) on ``sa_ball_mlp_pool``'s
    ``args``: every (query, slot) row, layer 0 per point when prelifted."""
    _, k, xyz, new_xyz, src, weights, _ = args
    lifted = src is not None and use_xyz and src.shape[-1] > weights[0].shape[1]
    return mlp_ops(weights, xyz.shape[0] * new_xyz.shape[1] * k, xyz.shape[0] * xyz.shape[1] if lifted else 0)


def fma_rate(flops: float, ms: float) -> str:
    """A fused SA call's FLOPs, their f32 FMA bound (over 67 TFLOP/s: the MLP
    runs f32 FMA in both dtypes) and the rate a call of ``ms`` reached."""
    return (f"{flops / 1e9:.3f} GFLOP, f32 FMA bound {flops / F32_OPS_PER_S * 1e3:.4f} ms, "
            f"{flops / ms / 1e9:.2f} TFLOP/s")


def check_sa_kernels(smi: str) -> None:
    """Registers, local memory and blocks per SM of the fused SA kernels (#3
    and #10 in safused.cu, #4 in sabucket.cu, f32 and bf16) at the main
    paths' shapes, which between them take every instantiation (the builds
    for three blocks an SM at SA1's shared memory, for two at SA2's); no
    local memory allowed."""
    import torch

    from scanobjectnn_torch.ops.cuda.safused_kernel import kernel_info

    shapes = {  # label: (K, source channels as the kernel sees them, widths, #4's (N, W) or None)
        "#3 SSG SA1": (32, 0, (64, 64, 128), None),
        "#3 SSG SA2": (64, 128, (128, 128, 256), None),
        "#3 MSG SA2 K=128 (prelifted)": (128, 128, (128, 128, 256), None),
        "#4 SSG SA1": (32, 0, (64, 64, 128), (NUM_POINT, 896)),
        "#4 at SA2's widths (K=64, 128 features, W=384 of N=512)": (64, 128, (128, 128, 256), (512, 384)),
    }
    for label, (k, cs, widths, bucket) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            info = kernel_info(k, cs, widths, dtype, bucket)
            print(f"kernel {label} {dtype}: {info['registers']} registers a thread, {info['local_bytes']} local "
                  f"bytes, {info['smem_bytes']} shared bytes a block, {info['blocks_per_sm']} blocks per SM ({smi})")
            require(info["local_bytes"] == 0, f"{label} {dtype} uses local memory: {info}")
            require(info["blocks_per_sm"] >= 1, f"{label} {dtype} fits no block on an SM: {info}")


def knn_work(work: Work, queries, keys, k: int, with_bias: bool = False) -> None:
    # Per (query, key) pair: the inner product (2C - 1), the expansion (3),
    # the clamp, a compare, and the bias add.
    b, m, c = queries.shape
    n = keys.shape[1]
    work.add(b * m * n * (2 * c + 4 + with_bias) + 2 * c * b * (m + n),
             4 * (b * m * c + b * n * c + with_bias * b * n) + 8 * b * m * k)


def check_fps(xyz, npoint, label, fps, fps_plain) -> float:
    import torch

    idx, new_xyz = fps(xyz, npoint)
    ref_idx, ref_xyz = fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    require(torch.equal(idx, ref_idx), f"FPS indices differ from fps_plain ({label})")
    require(torch.equal(new_xyz, ref_xyz), f"FPS coordinates differ from fps_plain ({label})")
    print(f"fps {label}: indices and coordinates equal to fps_plain")
    return float((new_xyz - ref_xyz).abs().max())


def check_sa(args, dtype, label, sa, sa_plain, **kw) -> float:
    import torch

    pooled, idx = sa(*args, dtype=dtype, **kw)
    ref, ref_idx = sa_plain(*args, dtype=dtype, **kw)
    torch.cuda.synchronize()
    if args[1] > 64:  # the chunked path returns no idx
        require(idx is None and ref_idx is None, f"SA idx at K > 64 ({label})")
    else:
        require(torch.equal(idx, ref_idx), f"SA idx differs from the plain version ({label})")
    return check_pooled(pooled, ref, dtype, f"sa {label}: idx {'None' if idx is None else 'equal'}, pooled")


def check_pooled(pooled, ref, dtype, what: str) -> float:
    """Hold a fused SA layer's pooled output to its plain version: f32 to
    rtol F32_RTOL / atol F32_ATOL, bf16 by the bf16 rule."""
    import torch

    require(pooled.dtype == ref.dtype and pooled.shape == ref.shape, f"output type ({what})")
    if dtype == torch.bfloat16:
        return check_bf16(pooled, ref, BF16_SA_ULPS, what)[0]
    err = float((pooled - ref).abs().max())
    require(torch.allclose(pooled, ref, rtol=F32_RTOL, atol=F32_ATOL),
            f"pooled differs from the plain version ({what}): max abs err {err}")
    print(f"{what} max abs err {err:.3e} (bound rtol {F32_RTOL} atol {F32_ATOL})")
    return err


def feeds_train_bn(param_name: str) -> bool:
    """A Dense bias followed by a training BatchNorm: every MLP layer
    (``dense_i``: SA, FP, seg_fc1) and the class heads' fc1 and fc2."""
    *_, layer, leaf = ["", *param_name.split(".")]
    return leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2"))


def fv_feeds_train_bn(param_name: str) -> bool:
    """3DmFV-Net's biases before a training BatchNorm: every convolution's
    (``Conv_0``) and fc1-fc3's."""
    *_, layer, leaf = ["", *param_name.split(".")]
    return leaf == "bias" and layer in ("Conv_0", "fc1", "fc2", "fc3")


def fps_plain_entry(xyz, npoint, with_coords=True):
    """``fps_plain`` behind the signature of the ``fps`` wrapper."""
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain

    idx, new_xyz = fps_plain(xyz, npoint)
    return (idx, new_xyz) if with_coords else idx


def ball_query_plain_entry(radius, nsample, xyz, new_xyz):
    """``ball_query_plain`` behind the signature of the ``query_ball_point``
    wrapper (int32 outputs)."""
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import ball_query_plain

    idx, cnt = ball_query_plain(radius, nsample, xyz, new_xyz)
    return idx.int(), cnt.int()


def kernel_sites():
    """(module, name, plain version) of every kernel's wrapper, at the names
    the model paths call it by."""
    from scanobjectnn_torch.models import dgcnn, spidercnn
    from scanobjectnn_torch.nn import pointnet_modules, xconv
    from scanobjectnn_torch.ops import exactpool, satrain
    from scanobjectnn_torch.ops import fps as ops_fps
    from scanobjectnn_torch.ops.cuda import (
        ballgroup_kernel, dupmask_kernel, edge_kernel, gather_kernel, knn_kernel, poolkey_kernel, sabucket_kernel,
        safused_kernel, samlp_kernel, satrain_kernel, spider_kernel,
    )

    return (
        (ops_fps, "fps", fps_plain_entry),
        (pointnet_modules, "sa_ball_mlp_pool", safused_kernel.sa_ball_mlp_pool_plain),
        (pointnet_modules, "sa_ball_mlp_pool_bucketed", sabucket_kernel.sa_ball_mlp_pool_bucketed_plain),
        (pointnet_modules, "sa_mlp_pool", samlp_kernel.sa_mlp_pool_plain),
        (ballgroup_kernel, "query_ball_group", ballgroup_kernel.query_ball_group_plain),
        (ballgroup_kernel, "query_ball_point", ball_query_plain_entry),
        (gather_kernel, "gather_rows", gather_kernel.gather_rows_plain),
        (gather_kernel, "scatter_add_rows", gather_kernel.scatter_add_rows_plain),
        (knn_kernel, "knn_point_kernel", knn_kernel.knn_point_plain),
        (knn_kernel, "knn_graph_kernel", knn_kernel.knn_graph_plain),
        (dgcnn, "edge_reduce", edge_kernel.edge_reduce_plain),
        (dgcnn, "edge_gather_knn", edge_kernel.edge_gather_knn_plain),
        (spidercnn, "edge_gather_knn", edge_kernel.edge_gather_knn_plain),
        (spidercnn, "spider_conv", spider_kernel.spider_conv_plain),
        (xconv, "duplicate_mask_kernel", dupmask_kernel.duplicate_mask_plain),
        (xconv, "knn_point_kernel", knn_kernel.knn_point_plain),
        (exactpool, "bn_relu_exactkey_pool", poolkey_kernel.bn_relu_exactkey_pool_plain),
        (satrain, "grouped_bn_mlp_pool_bwd", satrain_kernel.grouped_bn_mlp_pool_bwd_plain),
    )


def plain_path():
    """Patches that swap every kernel's wrapper for its plain version, at
    the names the model paths call them by."""
    stack = contextlib.ExitStack()
    for module, name, plain in kernel_sites():
        stack.enter_context(mock.patch.object(module, name, plain))
    return stack


class _Recorded:
    """A kernel's wrapper that appends (name, wrapper, plain version, args,
    kwargs) to ``calls``, its tensors cloned, before it runs.  Attributes
    read and written go to the wrapper, so its launch counts, which it
    keeps through its own module-level name, stay its own."""

    def __init__(self, name, wrapper, plain, calls: list):
        object.__setattr__(self, "spec", (name, wrapper, plain, calls))

    def __call__(self, *args, **kw):
        import torch

        name, wrapper, plain, calls = self.spec

        def copy(value):
            return value.detach().clone() if isinstance(value, torch.Tensor) else value

        calls.append((name, wrapper, plain, tuple(copy(a) for a in args), {k: copy(v) for k, v in kw.items()}))
        return wrapper(*args, **kw)

    def __getattr__(self, attr):
        return getattr(self.spec[1], attr)

    def __setattr__(self, attr, value):
        setattr(self.spec[1], attr, value)


def recording(calls: list):
    """Patches that make every kernel's wrapper, at the names the model
    paths call it by, record its calls into ``calls`` (``_Recorded``)."""
    stack = contextlib.ExitStack()
    for module, name, plain in kernel_sites():
        stack.enter_context(mock.patch.object(module, name, _Recorded(name, getattr(module, name), plain, calls)))
    return stack


# Every main path's launches together, by counter (``counted_run``).  A
# wrapper's sub-count is split off under its own name: FPS's into "fps"
# (with coordinates) and "fps_indices" (indices only), the fused SA layer's
# into "sa_ball_mlp_pool" (K <= 64) and "sa_ball_mlp_pool_chunked" (K > 64),
# the kNN's into "knn_point_kernel" (k <= 64) and "knn_point_kernel_sorted".
LAUNCHES: dict[str, int] = {}
SUBCOUNTS = {"index_launches": "_indices", "chunked_launches": "_chunked", "sort_launches": "_sorted"}
# Launches that took a route a wrapper counts apart and that stay in its
# total: FPS above 8192 points ("fps.large_launches"), the graph through
# the general kNN ("knn_graph_kernel.routed_launches"), the kNN at k <= 64
# through the warp lists ("knn_point_kernel.warp_launches"), above k = 64
# over merged tiles ("knn_point_kernel.tiled_launches") and through the full
# sort ("knn_point_kernel.fullsort_launches"), the EdgeConv backward's
# per-edge kernel ("edge_reduce_bwd_kernel.routed_launches"), the T-Net's
# gather above k = 32 through the graph and the gather kernel
# ("edge_gather_knn.routed_launches") and at k <= 32 through the one fused
# kernel ("edge_gather_knn.fused_launches"), by "counter.attribute".
ROUTES = ("large_launches", "routed_launches", "tiled_launches", "warp_launches", "fullsort_launches",
          "fused_launches")
LAUNCH_ROUTES: dict[str, int] = {}


def counted_run(counters, fn):
    """``fn()`` with every counter set to 0 just before and read just after:
    (its result, {kernel: launches}).  Adds the counts to ``LAUNCHES``."""
    import torch

    for c in counters:
        c.launches = 0
        for attr in (*SUBCOUNTS, *ROUTES):
            if hasattr(c, attr):
                setattr(c, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {c.__name__: c.launches for c in counters}
    for c in counters:
        for attr in ROUTES:
            if hasattr(c, attr):
                key = f"{c.__name__}.{attr}"
                LAUNCH_ROUTES[key] = LAUNCH_ROUTES.get(key, 0) + getattr(c, attr)
    split = dict(counts)
    for c in counters:
        for attr, suffix in SUBCOUNTS.items():
            if hasattr(c, attr):
                split[c.__name__] -= getattr(c, attr)
                split[c.__name__ + suffix] = getattr(c, attr)
    for k, v in split.items():
        LAUNCHES[k] = LAUNCHES.get(k, 0) + v
    return out, counts


def compare_steps(trainer, batch, n_zero: int, label: str, loss_rtol: float = TRAIN_LOSS_RTOL,
                  grad_tol: float = TRAIN_GRAD_TOL, zero_tol: float | None = ZERO_GRAD_TOL, against=None) -> None:
    """One step on the kernel path and one on the plain path, from the same
    weights, batch and generator state: the loss (within ``loss_rtol``),
    every gradient and the BN running stats (within ``grad_tol`` x max(1,
    |ref|max)); the ``n_zero`` Dense biases before a training BN within
    ``zero_tol`` of 0 on both paths (None: held as the other gradients).
    ``against``: instead of the plain path, another trainer's step on the
    kernel path."""
    import torch

    from scanobjectnn_torch.ops.cuda import (
        dupmask_kernel, edge_kernel, fps_kernel, gather_kernel, knn_kernel, poolkey_kernel, satrain_kernel,
        spider_kernel,
    )
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group

    counters = (fps_kernel.fps, query_ball_group, gather_kernel.gather_rows, gather_kernel.scatter_add_rows,
                knn_kernel.knn_point_kernel, knn_kernel.knn_graph_kernel, edge_kernel.edge_reduce_fwd_kernel,
                edge_kernel.edge_reduce_bwd_kernel, edge_kernel.edge_gather_knn,
                spider_kernel.spider_conv_fwd_kernel, spider_kernel.spider_conv_bwd_kernel,
                dupmask_kernel.duplicate_mask_kernel, poolkey_kernel.bn_relu_exactkey_pool,
                satrain_kernel.grouped_bn_mlp_pool_bwd)
    steps = {}
    for path in ("kernel", "plain"):
        s = (against if path == "plain" and against is not None else trainer).init_state(seed=1)
        before = [fn.launches for fn in counters]
        if path == "plain" and against is not None:
            s, metrics = against.train_step(s, batch)
        elif path == "plain":
            with plain_path():
                s, metrics = trainer.train_step(s, batch)
            torch.cuda.synchronize()
            require([fn.launches for fn in counters] == before, f"the plain training path launched a kernel ({label})")
        else:
            s, metrics = trainer.train_step(s, batch)
        steps[path] = (float(metrics["loss"]), {n: p.grad.float() for n, p in s.model.named_parameters()},
                       dict(s.model.named_buffers()))
    (loss_k, grads_k, stats_k), (loss_p, grads_p, stats_p) = steps["kernel"], steps["plain"]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    biases = [n for n in grads_p if feeds_train_bn(n)]
    require(len(biases) == n_zero, f"expected the {n_zero} Dense biases that feed a BN, found {biases}")
    zero = biases if zero_tol is not None else []
    grad_err, worst = max(
        (float((grads_k[n] - grads_p[n]).abs().max()) / scale_of(grads_p[n]), n) for n in grads_p if n not in zero
    )
    zero_max = max((float(g[n].abs().max()) for g in (grads_k, grads_p) for n in biases), default=0.0)
    stat_err = max(float((stats_k[n] - stats_p[n]).abs().max()) / scale_of(stats_p[n]) for n in stats_p)
    other = "the unfused step" if against is not None else "plain path"
    print(f"train step {label}, kernel path against {other}: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(rel err {loss_err:.3e}, bound {loss_rtol}); largest error / scale: gradients {grad_err:.3e} "
          f"({worst}), BN stats {stat_err:.3e} (bound {grad_tol}); the {n_zero} Dense biases before a BN: "
          f"max |grad| {zero_max:.3e} on either path (bound {zero_tol if zero else 'none: held as the rest'})")
    require(loss_err <= loss_rtol, f"training loss differs from the {other} ({label})")
    require(grad_err <= grad_tol and stat_err <= grad_tol,
            f"training gradients or BN stats differ from the {other} ({label})")
    require(not zero or zero_max <= zero_tol, f"a Dense bias before a BN has a gradient far from 0 ({label})")


def bf16_steps(name: str, batches, dev, smi: str, counters, n_zero: int, label: str,
               loss_rtol: float = TRAIN_LOSS_RTOL, gate=None, **config) -> None:
    """bf16 training of ``name`` (``TrainerConfig(dtype="bfloat16", **config)``;
    the families without SA layers, whose pool mode reaches no layer): two
    equal steps on the kernel path, the first counting ``counters``'
    launches (each must launch), one step against the plain path
    (``compare_steps``: the loss within ``loss_rtol``, every gradient and
    BN stat within BF16_STEP_GRAD_TOL x max(1, |ref|max), the ``n_zero`` Dense biases
    before a BN held as the rest; ``gate(trainer, batch, label)`` in its
    place where given), the two equal steps equal bit for bit in the
    loss, every gradient and every BN statistic (fixed summation orders in
    every backward kernel), and the step timed beside the f32 step of the
    same config (``time_trainers``: bf16, f32, f32, bf16)."""
    import torch

    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(model=name, dtype="bfloat16", device=str(dev), **config))
    require(trainer.dtype == torch.bfloat16, f"{label}: not a bf16 trainer")
    cudnn = torch.backends.cudnn
    flags = (cudnn.allow_tf32, cudnn.deterministic)
    runs = []
    for i in range(2):
        state = trainer.init_state(seed=1)
        if i == 0:
            (state, metrics), counts = counted_run(counters, lambda: trainer.train_step(state, batches[1]))
        else:
            state, metrics = trainer.train_step(state, batches[1])
        runs.append((metrics["loss"].detach().clone(), {n: p.grad.clone() for n, p in state.model.named_parameters()},
                     {n: b.clone() for n, b in state.model.named_buffers()}))
    loss = float(runs[0][0])
    print(f"{label} bf16 training main path: loss {loss:.6f}, launches {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel of the {label} bf16 training path never launched: {counts}")
    require(math.isfinite(loss), f"non-finite {label} bf16 training loss: {loss}")
    if gate is None:
        compare_steps(trainer, batches[1], n_zero, f"{label} bf16", loss_rtol=loss_rtol,
                      grad_tol=BF16_STEP_GRAD_TOL, zero_tol=None)
    else:
        gate(trainer, batches[1], f"{label} bf16")
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = runs
    differing = (["loss"] if not torch.equal(loss_a, loss_b) else []) + [
        n for n in grads_a if not torch.equal(grads_a[n], grads_b[n])] + [
        n for n in stats_a if not torch.equal(stats_a[n], stats_b[n])]
    print(f"{label} bf16: two equal steps: the loss, {len(grads_a)} gradients and {len(stats_a)} BN statistics "
          + ("equal bit for bit" if not differing else f"DIFFER ({len(differing)}, e.g. {differing[:3]})")
          + f"; cuDNN allow_tf32, deterministic {flags} before and {(cudnn.allow_tf32, cudnn.deterministic)} after")
    require(not differing, f"{label}: two equal bf16 steps differ in {differing}")
    require((cudnn.allow_tf32, cudnn.deterministic) == flags, f"{label}: the cuDNN flags changed")
    f32 = Trainer(TrainerConfig(model=name, device=str(dev), **config))
    time_trainers({"bf16": trainer, "f32": f32}, batches, smi, label, n=1)


def spider_conv_f64(feat, idx, g, kernel):
    """The SpiderConv contraction with its product summed in float64 and
    rounded to f32: ``spider_conv_plain`` but for the last bits."""
    import torch

    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows_plain

    b, n, k = idx.shape
    c, t = feat.shape[-1], g.shape[-1]
    grouped = gather_rows_plain(feat.float(), idx.reshape(b, n * k)).reshape(b, n, k, c)
    prod = (grouped[..., :, None] * g.float()[..., None, :]).reshape(b, n, k * c * t)
    return torch.matmul(prod.double(), kernel.double()).float()


def spider_bf16_gate(trainer, batch, label: str) -> None:
    """The bf16 SpiderCNN step on the kernel path against the plain path
    (SPIDER_BF16_LOSS_RTOL's comment): the loss within
    SPIDER_BF16_LOSS_RTOL; each gradient and BN stat within the larger of
    BF16_STEP_GRAD_TOL x max(1, |ref|max) and BF16_TENSOR_RATIO times the
    distance of the plain step taken with ``spider_conv_f64`` from the plain
    step, from the same weights, batch and draws."""
    import torch

    from scanobjectnn_torch.models import spidercnn

    steps = {}
    for path in ("kernel", "plain", "plain, the contraction in float64"):
        s = trainer.init_state(seed=1)
        with contextlib.ExitStack() as stack:
            if path != "kernel":
                stack.enter_context(plain_path())
            if path.endswith("float64"):
                stack.enter_context(mock.patch.object(spidercnn, "spider_conv", spider_conv_f64))
            s, metrics = trainer.train_step(s, batch)
        steps[path] = {"loss": metrics["loss"].detach().float().reshape(1),
                       **{n: p.grad.float() for n, p in s.model.named_parameters()},
                       **{n: b.float() for n, b in s.model.named_buffers()}}
    kernel, plain, moved = steps.values()
    loss_err = float((kernel["loss"] - plain["loss"]).abs() / plain["loss"].abs())
    readings = []
    for n, ref in plain.items():
        if n == "loss":
            continue
        scale = scale_of(ref)
        err, own = float((kernel[n] - ref).abs().max()), float((moved[n] - ref).abs().max())
        readings.append((err / max(BF16_STEP_GRAD_TOL * scale, BF16_TENSOR_RATIO * own), n, err / scale, own / scale))
    readings.sort(reverse=True)
    beyond = sum(r[2] > BF16_STEP_GRAD_TOL for r in readings)
    print(f"train step {label}, kernel path against plain path: loss rel err {loss_err:.3e} (bound "
          f"{SPIDER_BF16_LOSS_RTOL}); largest error / bound {readings[0][0]:.3f} ({readings[0][1]}: error / scale "
          f"{readings[0][2]:.3e}, the float64 contraction's {readings[0][3]:.3e}); {beyond} of {len(readings)} "
          f"tensors beyond {BF16_STEP_GRAD_TOL} of their scale; the float64 contraction moves the plain step's "
          f"loss by {float((moved['loss'] - plain['loss']).abs() / plain['loss'].abs()):.3e} and its tensors by up "
          f"to {max(r[3] for r in readings):.3e} of their scale")
    require(loss_err <= SPIDER_BF16_LOSS_RTOL, f"training loss differs from the plain path ({label})")
    require(readings[0][0] <= 1.0, f"training gradients or BN stats differ from the plain path ({label})")


def eval_models(name: str, stats_rng, **overrides) -> dict:
    """``name`` in f32 and bf16 from ``get_model`` (seed 0, on the card,
    with ``overrides``), in eval mode, with random positive BN running stats
    drawn from ``stats_rng`` (the same in both), so the BNs matter."""
    import numpy as np
    import torch

    from scanobjectnn_torch.models import get_model

    models = {n: get_model(name, generator=torch.Generator().manual_seed(0), dtype=dtype, **overrides).eval()
              for n, dtype in (("f32", None), ("bf16", torch.bfloat16))}
    with torch.no_grad():
        for key, buf in models["f32"].named_buffers():
            vals = stats_rng.randn(*buf.shape)
            stat = torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals))
            for m in models.values():
                dict(m.named_buffers())[key].copy_(stat)
    return models


def check_inference(models: dict, x, counters, smi: str, label: str, bf16_share: float = BF16_MAX_DIFFERING) -> None:
    """Run ``models`` ({"f32", "bf16"}) on ``x`` counting the ``counters``'
    launches (each must launch), then on the plain path (none may launch),
    and hold ``logits`` (and ``seg_logits``) to the plain path's: f32 within
    F32_LOGIT_TOL x max(1, |ref|max), bf16 by the bf16 rule (at most
    ``bf16_share`` of the elements differing), the predicted classes (and
    points) agreeing.  Times the forward on both paths."""
    import torch

    b, n, _ = x.shape
    with torch.no_grad():
        outputs, counts = counted_run(counters, lambda: {name: m(x) for name, m in models.items()})
        print(f"{label} inference main path launches: {counts}")
        require(all(c > 0 for c in counts.values()), f"a kernel of the {label} inference path never launched: {counts}")
        before = [c.launches for c in counters]
        with plain_path():
            ref = {name: m(x) for name, m in models.items()}
            plain_ms = {name: cuda_ms(lambda: m(x), iters=3) for name, m in models.items()}
        require([c.launches for c in counters] == before, f"the plain {label} path launched a kernel")
    for name in models:
        for key in ("logits", "seg_logits"):
            if key not in ref[name]:
                continue
            got, want = outputs[name][key], ref[name][key]
            shape = (b, NUM_CLASSES) if key == "logits" else (b, n, 2)
            require(tuple(got.shape) == shape and bool(torch.isfinite(got.float()).all()), f"{label} {key} ({name})")
            require(float(want.float().abs().max()) > 0.1, f"{label} {key} vanished ({name})")
            if name == "bf16":
                check_bf16(got, want, BF16_LOGIT_ULPS, f"{label} bf16: {key}", bf16_share)
            else:
                err, tol = float((got - want).abs().max()), F32_LOGIT_TOL * scale_of(want)
                print(f"{label} f32: {key} max abs err {err:.3e} (bound {tol:.3e})")
                require(err <= tol, f"{label} f32 {key} differs from the plain path: {err} > {tol}")
            agree = float((got.float().argmax(-1) == want.float().argmax(-1)).float().mean())
            need = SEG_AGREEMENT if key == "seg_logits" else (1.0 if name == "f32" else BF16_CLASS_AGREEMENT)
            print(f"{label} {name}: {key} argmax agreement {agree:.4f} (bound {need})")
            require(agree >= need, f"{label} {name} {key} agreement {agree}")
    with torch.no_grad():
        for name, m in models.items():
            ms = cuda_ms(lambda: m(x))
            print(f"time forward {label} {name} B={b} N={n}: kernel path {ms:.4f} ms "
                  f"({b / ms * 1e3:.1f} clouds/s), plain path {plain_ms[name]:.4f} ms ({smi})")


def time_steps(trainer, state, batches, smi: str, label: str, n: int = 3) -> None:
    """Step time, host clock around ``n`` steps that end in a synchronize,
    in turns: kernel, plain, plain, kernel."""
    import torch

    def step_ms(path: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches[:n]:
            if path == "plain":
                with plain_path():
                    trainer.train_step(state, batch)
            else:
                trainer.train_step(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    times = {"kernel": [], "plain": []}
    for path in ("kernel", "plain", "plain", "kernel"):
        times[path].append(step_ms(path))
    for path, ms in times.items():
        print(f"time train step {label} {path} path: {sum(ms) / len(ms):.4f} ms "
              f"(rounds {', '.join(f'{v:.4f}' for v in ms)}) ({smi})")


def train_phase(smi: str, dev) -> dict:
    """Phase 4 (module doc).  Returns, per training kernel, its max abs
    error against its plain version, kernel, plain and library ms and its
    bound, summed over the calls one training step makes."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group, query_ball_group_plain
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.gather_kernel import (
        count_sort_kernel, gather_rows, gather_rows_plain, scatter_add_rows, scatter_add_rows_plain,
    )
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    names = ("fps_indices", "query_ball_group", "gather_rows", "scatter_add_rows")
    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None} for k in names}
    work = {k: Work() for k in names}

    def record(kname, label, fn, plain_fn, in_step=True, plain_iters=10):
        """Time the kernel and its plain version: device time (kept) and CUDA
        events around back-to-back calls (host launch cost included)."""
        ms, plain_ms = device_ms(fn), device_ms(plain_fn, iters=plain_iters)
        print(f"time {kname} {label}: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; CUDA events per call "
              f"kernel {cuda_ms(fn):.4f} ms, plain {cuda_ms(plain_fn, iters=plain_iters):.4f} ms ({smi})")
        if in_step:
            out[kname]["ms"] += ms
            out[kname]["plain_ms"] += plain_ms

    data, labels = make_synthetic_dataset(
        num_per_class=8, num_classes=NUM_CLASSES, num_points=2 * TRAIN_POINT, seed=0
    )
    sampler = EpochSampler(data, labels, num_points=TRAIN_POINT, seed=0)
    batches = list(Batches(sampler.epoch(), TRAIN_BATCH))
    require(len(batches) >= 2 * TRAIN_STEPS, f"only {len(batches)} training batches")

    # 4a. The training kernels against their plain versions, at the step's shapes.
    x = torch.from_numpy(batches[0]["points"]).to(dev)
    _, x1 = fps_plain(x, 512)
    _, x2 = fps_plain(x1, 128)
    for xyz, npoint, label in ((x, 512, f"B={TRAIN_BATCH} 1024->512"), (x1, 128, f"B={TRAIN_BATCH} 512->128")):
        require(torch.equal(fps(xyz, npoint, with_coords=False), fps_plain(xyz, npoint)[0]),
                f"FPS indices-only differ from fps_plain ({label})")
        record("fps_indices", label, lambda: fps(xyz, npoint, with_coords=False),
               lambda: fps_plain(xyz, npoint), plain_iters=3)
        print_fps_step(label, cuda_ms(lambda: fps(xyz, npoint, with_coords=False)), npoint, smi)
        fps_work(work["fps_indices"], *xyz.shape[:2], npoint, with_coords=False)
    g = torch.Generator().manual_seed(3)
    lattice = torch.randint(-3, 4, (TRAIN_BATCH, 128, 3), generator=g).float() * 0.25
    dup = lattice.repeat(1, 8, 1)[:, torch.randperm(TRAIN_POINT, generator=g)].contiguous().to(dev)
    far = x1.clone()
    far[:, ::2] += 100.0
    sa2_idx = None
    for label, (radius, k, xyz, q), in_step in (
        (f"SA1 B={TRAIN_BATCH} N1024 M512 K32 r0.2", (0.2, 32, x, x1), True),
        (f"SA2 B={TRAIN_BATCH} N512 M128 K64 r0.4", (0.4, 64, x1, x2), True),
        ("empty balls (half the queries moved away)", (0.2, 32, x, far), False),
        ("duplicated lattice points", (0.3, 32, dup, fps_plain(dup, 512)[1]), False),
    ):
        got = query_ball_group(radius, k, xyz, q)
        want = query_ball_group_plain(radius, k, xyz, q)
        torch.cuda.synchronize()
        for what, a, b in zip(("grouped", "idx", "cnt"), got, want):
            require(a.dtype == b.dtype and torch.equal(a, b), f"ball group {what} differs from the plain version ({label})")
        if "empty" in label:
            require(bool((got[2][:, ::2] == 0).all()), "the moved queries found hits")
        print(f"ball group {label}: grouped, idx and cnt equal to the plain version "
              f"(mean cnt {float(got[2].float().mean()):.2f})")
        record("query_ball_group", label, lambda: query_ball_group(radius, k, xyz, q),
               lambda: query_ball_group_plain(radius, k, xyz, q), in_step)
        if in_step:
            b, m = q.shape[0], q.shape[1]
            work["query_ball_group"].add(9.0 * scanned_points(radius, k, xyz, q),
                                         12 * (xyz.shape[0] * xyz.shape[1] + b * m) + b * m * (16 * k + 4))
        if label.startswith("SA2"):
            sa2_idx = got[1].reshape(TRAIN_BATCH, -1)

    rng = np.random.RandomState(4)
    vals = torch.from_numpy(rng.randn(TRAIN_BATCH, 512, 128).astype(np.float32)).to(dev)
    upd = torch.from_numpy(rng.randn(TRAIN_BATCH, sa2_idx.shape[1], 128).astype(np.float32)).to(dev)
    b, r, c = upd.shape
    require(torch.equal(gather_rows(vals, sa2_idx), gather_rows_plain(vals, sa2_idx)),
            "gather differs from the plain version")
    shapes = f"[{TRAIN_BATCH},512,128] by [{TRAIN_BATCH},{r}]"
    print(f"gather SA2 {shapes}: equal to the plain version")
    record("gather_rows", f"SA2 {shapes}", lambda: gather_rows(vals, sa2_idx),
           lambda: gather_rows_plain(vals, sa2_idx))
    # The one PyTorch call that computes the same gather (timed here only).
    expanded = sa2_idx.long()[..., None].expand(b, r, c)
    out["gather_rows"]["library_ms"] = device_ms(lambda: torch.gather(vals, 1, expanded))
    work["gather_rows"].add(0.0, vals.numel() * 4 + 4 * b * r + 4 * b * r * c)
    got, again = scatter_add_rows(sa2_idx, upd, 512), scatter_add_rows(sa2_idx, upd, 512)
    want = scatter_add_rows_plain(sa2_idx, upd, 512)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "the scatter-add kernel is not bit-stable")
    err, tol = float((got - want).abs().max()), SCATTER_TOL * scale_of(want)
    print(f"scatter-add SA2 {shapes}: identical bits on two calls, "
          f"max abs err {err:.3e} against index_add_ (bound {tol:.3e})")
    require(err <= tol, f"scatter-add differs from index_add_: {err} > {tol}")
    require(torch.equal(got.cpu(), scatter_add_rows_plain(sa2_idx.cpu(), upd.cpu(), 512)),
            "scatter-add differs from the CPU's index-order sum")
    print(f"scatter-add SA2 {shapes}: equal bit for bit to the CPU's sequential index_add_")
    out["scatter_add_rows"]["max_abs_err"] = err
    record("scatter_add_rows", f"SA2 {shapes}", lambda: scatter_add_rows(sa2_idx, upd, 512),
           lambda: scatter_add_rows_plain(sa2_idx, upd, 512))
    most = max(int(torch.bincount(sa2_idx[i].long(), minlength=512).max()) for i in range(b))
    print(f"scatter-add SA2 {shapes}: its counting sort alone {device_ms(lambda: count_sort_kernel(sa2_idx, 512)):.4f} "
          f"ms (device time); at most {most} rows aimed at one point (the ball query pads with its first hit), "
          f"summed in one chain ({smi})")
    flat = (sa2_idx.long() + 512 * torch.arange(b, device=dev)[:, None]).reshape(-1)
    target, rows = torch.zeros(b * 512, c, device=dev), upd.reshape(b * r, c)
    out["scatter_add_rows"]["library_ms"] = device_ms(lambda: target.index_add_(0, flat, rows))
    work["scatter_add_rows"].add(float(b * r * c), 4 * b * r + 4 * b * r * c + 4 * b * 512 * c)
    # #7 at SpiderCNN's three dfeat calls (B=32, k=20: R = 20480 rows onto
    # n = 1024 points, C = 32, 64, 128), beside index_add_ (not in the record).
    sb, sn, sk = SPIDER_BATCH, SPIDER_POINT, SPIDER_K
    s_idx = torch.from_numpy(rng.randint(0, sn, (sb, sn * sk)).astype(np.int32)).to(dev)
    s_flat = (s_idx.long() + sn * torch.arange(sb, device=dev)[:, None]).reshape(-1)
    for sc in (32, 64, 128):
        s_upd = torch.from_numpy(rng.randn(sb, sn * sk, sc).astype(np.float32)).to(dev)
        got = scatter_add_rows(s_idx, s_upd, sn)
        require(torch.equal(got.cpu(), scatter_add_rows_plain(s_idx.cpu(), s_upd.cpu(), sn)),
                f"scatter-add differs from the CPU's index-order sum (SpiderCNN dfeat, C={sc})")
        s_target, s_rows = torch.zeros(sb * sn, sc, device=dev), s_upd.reshape(-1, sc)
        ms, lib = device_ms(lambda: scatter_add_rows(s_idx, s_upd, sn)), device_ms(
            lambda: s_target.index_add_(0, s_flat, s_rows))
        nbytes = 4 * sb * sn * sk * (1 + sc) + 4 * sb * sn * sc
        print(f"time scatter_add_rows SpiderCNN dfeat [{sb},{sn * sk},{sc}] -> {sn} points: device kernel "
              f"{ms:.4f} ms, index_add_ {lib:.4f} ms, byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; equal bit "
              f"for bit to the CPU's index-order sum ({smi})")
        del s_upd, s_rows, s_target
    for k in names:
        out[k].update(work[k].record())

    # 4b. The main path: Trainer(get_model) -> train_step, counting launches.
    trainer = Trainer(TrainerConfig(batch_size=TRAIN_BATCH, device=str(dev)))
    state = trainer.init_state(seed=0)

    def steps():
        return [float(trainer.train_step(state, batch)[1]["loss"]) for batch in batches[:TRAIN_STEPS]]

    losses, launches = counted_run((fps, query_ball_group, gather_rows, scatter_add_rows), steps)
    print(f"training main path: {TRAIN_STEPS} steps, losses {[round(v, 6) for v in losses]}, launches {launches}")
    require(all(n > 0 for n in launches.values()), f"a training kernel never launched: {launches}")
    require(all(math.isfinite(v) for v in losses), f"non-finite training loss: {losses}")

    # 4c. One step on the kernel path and on the plain path.
    compare_steps(trainer, batches[TRAIN_STEPS], 11, f"SSG B={TRAIN_BATCH}")
    # 4d. Step time.
    time_steps(trainer, state, batches, smi, f"SSG B={TRAIN_BATCH} N={TRAIN_POINT} f32")
    return out


def seg_phase(smi: str, dev) -> dict:
    """Phase 5 (module doc).  Returns the kNN kernel's record (max abs
    error, and kernel, plain and bound ms summed over the three FP calls of
    one f32 BGA forward at B=32)."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel, knn_point_plain
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    data, labels, masks, parts = make_synthetic_dataset(
        num_per_class=5, num_classes=NUM_CLASSES, num_points=2 * SEG_POINT, seed=1, with_mask=True, with_parts=True
    )
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), parts=parts,
                        num_points=SEG_POINT, seed=0).epoch()
    knn = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
    knn_bound = Work()

    # 5a. The kNN kernel against its plain version: the FP decoder's shapes
    # on the levels FPS gives (l3 is the group-all centroid at the origin).
    x = torch.from_numpy(view["points"][:SEG_BATCH]).to(dev)
    levels = [x, fps_plain(x, 512)[1]]
    levels += [fps_plain(levels[1], 128)[1], torch.zeros(SEG_BATCH, 1, 3, device=dev)]
    g = torch.Generator().manual_seed(5)
    lattice = torch.randint(-3, 4, (SEG_TRAIN_BATCH, 128, 3), generator=g).float() * 0.25
    dup = lattice.repeat(1, 8, 1)[:, torch.randperm(SEG_POINT, generator=g)].contiguous().to(dev)
    rng = np.random.RandomState(6)
    bias = torch.from_numpy((0.1 * rng.rand(SEG_TRAIN_BATCH, SEG_POINT)).astype(np.float32)).to(dev)
    wide = [torch.from_numpy(rng.randn(SEG_TRAIN_BATCH, n, 64).astype(np.float32)).to(dev) for n in (512, 1024)]
    cases = [
        (f"fp{i + 1} B={b} M{levels[fine].shape[1]} N{levels[fine + 1].shape[1]} k3",
         (levels[fine][:b].contiguous(), levels[fine + 1][:b].contiguous(), 3, None), b == SEG_BATCH)
        for b in (SEG_BATCH, SEG_TRAIN_BATCH) for i, fine in enumerate((2, 1, 0))
    ] + [
        ("duplicated lattice points, M1024 N512 k3", (dup, fps_plain(dup, 512)[1], 3, None), False),
        (f"k16 with a bias, B={SEG_TRAIN_BATCH} M1024 N1024", (levels[0][:SEG_TRAIN_BATCH].contiguous(),
                                                             levels[0][:SEG_TRAIN_BATCH].contiguous(), 16, bias), False),
        (f"C=64, B={SEG_TRAIN_BATCH} M512 N1024 k16", (wide[0], wide[1], 16, None), False),
    ]
    for label, args, in_forward in cases:
        d, i = knn_point_kernel(*args)
        ref_d, ref_i = knn_point_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(i, ref_i) and torch.equal(d, ref_d), f"kNN differs from its plain version ({label})")
        diff = torch.where(torch.isfinite(ref_d), (d - ref_d).abs(), 0.0)
        knn["max_abs_err"] = max(knn["max_abs_err"], float(diff.max()))
        if "fp1" in label:
            require(bool(torch.isinf(d[..., 1:]).all()) and bool((i[..., 1:] == 0).all()), "fp1 padding")
        ms, plain_ms = device_ms(lambda: knn_point_kernel(*args)), device_ms(lambda: knn_point_plain(*args), iters=3)
        print(f"knn {label}: idx and d2 equal to the plain version; time device kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms ({smi})")
        if in_forward:
            knn["ms"] += ms
            knn["plain_ms"] += plain_ms
            knn_work(knn_bound, args[0], args[1], args[2], args[3] is not None)
    knn.update(knn_bound.record())

    # 5b. BGA inference at B=32, f32 and bf16, from get_model (on the card).
    models = eval_models("pointnet2_cls_bga", np.random.RandomState(7))
    with torch.no_grad():
        for name, m in models.items():
            dtype = torch.float32 if name == "f32" else torch.bfloat16
            w1, b1 = m.sa1.mlp.folded()
            check_sa((0.2, 64, x, levels[1], None, w1, b1), dtype, f"BGA SA1 {name} B={SEG_BATCH} K64",
                     sa_ball_mlp_pool, sa_ball_mlp_pool_plain)
    check_inference(models, x, (fps, sa_ball_mlp_pool, knn_point_kernel, gather_rows), smi, "BGA")

    # 5c. BGA training, f32, B=16.
    batches = list(Batches(view, SEG_TRAIN_BATCH))
    trainer = Trainer(TrainerConfig(model="pointnet2_cls_bga", batch_size=SEG_TRAIN_BATCH, device=str(dev)))
    state = trainer.init_state(seed=0)
    counters = (fps, query_ball_group, gather_rows, scatter_add_rows, knn_point_kernel)

    def steps():
        return [float(trainer.train_step(state, batch)[1]["loss"]) for batch in batches[:TRAIN_STEPS]]

    losses, counts = counted_run(counters, steps)
    print(f"BGA training main path: {TRAIN_STEPS} steps, losses {[round(v, 6) for v in losses]}, launches {counts}")
    require(all(n > 0 for n in counts.values()), f"a kernel of the BGA training path never launched: {counts}")
    require(all(math.isfinite(v) for v in losses), f"non-finite BGA training loss: {losses}")
    compare_steps(trainer, batches[TRAIN_STEPS], 19, f"BGA B={SEG_TRAIN_BATCH}")
    time_steps(trainer, state, batches, smi, f"BGA B={SEG_TRAIN_BATCH} N={SEG_POINT} f32")

    # 5d. Part segmentation, B=8: one forward and one step.
    part_batch = {k: v[:PARTSEG_BATCH] for k, v in batches[0].items()}
    trainer = Trainer(TrainerConfig(model="pointnet2_cls_partseg", batch_size=PARTSEG_BATCH, device=str(dev)))
    model = trainer.init_state(seed=0).model.eval()
    xp = torch.from_numpy(part_batch["points"]).to(dev)
    with torch.no_grad():
        got, counts = counted_run((fps, sa_ball_mlp_pool, knn_point_kernel, gather_rows), lambda: model(xp))
        with plain_path():
            want = model(xp)
    got, want = got["seg_logits"], want["seg_logits"]
    err, tol = float((got - want).abs().max()), F32_LOGIT_TOL * scale_of(want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"partseg inference B={PARTSEG_BATCH}: launches {counts}; seg_logits max abs err {err:.3e} "
          f"(bound {tol:.3e}), argmax agreement {agree:.4f}")
    require(tuple(got.shape) == (PARTSEG_BATCH, SEG_POINT, NUM_CLASSES) and bool(torch.isfinite(got).all()),
            "partseg seg_logits")
    require(all(n > 0 for n in counts.values()), f"a kernel of the partseg inference path never launched: {counts}")
    require(err <= tol and agree >= SEG_AGREEMENT, "partseg seg_logits differ from the plain path")
    _, counts = counted_run(counters, lambda: trainer.train_step(trainer.init_state(seed=2), part_batch))
    print(f"partseg training main path: launches {counts}")
    require(all(n > 0 for n in counts.values()), f"a kernel of the partseg training path never launched: {counts}")
    compare_steps(trainer, part_batch, 17, f"partseg B={PARTSEG_BATCH}")
    return knn


def graph_work(work: Work, feats, k: int) -> None:
    # The self-kNN: every (query, key) pair as in knn_work, |x|² once per
    # point; the cloud read once, the indices written.
    b, n, c = feats.shape
    work.add(b * n * n * (2 * c + 4) + 2 * c * b * n, 4 * b * n * c + 4 * b * n * k)


def graph_issue_ms(feats) -> float:
    """The self-kNN's issue bound without contraction: 2C + 4 separate f32
    instructions a (query, key) pair (C multiplies and C adds, the
    expansion, the clamp) at F32_INSTR_PER_S."""
    b, n, c = feats.shape
    return b * n * n * (2 * c + 4) / F32_INSTR_PER_S * 1e3


def dgcnn_phase(smi: str, dev) -> dict:
    """Phase 6 (module doc).  Returns, per DGCNN kernel, its max abs error
    against its plain version, kernel and plain ms and its bound, summed
    over the calls one f32 ``dgcnn`` forward (and, for the backward kernel,
    its backward) makes at B=32: five graphs, EdgeConv 1-4's reductions, the
    T-Net's gather."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import dgcnn
    from scanobjectnn_torch.ops.cuda.edge_kernel import (
        REDUCTIONS, edge_gather_knn, edge_gather_knn_plain, edge_reduce, edge_reduce_bwd_kernel,
        edge_reduce_bwd_ordered, edge_reduce_fwd_kernel, edge_reduce_plain, reduce_neighbors_plain,
    )
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel, knn_graph_plain
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    b, n, k = DGCNN_BATCH, DGCNN_POINT, DGCNN_K
    names = ("knn_graph", "edge_reduce", "edge_reduce_bwd", "edge_gather_knn")
    out = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None} for name in names}
    work = {name: Work() for name in names}

    def record(kname, label, fn, plain_fn, in_forward=True):
        ms, plain_ms = device_ms(fn), device_ms(plain_fn, iters=3)
        print(f"time {kname} {label}: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
        if in_forward:
            out[kname]["ms"] += ms
            out[kname]["plain_ms"] += plain_ms

    data, labels, masks = make_synthetic_dataset(
        num_per_class=9, num_classes=NUM_CLASSES, num_points=2 * n, seed=2, with_mask=True
    )
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), num_points=n,
                        seed=0).epoch()
    batches = list(Batches(view, b))
    require(len(batches) > TRAIN_STEPS, f"only {len(batches)} DGCNN batches")
    x = torch.from_numpy(batches[0]["points"]).to(dev)
    models = eval_models("dgcnn", np.random.RandomState(8))

    # The layer inputs of the main path: what one f32 forward hands the
    # T-Net's gather and EdgeConv 1-4's reductions.
    calls = {"gather": [], "reduce": []}

    def recorder(kind, fn):
        def call(feats, vals, kk):
            calls[kind].append((feats.detach().float().contiguous(), vals.detach().float().contiguous()))
            return fn(feats, vals, kk)
        return call

    with torch.no_grad(), mock.patch.object(dgcnn, "edge_gather_knn", recorder("gather", edge_gather_knn)), \
            mock.patch.object(dgcnn, "edge_reduce", recorder("reduce", edge_reduce)):
        models["f32"](x)
    require(len(calls["gather"]) == 1 and len(calls["reduce"]) == 4, f"DGCNN kernel calls {calls.keys()}")

    # 6a. The graph kernel: the five graphs of a forward, and duplicated points.
    g = torch.Generator().manual_seed(8)
    lattice = torch.randint(-3, 4, (b, n // 8, 3), generator=g).float() * 0.25
    wide = torch.randn(b, n // 4, 64, generator=g)
    graphs = [("T-Net C=3", calls["gather"][0][0], True)]
    graphs += [(f"EdgeConv{i + 1} C={f.shape[-1]}", f, True) for i, (f, _) in enumerate(calls["reduce"])]
    graphs += [("duplicated lattice points C=3", lattice.repeat(1, 8, 1)[:, torch.randperm(n, generator=g)], False),
               ("duplicated points C=64", wide.repeat(1, 4, 1)[:, torch.randperm(n, generator=g)], False)]
    for label, feats, in_forward in graphs:
        feats = feats.contiguous().to(dev)
        idx, want = knn_graph_kernel(feats, k), knn_graph_plain(feats, k)
        torch.cuda.synchronize()
        require(torch.equal(idx, want), f"the graph kernel differs from its plain version ({label})")
        print(f"knn_graph {label} B={b} N={n} k={k}: indices equal to the plain version")
        record("knn_graph", label, lambda: knn_graph_kernel(feats, k), lambda: knn_graph_plain(feats, k), in_forward)
        call = Work()
        graph_work(call, feats, k)
        bound = call.record()
        print(f"bound knn_graph {label}: {bound['bound_ms']:.4f} ms ({bound['bound_by']}, FMA rate), no-contraction "
              f"issue bound {graph_issue_ms(feats):.4f} ms (2C+4 f32 instructions a pair at "
              f"{F32_INSTR_PER_S / 1e12:.1f} T/s)")
        if in_forward:
            graph_work(work["knn_graph"], feats, k)

    # 6b, 6c. The reduce kernels at EdgeConv 1-4.
    cg = torch.Generator(device=dev).manual_seed(9)
    for i, (feats, vals) in enumerate(calls["reduce"]):
        cv = vals.shape[-1]
        label = f"EdgeConv{i + 1} (Cf, Cv)=({feats.shape[-1]}, {cv})"
        got, want = edge_reduce(feats, vals, k), edge_reduce_plain(feats, vals, k)
        torch.cuda.synchronize()
        for key in ("idx",) + REDUCTIONS:
            require(torch.equal(got[key], want[key]), f"edge_reduce {key} differs from the plain version ({label})")
        print(f"edge_reduce {label}: idx and the six reductions equal to the plain version")
        idx = got["idx"]
        record("edge_reduce", label, lambda: edge_reduce_fwd_kernel(vals, idx),
               lambda: reduce_neighbors_plain(vals, idx))
        work["edge_reduce"].add(7.0 * b * n * k * cv, 4 * (b * n * cv + b * n * k) + 6 * 4 * b * n * cv)

        v = vals.clone().requires_grad_()
        red = edge_reduce(feats, v, k)
        cot = [torch.randn(b, n, cv, device=dev, generator=cg) for _ in range(4)]
        diff = ("mmax", "mmin", "s", "q2")
        (grad,) = torch.autograd.grad([red[key] for key in diff], v, cot)
        saved = (vals, idx, red["mmax"], red["mmin"], red["cntmax"], red["cntmin"])
        again = edge_reduce_bwd_kernel(*saved, *cot)
        ordered = edge_reduce_bwd_ordered(*saved, *cot)
        vp = vals.clone().requires_grad_()
        plain = reduce_neighbors_plain(vp, idx)
        plain_outs = [plain[key] for key in diff]
        (ref,) = torch.autograd.grad(plain_outs, vp, cot, retain_graph=True)
        torch.cuda.synchronize()
        require(torch.equal(grad, again), f"the edge_reduce backward is not bit-stable ({label})")
        require(torch.equal(grad, ordered), f"the edge_reduce backward differs from edge_reduce_bwd_ordered ({label})")
        err, tol = float((grad - ref).abs().max()), EDGE_BWD_TOL * scale_of(ref)
        print(f"edge_reduce backward {label}: identical bits on two calls and to edge_reduce_bwd_ordered, max abs "
              f"err {err:.3e} against autograd of the plain version (bound {tol:.3e})")
        require(err <= tol, f"the edge_reduce backward differs from autograd: {err} > {tol} ({label})")
        out["edge_reduce_bwd"]["max_abs_err"] = max(out["edge_reduce_bwd"]["max_abs_err"], err)
        record("edge_reduce_bwd", label, lambda: edge_reduce_bwd_kernel(*saved, *cot),
               lambda: torch.autograd.grad(plain_outs, vp, cot, retain_graph=True))
        split = kernel_split_ms(lambda: edge_reduce_bwd_kernel(*saved, *cot), EDGE_BWD_SPLIT)
        print(f"edge_reduce backward {label}: device time the counting sort {split['sort']:.4f} ms + the sum "
              f"{split['sum']:.4f} ms; the sum moves {edge_bwd_sum_bytes(b, n, k, cv) / 1e6:.1f} MB from device "
              f"memory or L2, the per-edge kernel loaded 32 Cv bytes an edge, {32 * cv * b * n * k / 1e6:.1f} MB "
              f"({smi})")
        work["edge_reduce_bwd"].add(10.0 * b * n * k * cv, 4 * (10 * b * n * cv + b * n * k))

    # 6d. The T-Net's neighbour gather, forward and backward.
    points, c2 = calls["gather"][0]
    rows, idx = edge_gather_knn(points, c2, k)
    want, want_idx = edge_gather_knn_plain(points, c2, k)
    v = c2.clone().requires_grad_()
    cot = torch.randn(b, n, k, c2.shape[-1], device=dev, generator=cg)
    (grad,) = torch.autograd.grad(edge_gather_knn(points, v, k)[0], v, cot)
    vp = c2.clone().requires_grad_()
    (ref,) = torch.autograd.grad(edge_gather_knn_plain(points, vp, k)[0], vp, cot)
    torch.cuda.synchronize()
    require(torch.equal(idx, want_idx) and torch.equal(rows, want), "edge_gather_knn differs from its plain version")
    err, tol = float((grad - ref).abs().max()), SCATTER_TOL * scale_of(ref)
    print(f"edge_gather_knn T-Net B={b} N={n} k={k} Cv={c2.shape[-1]}: rows and idx equal to the plain version; "
          f"backward max abs err {err:.3e} (bound {tol:.3e})")
    require(err <= tol, f"the edge_gather_knn backward differs from the plain version: {err} > {tol}")
    # CUDA events: this call's device-time traces have lost kernels.
    for label, f, v, in_forward in (("T-Net", points, c2, True), ("SpiderCNN's call C=Cv=3", points, points, False)):
        gathered = edge_gather_knn(f, v, k)[0]
        require(torch.equal(gathered, edge_gather_knn_plain(f, v, k)[0]), f"edge_gather_knn differs ({label})")
        ms, plain_ms = cuda_ms(lambda: edge_gather_knn(f, v, k)), cuda_ms(lambda: edge_gather_knn_plain(f, v, k),
                                                                           iters=3)
        call = Work()
        for w in (call, work["edge_gather_knn"]) if in_forward else (call,):
            graph_work(w, f, k)
            w.add(0.0, 4 * b * n * v.shape[-1] * (1 + k))  # vals read once, the rows written
        print(f"time edge_gather_knn {label} B={b} N={n} k={k} Cv={v.shape[-1]}: kernel {ms:.4f} ms by CUDA events "
              f"(device {device_ms(lambda: edge_gather_knn(f, v, k)):.4f}), plain {plain_ms:.4f} ms, bound "
              f"{call.record()['bound_ms']:.4f} ms ({call.record()['bound_by']}) ({smi})")
        if in_forward:
            out["edge_gather_knn"]["ms"] += ms
            out["edge_gather_knn"]["plain_ms"] += plain_ms
    for name in names:
        out[name].update(work[name].record())

    # 6e. dgcnn inference from get_model, f32 and bf16.
    check_inference(models, x, (knn_graph_kernel, edge_reduce_fwd_kernel, edge_gather_knn), smi, "dgcnn")

    # 6f. dgcnn training, f32: a few steps, one against the plain path, a step timed.
    counters = (knn_graph_kernel, edge_reduce_fwd_kernel, edge_reduce_bwd_kernel, edge_gather_knn, scatter_add_rows)
    trainer = Trainer(TrainerConfig(model="dgcnn", batch_size=b, device=str(dev)))
    state = trainer.init_state(seed=0)

    def steps():
        return [float(trainer.train_step(state, batch)[1]["loss"]) for batch in batches[:TRAIN_STEPS]]

    losses, counts = counted_run(counters, steps)
    print(f"dgcnn training main path: {TRAIN_STEPS} steps, losses {[round(v, 6) for v in losses]}, launches {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel of the dgcnn training path never launched: {counts}")
    require(all(math.isfinite(v) for v in losses), f"non-finite dgcnn training loss: {losses}")
    compare_steps(trainer, batches[TRAIN_STEPS], 12, f"dgcnn B={b}")
    time_steps(trainer, state, batches, smi, f"dgcnn B={b} N={n} f32")
    bf16_steps("dgcnn", batches, dev, smi, counters, 12, f"dgcnn B={b} N={n}", batch_size=b)

    # 6g. dgcnn_bga: inference (f32, bf16) and a training step, against the plain path.
    check_inference(eval_models("dgcnn_bga", np.random.RandomState(10)), x,
                    (knn_graph_kernel, edge_reduce_fwd_kernel, edge_gather_knn), smi, "dgcnn_bga")
    trainer = Trainer(TrainerConfig(model="dgcnn_bga", batch_size=b, device=str(dev)))
    state = trainer.init_state(seed=0)
    losses, counts = counted_run(counters, lambda: [float(trainer.train_step(state, batches[0])[1]["loss"])])
    print(f"dgcnn_bga training main path: loss {losses}, launches {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel of the dgcnn_bga training path never launched: {counts}")
    require(all(math.isfinite(v) for v in losses), f"non-finite dgcnn_bga training loss: {losses}")
    compare_steps(trainer, batches[1], 14, f"dgcnn_bga B={b}")
    time_steps(trainer, state, batches, smi, f"dgcnn_bga B={b} N={n} f32", n=1)
    bf16_steps("dgcnn_bga", batches, dev, smi, counters, 14, f"dgcnn_bga B={b} N={n}", batch_size=b)
    return out


def spider_work(work: Work, feat, idx, g, kernel, backward: bool = False) -> None:
    """#16's products in f32: 2·M·(K·C·T)·O flops each (the backward makes
    two); each input read once, each output written once."""
    b, n, c = feat.shape
    k, t = idx.shape[-1], g.shape[-1]
    r, o = kernel.shape
    nbytes = 4 * (feat.numel() + idx.numel() + g.numel() + kernel.numel() + b * n * o)
    if backward:  # dout in; dfeat, dg and dkernel out
        nbytes += 4 * (b * n * c + b * n * k * t + r * o)
    work.add((2 if backward else 1) * 2.0 * b * n * r * o, nbytes)


def spider_phase(smi: str, dev) -> dict:
    """Phase 7 (module doc).  Returns, for #16's forward and backward, its
    max abs error against its plain version, kernel, plain and library ms
    and its bound, summed over the calls of one f32 ``spidercnn_cls_xyz``
    forward (and its backward) at B=32: conv1-4."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import spidercnn
    from scanobjectnn_torch.ops.cuda.edge_kernel import edge_gather_knn
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel
    from scanobjectnn_torch.ops.cuda.spider_kernel import (
        spider_bwd_data, spider_bwd_weight, spider_conv, spider_conv_bwd_kernel, spider_conv_fwd_kernel,
        spider_conv_plain,
    )
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    b, n = SPIDER_BATCH, SPIDER_POINT
    names = ("spider_conv", "spider_conv_bwd")
    out = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None} for name in names}
    out["spider_conv"]["library_ms"] = out["spider_conv_bwd"]["library_ms"] = 0.0
    halves = {"data": [0.0, 0.0, 0.0], "weight": [0.0, 0.0, 0.0]}  # kernel ms, library ms, bound ms
    work = {name: Work() for name in names}
    data, labels = make_synthetic_dataset(num_per_class=9, num_classes=NUM_CLASSES, num_points=2 * n, seed=3)
    batches = list(Batches(EpochSampler(data, labels, num_points=n, seed=0).epoch(), b))
    require(len(batches) > TRAIN_STEPS, f"only {len(batches)} SpiderCNN batches")
    x = torch.from_numpy(batches[0]["points"]).to(dev)
    models = eval_models("spidercnn_cls_xyz", np.random.RandomState(11))

    # The inputs one f32 forward hands #16: conv1-4's (feat, idx, g, kernel).
    calls = []

    def recorder(feat, idx, g, kernel):
        calls.append(tuple(t.detach().float().contiguous() for t in (feat, g, kernel)) + (idx.to(torch.int32),))
        return spider_conv(feat, idx, g, kernel)

    with torch.no_grad(), mock.patch.object(spidercnn, "spider_conv", recorder):
        models["f32"](x)
    require(len(calls) == 4, f"{len(calls)} SpiderConv calls in a forward")

    cg = torch.Generator(device=dev).manual_seed(12)
    tf32_ms = 0.0  # the bound of a 3xTF32 forward on the tensor cores, beside the f32 one recorded
    for i, (feat, g, kernel, idx) in enumerate(calls):
        c, o = feat.shape[-1], kernel.shape[-1]
        label = f"conv{i + 1} B={b} N={n} k={SPIDER_K} C={c} O={o}"
        # 7a. The forward.
        got = spider_conv_fwd_kernel(feat, idx, g, kernel)
        want = spider_conv_plain(feat, idx, g, kernel)
        torch.cuda.synchronize()
        err, tol = float((got - want).abs().max()), SPIDER_FWD_TOL * scale_of(want)
        print(f"spider_conv {label}: max abs err {err:.3e} against the plain version (bound {tol:.3e})")
        require(err <= tol, f"the SpiderConv forward differs from the plain version ({label}): {err} > {tol}")
        out["spider_conv"]["max_abs_err"] = max(out["spider_conv"]["max_abs_err"], err)
        # Calls of milliseconds: CUDA events (the profiler's device time of
        # the cuBLAS call reads shorter than its events, printed beside).
        ms = cuda_ms(lambda: spider_conv_fwd_kernel(feat, idx, g, kernel))
        plain_ms = cuda_ms(lambda: spider_conv_plain(feat, idx, g, kernel), iters=3)
        grouped = feat[torch.arange(b, device=dev)[:, None, None], idx.long()]
        prod = (grouped[..., :, None] * g[..., None, :]).reshape(b, n, -1)
        lib_ms = cuda_ms(lambda: torch.matmul(prod, kernel), iters=3)
        lib_profiled = device_ms(lambda: torch.matmul(prod, kernel), iters=3)
        if c == 128:  # conv4: both paths against a float64 product of the same f32 p and kernel
            ref64 = torch.matmul(prod.double(), kernel.double())
            err64, plain64 = float((got.double() - ref64).abs().max()), float((want.double() - ref64).abs().max())
            print(f"spider_conv {label}: max abs err against a float64 product: kernel (f32 FMA, r ascending) "
                  f"{err64:.3e}, plain path (cuBLAS f32) {plain64:.3e}")
            del ref64
        tf32_ms += 3 * 2.0 * b * n * kernel.shape[0] * o / TF32_OPS_PER_S * 1e3
        del grouped
        print(f"time spider_conv {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul of the outer "
              f"product {lib_ms:.4f} ms (profiler device time {lib_profiled:.4f} ms; TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}, {torch.get_float32_matmul_precision()}) ({smi})")
        out["spider_conv"]["ms"] += ms
        out["spider_conv"]["plain_ms"] += plain_ms
        out["spider_conv"]["library_ms"] += lib_ms
        spider_work(work["spider_conv"], feat, idx, g, kernel)

        # 7b. The backward, as a training step runs it (no dfeat at conv1).
        dout = torch.randn(b, n, o, device=dev, generator=cg)
        need_feat = i > 0
        first = spider_conv_bwd_kernel(feat, idx, g, kernel, dout, need_feat)
        again = spider_conv_bwd_kernel(feat, idx, g, kernel, dout, need_feat)
        leaves = [t.clone().requires_grad_() for t in (feat, g, kernel)]
        ref_out = spider_conv_plain(leaves[0], idx, leaves[1], leaves[2])
        ref = torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)
        torch.cuda.synchronize()
        errs = []
        for what, got_t, twice, want_t in zip(("dfeat", "dg", "dkernel"), first, again, ref):
            if got_t is None:
                continue
            require(torch.equal(got_t, twice), f"the SpiderConv backward is not bit-stable ({what}, {label})")
            err, tol = float((got_t - want_t).abs().max()), SPIDER_BWD_TOL * scale_of(want_t)
            errs.append(f"{what} {err:.3e} (bound {tol:.3e})")
            require(err <= tol, f"the SpiderConv backward differs from autograd ({what}, {label}): {err} > {tol}")
            out["spider_conv_bwd"]["max_abs_err"] = max(out["spider_conv_bwd"]["max_abs_err"], err)
        print(f"spider_conv backward {label}: identical bits on two calls; max abs err against autograd of the "
              f"plain version: {', '.join(errs)}")
        ms = cuda_ms(lambda: spider_conv_bwd_kernel(feat, idx, g, kernel, dout, need_feat))
        plain_ms = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, dout, retain_graph=True), iters=3)
        del first, again, leaves, ref_out, ref
        # Its two halves apart, each beside the one library product that
        # computes it (TF32 off): D = dout · Wᵀ, and dW = pᵀ · dout with p
        # formed outside the timed call, as the forward's library time.
        # Each is timed three times (10 calls each, CUDA events, the
        # halves and their products interleaved), and the mean is kept.
        dout2, p2 = dout.reshape(b * n, o), prod.reshape(b * n, -1)
        runs = {"data": (lambda: spider_bwd_data(feat, idx, g, kernel, dout),
                         lambda: torch.matmul(dout2, kernel.t())),
                "weight": (lambda: spider_bwd_weight(feat, idx, g, kernel, dout),
                           lambda: torch.matmul(p2.t(), dout2))}
        reads = {(key, which): [] for key in runs for which in (0, 1)}
        for _ in range(3):
            for key, fns in runs.items():
                for which, fn in enumerate(fns):
                    reads[key, which].append(cuda_ms(fn))
        half = {key: sum(reads[key, 0]) / 3 for key in runs}
        lib = {key: sum(reads[key, 1]) / 3 for key in runs}
        bound = 2.0 * b * n * kernel.shape[0] * o / F32_OPS_PER_S * 1e3
        for key in halves:
            halves[key][0] += half[key]
            halves[key][1] += lib[key]
            halves[key][2] += bound
        spread = {key: f"{min(v):.4f}-{max(v):.4f}" for key, v in reads.items()}
        print(f"time spider_conv backward {label}: kernels {ms:.4f} ms (data {half['data']:.4f}, read "
              f"{spread['data', 0]}; weight {half['weight']:.4f}, read {spread['weight', 0]}), plain {plain_ms:.4f} "
              f"ms; torch.matmul dout·Wᵀ {lib['data']:.4f} ms (read {spread['data', 1]}), pᵀ·dout "
              f"{lib['weight']:.4f} ms (read {spread['weight', 1]}); each half's bound {bound:.4f} ms ({smi})")
        out["spider_conv_bwd"]["ms"] += ms
        out["spider_conv_bwd"]["plain_ms"] += plain_ms
        out["spider_conv_bwd"]["library_ms"] += lib["data"] + lib["weight"]
        spider_work(work["spider_conv_bwd"], feat, idx, g, kernel, backward=True)
        del prod, dout2, p2
        torch.cuda.empty_cache()
    for name in names:
        out[name].update(work[name].record())
    for key, (k_ms, l_ms, b_ms) in halves.items():
        print(f"time spider_conv backward, {key} half over conv1-4: kernel {k_ms:.4f} ms, torch.matmul {l_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms (operations, f32) ({smi})")
    print(f"spider_conv bound over conv1-4: {out['spider_conv']['bound_ms']:.4f} ms in f32 on the CUDA cores "
          f"(67 TFLOP/s; the kernel's route), {tf32_ms:.4f} ms as three TF32 products on the tensor cores "
          f"(495 TFLOP/s; a 3xTF32 route)")

    # 7c. Inference from get_model, f32 and bf16.
    inference = (edge_gather_knn, spider_conv_fwd_kernel)
    check_inference(models, x, inference, smi, "spidercnn", bf16_share=1.0)
    del models
    torch.cuda.empty_cache()

    # 7d. Training, f32: a few steps, one against the plain path, a step timed.
    counters = inference + (spider_conv_bwd_kernel, scatter_add_rows)
    trainer = Trainer(TrainerConfig(model="spidercnn_cls_xyz", batch_size=b, device=str(dev)))
    state = trainer.init_state(seed=0)

    def steps():
        return [float(trainer.train_step(state, batch)[1]["loss"]) for batch in batches[:TRAIN_STEPS]]

    losses, counts = counted_run(counters, steps)
    print(f"spidercnn training main path: {TRAIN_STEPS} steps, losses {[round(v, 6) for v in losses]}, "
          f"launches {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel of the spidercnn training path never launched: {counts}")
    require(all(math.isfinite(v) for v in losses), f"non-finite spidercnn training loss: {losses}")
    compare_steps(trainer, batches[TRAIN_STEPS], 2, f"spidercnn B={b}", SPIDER_LOSS_RTOL)
    time_steps(trainer, state, batches, smi, f"spidercnn B={b} N={n} f32", n=1)
    bf16_steps("spidercnn_cls_xyz", batches, dev, smi, counters, 2, f"spidercnn B={b} N={n}",
               gate=spider_bf16_gate, batch_size=b)
    return out


def with_duplicates(points):
    """A copy of [B, N, 3] clouds with exact copies of earlier points (some
    inside the first 384) and a -0.0/0.0 pair injected (phase 8)."""
    x = points.clone()
    x[:, 300:340] = x[:, 10:50]
    x[:, 900:1000] = x[:, 100:200]
    x[:, 5] = x.new_tensor((0.0, 0.25, -0.5))
    x[:, 700] = x.new_tensor((-0.0, 0.25, -0.5))
    return x


def dupmask_work(work: Work, xyz) -> None:
    """#12: each point compares its three coordinates with the points before
    it until the first match (every earlier point where it has none); the
    points read once, the mask written once."""
    import torch

    b, n, _ = xyz.shape
    eq = (xyz[:, :, None, :] == xyz[:, None, :, :]).all(-1).triu(1)  # [B, i, j]: i < j and equal
    first = torch.where(eq.any(1), eq.int().argmax(1) + 1, torch.arange(n, device=xyz.device))
    work.add(3.0 * float(first.sum()), 16 * b * n)


def pointcnn_phase(smi: str, dev) -> dict:
    """Phase 8 (module doc).  Returns #12's record (max abs error, kernel
    and plain ms and its bound over the six calls of one f32
    ``pointcnn_seg`` forward at B=32); #13's PointCNN calls are printed."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.nn import xconv
    from scanobjectnn_torch.ops.cuda.dupmask_kernel import duplicate_mask_kernel, duplicate_mask_plain, launch_floor
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel, knn_point_plain
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    b, n = PCNN_BATCH, PCNN_POINT
    data, labels, masks = make_synthetic_dataset(
        num_per_class=9, num_classes=NUM_CLASSES, num_points=2 * n, seed=4, with_mask=True
    )
    view = EpochSampler(data, labels, masks=convert_to_binary_mask(masks).astype(np.int64), num_points=n,
                        seed=0).epoch()
    batches = [{**bt, "points": with_duplicates(torch.from_numpy(bt["points"])).numpy()} for bt in Batches(view, b)]
    require(len(batches) > TRAIN_STEPS, f"only {len(batches)} PointCNN batches")
    x = torch.from_numpy(batches[0]["points"]).to(dev)
    seg_models = eval_models("pointcnn_seg", np.random.RandomState(13))

    # The inputs one f32 pointcnn_seg forward hands #12 and #13.
    calls = {"dup": [], "knn": []}

    def recorder(kind, fn):
        def call(*args):
            calls[kind].append(args)
            return fn(*args)
        return call

    with torch.no_grad(), mock.patch.object(xconv, "duplicate_mask_kernel", recorder("dup", duplicate_mask_kernel)), \
            mock.patch.object(xconv, "knn_point_kernel", recorder("knn", knn_point_kernel)):
        seg_models["f32"](x)
    ks = [c[2] for c in calls["knn"]]
    require(ks == [8, 24, 32, 48, 48, 32] and len(calls["dup"]) == 6, f"PointCNN kernel-branch calls: k {ks}")

    # 8a. #12 at the forward's six calls.
    dup = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
    work = Work()
    for i, (xyz,) in enumerate(calls["dup"]):
        label = f"call {i + 1} [{b},{xyz.shape[1]},3]"
        got, want = duplicate_mask_kernel(xyz), duplicate_mask_plain(xyz)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"the duplicate mask differs from its plain version ({label})")
        ms, plain_ms = cuda_ms(lambda: duplicate_mask_kernel(xyz)), cuda_ms(lambda: duplicate_mask_plain(xyz), iters=3)
        floor_ms = cuda_ms(lambda: launch_floor(xyz))
        print(f"duplicate_mask {label}: equal to the plain version ({int(want.sum())} duplicates); time kernel "
              f"{ms:.4f} ms (device {device_ms(lambda: duplicate_mask_kernel(xyz)):.4f}), plain {plain_ms:.4f} ms; "
              f"the floor, an empty kernel of the same grid, {floor_ms:.4f} ms (device "
              f"{device_ms(lambda: launch_floor(xyz)):.4f}) ({smi})")
        dup["ms"] += ms
        dup["plain_ms"] += plain_ms
        dupmask_work(work, xyz)
    dup.update(work.record())

    # 8b. #13 at the forward's six kernel-branch calls, with the dup bias.
    knn_ms = knn_plain_ms = 0.0
    knn_bound = Work()
    for q, p, k, bias in calls["knn"]:
        label = f"M{q.shape[1]} N{p.shape[1]} k{k} with the duplicate bias"
        d, i = knn_point_kernel(q, p, k, bias)
        ref_d, ref_i = knn_point_plain(q, p, k, bias)
        torch.cuda.synchronize()
        require(torch.equal(i, ref_i) and torch.equal(d, ref_d), f"kNN differs from its plain version ({label})")
        ms, plain_ms = cuda_ms(lambda: knn_point_kernel(q, p, k, bias)), cuda_ms(lambda: knn_point_plain(q, p, k, bias), iters=3)
        print(f"knn PointCNN {label}: idx and d2 equal to the plain version; time kernel {ms:.4f} ms (device "
              f"{device_ms(lambda: knn_point_kernel(q, p, k, bias)):.4f}), plain {plain_ms:.4f} ms ({smi})")
        knn_ms += ms
        knn_plain_ms += plain_ms
        knn_work(knn_bound, q, p, k, True)
    rec = knn_bound.record()
    print(f"knn PointCNN, one pointcnn_seg forward's six calls: kernel {knn_ms:.4f} ms, plain {knn_plain_ms:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) ({smi})")

    # 8b'. Both branches of knn_indices_general at every call of the forward
    # with k <= 64, the dispatch's crossover: #12 + #13 against the full sort.
    general, knn_indices_general = [], xconv.knn_indices_general

    def record_general(q, p, k, unique=True):
        general.append((q, p, k))
        return knn_indices_general(q, p, k, unique)

    with torch.no_grad(), mock.patch.object(xconv, "knn_indices_general", record_general):
        seg_models["f32"](x)
    for q, p, k in general:
        if k > xconv.MAX_K:
            continue
        branches = {"kernel": lambda: xconv._knn_indices_kernel(q, p, k, True),
                    "plain": lambda: xconv._knn_indices_plain(q, p, k, True)}
        # A call is mostly launches, so the host's hiccups move one reading:
        # five alternating rounds of 20 calls each, their median, and the
        # device time, which leaves the host's gaps out.
        rounds = {name: [] for name in branches}
        for _ in range(5):
            for name, fn in branches.items():
                rounds[name].append(cuda_ms(fn, iters=20))
        med = {name: sorted(ms)[2] for name, ms in rounds.items()}
        dev_ms = {name: device_ms(fn) for name, fn in branches.items()}
        print(f"knn_indices_general Q{q.shape[1]} N{p.shape[1]} k{k} (Q*N {q.shape[1] * p.shape[1]}): median of 5 "
              f"rounds kernel branch {med['kernel']:.4f} ms, plain branch {med['plain']:.4f} ms (rounds "
              f"{[round(v, 4) for v in rounds['kernel']]} / {[round(v, 4) for v in rounds['plain']]}); device "
              f"{dev_ms['kernel']:.4f} / {dev_ms['plain']:.4f} ms ({smi})")

    # 8c. Inference, f32 and bf16, from get_model.
    inference = (duplicate_mask_kernel, knn_point_kernel, gather_rows)
    check_inference(seg_models, x, inference, smi, "pointcnn_seg")
    del seg_models
    check_inference(eval_models("pointcnn_cls", np.random.RandomState(14)), x, inference, smi, "pointcnn_cls")
    torch.cuda.empty_cache()

    # 8d. Training with the recipe: steps, one against the plain path, a step timed.
    counters = inference + (scatter_add_rows,)
    for name, n_steps in (("pointcnn_cls", TRAIN_STEPS), ("pointcnn_seg", 1)):
        trainer = Trainer(TrainerConfig(model=name, batch_size=b, device=str(dev)))
        require(trainer.recipe is not None and trainer.adam_eps == 1e-2 and trainer.weight_decay == 1e-5,
                f"{name}: the Trainer did not take PointCNN's recipe")
        state = trainer.init_state(seed=0)
        losses, counts = counted_run(
            counters, lambda: [float(trainer.train_step(state, bt)[1]["loss"]) for bt in batches[:n_steps]]
        )
        print(f"{name} training main path: {n_steps} steps, losses {[round(v, 6) for v in losses]}, launches {counts}")
        require(all(c > 0 for c in counts.values()), f"a kernel of the {name} training path never launched: {counts}")
        require(all(math.isfinite(v) for v in losses), f"non-finite {name} training loss: {losses}")
        compare_steps(trainer, batches[TRAIN_STEPS], 0, f"{name} B={b}")
        time_steps(trainer, state, batches, smi, f"{name} B={b} N={n} f32", n=1)
        bf16_steps(name, batches, dev, smi, counters, 0, f"{name} B={b} N={n}", batch_size=b)
    return dup


def msg_phase(smi: str, dev) -> dict:
    """Phase 9 (module doc).  Returns the record of #3's chunked path (max
    abs error; kernel, plain and bound ms summed over the two K=128 calls
    of one bf16 ``pointnet2_cls_msg`` forward at B=32)."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.nn import pointnet_modules
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    b, n = MSG_BATCH, MSG_POINT
    data, labels = make_synthetic_dataset(num_per_class=5, num_classes=NUM_CLASSES, num_points=2 * n, seed=5)
    view = EpochSampler(data, labels, num_points=n, seed=0).epoch()
    x = torch.from_numpy(view["points"][:b]).to(dev)
    models = eval_models("pointnet2_cls_msg", np.random.RandomState(15))
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
    work = Work()

    # 9a. One forward in each dtype, counting #3's launches (six, two of them
    # chunked) and recording its calls; each call against the plain version.
    calls = []

    def recorder(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items() if k != "dtype"}))
        return sa_ball_mlp_pool(*args, **kw)

    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        calls.clear()
        with torch.no_grad(), mock.patch.object(pointnet_modules, "sa_ball_mlp_pool", recorder):
            _, counts = counted_run((fps, sa_ball_mlp_pool), lambda: models[name](x))
        ks = [args[1] for args, _ in calls]
        print(f"MSG {name} forward B={b}: launches {counts}, of them chunked (K > 64) "
              f"{sa_ball_mlp_pool.chunked_launches}; K of the fused calls {ks}")
        require(counts["sa_ball_mlp_pool"] == 6 and ks == [16, 32, 128, 32, 64, 128]
                and sa_ball_mlp_pool.chunked_launches == 2, f"MSG's fused SA calls: {counts}, K {ks}")
        with torch.no_grad():
            for i, (args, kw) in enumerate(calls):
                label = f"MSG SA{i // 3 + 1} scale {i % 3} {name} B={b} K{args[1]} r{args[0]}"
                err = check_sa(args, dtype, label, sa_ball_mlp_pool, sa_ball_mlp_pool_plain, **kw)
                ms = cuda_ms(lambda: sa_ball_mlp_pool(*args, dtype=dtype, **kw))
                plain_ms = cuda_ms(lambda: sa_ball_mlp_pool_plain(*args, dtype=dtype, **kw), iters=3)
                print(f"time sa_ball_mlp_pool {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                      f"{fma_rate(sa_flops(args, kw['use_xyz']), ms)} ({smi})")
                if args[1] > 64:
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    if name == "bf16":
                        rec["ms"] += ms
                        rec["plain_ms"] += plain_ms
                        sa_work(work, args, dtype, kw["use_xyz"])
    rec.update(work.record())

    # 9b. Inference, f32 and bf16, against the plain path.
    check_inference(models, x, (fps, sa_ball_mlp_pool), smi, "MSG")
    del models
    torch.cuda.empty_cache()

    # 9c. Training, f32, B=16: a few steps, one against the plain path, a step timed.
    batches = list(Batches(view, MSG_TRAIN_BATCH))
    require(len(batches) > TRAIN_STEPS, f"only {len(batches)} MSG batches")
    trainer = Trainer(TrainerConfig(model="pointnet2_cls_msg", batch_size=MSG_TRAIN_BATCH, device=str(dev)))
    state = trainer.init_state(seed=0)
    counters = (fps, query_ball_group, gather_rows, scatter_add_rows)

    def steps():
        return [float(trainer.train_step(state, batch)[1]["loss"]) for batch in batches[:TRAIN_STEPS]]

    losses, counts = counted_run(counters, steps)
    print(f"MSG training main path: {TRAIN_STEPS} steps, losses {[round(v, 6) for v in losses]}, launches {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel of the MSG training path never launched: {counts}")
    require(all(math.isfinite(v) for v in losses), f"non-finite MSG training loss: {losses}")
    compare_steps(trainer, batches[TRAIN_STEPS], 23, f"MSG B={MSG_TRAIN_BATCH}")
    time_steps(trainer, state, batches, smi, f"MSG B={MSG_TRAIN_BATCH} N={n} f32")
    return rec


def rank_sort_work(work: Work, b: int, n: int) -> None:
    # Per point: the key and the coordinates read (16 B), the sorted
    # coordinates, the id and the rank written (20 B); a sort's n·log2(n)
    # comparisons a cloud.
    work.add(b * n * math.log2(max(n, 2)), 36 * b * n)


def check_bucketed(args, dtype, label, **wtg) -> tuple[float, int, int]:
    """#4 on ``args`` (``sa_ball_mlp_pool``'s): pooled equal bit for bit to
    the #3 kernel's, and held to its plain version by the SA bound.
    Returns (max abs error, overflowed tiles, tiles)."""
    import torch

    from scanobjectnn_torch.ops.cuda.sabucket_kernel import (
        sa_ball_mlp_pool_bucketed, sa_ball_mlp_pool_bucketed_plain,
    )
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool

    pooled, idx = sa_ball_mlp_pool_bucketed(*args, dtype=dtype, **wtg)
    flags = sa_ball_mlp_pool_bucketed.last_overflow.clone()
    full, _ = sa_ball_mlp_pool(*args, dtype=dtype)
    ref, _ = sa_ball_mlp_pool_bucketed_plain(*args, dtype=dtype, **wtg)
    torch.cuda.synchronize()
    require(idx is None, f"the bucketed layer returned idx ({label})")
    require(torch.equal(pooled, full), f"the bucketed layer differs from the #3 kernel ({label})")
    err = check_pooled(pooled, ref, dtype, f"bucketed {label}: equal to the #3 kernel; against its plain version,")
    n_ov, total = int(flags.sum()), flags.numel()
    print(f"bucketed {label}: {n_ov} of {total} tiles overflowed (scanned the whole cloud)")
    return err, n_ov, total


def bucket_phase(smi: str, dev, models: dict, x0, sa1_xyz) -> dict:
    """Phase 12 (module doc).  Returns the records of #5 (its two calls of
    one SSG forward's SA1, B=128) and #4 (the bf16 SA1 call)."""
    import numpy as np
    import torch

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import ball_query_plain
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points, rank_sort_points_plain
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import (
        AUTO_BUCKET, sa_ball_mlp_pool_bucketed, sa_ball_mlp_pool_bucketed_plain, sort_keys,
    )
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    # a. #5 at SA1's two calls, on a tie lattice with -0.0 and NaN keys, and
    #    carrying feature rows.
    _, key, qkey = sort_keys(x0, sa1_xyz)
    g = torch.Generator().manual_seed(21)
    lattice = torch.randint(-3, 4, (BATCH, NUM_POINT), generator=g).float() * 0.25
    lattice[:, ::9] = -0.0
    lattice[:2, 5::301] = float("nan")
    feats = torch.randn(BATCH, NUM_POINT, 64, generator=g).to(dev, torch.bfloat16)
    rec5 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    work5 = Work()
    # The plan's edges and the orders a sort meets at its extremes, B=8.
    edge_cases = []
    for n, kind in ((1, "f32 rows"), (31, "ties"), (32, "ties"), (33, "ties"), (257, "ties"), (2047, "ties"),
                    (2048, "ascending"), (2048, "descending"), (2048, "all equal"), (512, "all NaN"),
                    (1500, "signed zeros"), (129, "f32 rows"), (257, "bf16 odd rows"), (16384, "ties")):
        pts = torch.randn(8, n, 3, generator=g)
        k = {"ascending": torch.arange(n).float().expand(8, n), "descending": -torch.arange(n).float().expand(8, n),
             "all equal": torch.full((8, n), 1.5), "all NaN": torch.full((8, n), float("nan")),
             "signed zeros": torch.where(torch.rand(8, n, generator=g) < 0.5, -0.0, 0.0)}.get(
            kind, torch.round(pts[..., 0] * 4.0) / 4.0)
        rows = {"f32 rows": torch.randn(8, n, 5, generator=g),
                "bf16 odd rows": torch.randn(8, n, 5, generator=g).to(torch.bfloat16)}.get(kind)
        edge_cases.append((f"{kind} B=8 N={n}", k.contiguous().to(dev), pts.to(dev),
                           None if rows is None else rows.to(dev), False))
    for label, k, pts, rows, timed in (
        ("points B=128 N=2048", key, x0, None, True), ("queries B=128 M=512", qkey, sa1_xyz, None, True),
        ("tie lattice with -0.0 and NaN keys B=128 N=2048", lattice.to(dev), x0, None, False),
        ("points with bf16 feature rows B=128 N=2048 C=64", key, x0, feats, False),
        *edge_cases,
    ):
        got, ref = rank_sort_points(k, pts, rows), rank_sort_points_plain(k, pts, rows)
        torch.cuda.synchronize()
        require(all((a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)) for a, b in zip(got, ref)),
                f"rank_sort_points differs from its plain version ({label})")
        print(f"rank_sort_points {label}: sorted rows, ids and rank equal to rank_sort_points_plain")
        if timed:  # calls of tens of µs: device time (CUDA events mostly time the launches)
            ms = device_ms(lambda: rank_sort_points(k, pts))
            plain_ms = device_ms(lambda: rank_sort_points_plain(k, pts))
            lib_ms = device_ms(lambda: torch.argsort(k, dim=1, stable=True))
            print(f"time rank_sort_points {label}: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"torch.argsort(stable=True) {lib_ms:.4f} ms; CUDA events per call kernel "
                  f"{cuda_ms(lambda: rank_sort_points(k, pts)):.4f} ms ({smi})")
            rec5["ms"] += ms
            rec5["plain_ms"] += plain_ms
            rec5["library_ms"] += lib_ms
            rank_sort_work(work5, *k.shape)

    # b. #4 at the "auto" SA1 call, f32 and bf16.
    window, qtile, gblk = AUTO_BUCKET[(NUM_POINT, 512)]
    wtg = dict(window=window, qtile=qtile, gblk=gblk)
    rec4 = {"max_abs_err": 0.0, "library_ms": None}
    work4 = Work()
    for name in ("f32", "bf16"):
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        with torch.no_grad():
            w1, b1 = models[name].sa1.mlp.folded()
        args = (0.2, 32, x0, sa1_xyz, None, w1, b1)
        err, n_ov, total = check_bucketed(args, dtype, f"SSG SA1 {name} B=128 (W, T, G) = {window, qtile, gblk}", **wtg)
        require(n_ov < total, "the window branch ran on no tile of the auto SA1 call")
        rec4["max_abs_err"] = max(rec4["max_abs_err"], err)
        ms = cuda_ms(lambda: sa_ball_mlp_pool_bucketed(*args, dtype=dtype, **wtg))
        full_ms = cuda_ms(lambda: sa_ball_mlp_pool(*args, dtype=dtype))
        plain_ms = cuda_ms(lambda: sa_ball_mlp_pool_bucketed_plain(*args, dtype=dtype, **wtg), iters=3)
        sorts_ms = cuda_ms(lambda: (rank_sort_points(key, x0), rank_sort_points(qkey, sa1_xyz)))
        print(f"time sa_ball_mlp_pool_bucketed SSG SA1 {name} B=128: #4 with its prep {ms:.4f} ms (the two #5 calls "
              f"{sorts_ms:.4f}), #3 {full_ms:.4f} ms, plain {plain_ms:.4f} ms; #4 {fma_rate(sa_flops(args), ms)} "
              f"({smi})")
        if name == "bf16":
            rec4.update(ms=ms, plain_ms=plain_ms)
            sa_work(work4, args, dtype)

    # c. A cloud that forces overflow, a dense cloud, and a has-src call.
    b = 16
    tight = (x0[:b] * 0.05).contiguous()
    _, tight_q = fps(tight, 512)
    rng = np.random.RandomState(22)
    centers = rng.randn(b, 16, 3) * np.array([4.0, 0.3, 0.3])
    dense = torch.from_numpy((centers[np.arange(b)[:, None], rng.randint(0, 16, (b, NUM_POINT))]
                              + rng.randn(b, NUM_POINT, 3) * 0.05).astype(np.float32)).to(dev)
    _, dense_q = fps(dense, 512)
    _, cnt = ball_query_plain(0.2, NUM_POINT, dense, dense_q)
    require(int(cnt.max()) > 32, "the dense cloud has no ball with more than K hits")
    _, sa2_q = fps_plain(sa1_xyz[:b].contiguous(), 128)
    src = torch.randn(b, 512, 64, generator=g).to(dev)
    w_src = [torch.randn(3 + 64, 64, generator=g).to(dev) / 8.0, torch.randn(64, 128, generator=g).to(dev) / 8.0]
    b_src = [0.1 * torch.randn(64, generator=g).to(dev), 0.1 * torch.randn(128, generator=g).to(dev)]
    with torch.no_grad():
        w1, b1 = models["f32"].sa1.mlp.folded()
    for label, args, cfg in (
        ("a cloud that forces overflow B=16", (0.2, 32, tight, tight_q, None, w1, b1), wtg),
        (f"a dense cloud B=16 (max {int(cnt.max())} hits > K=32)", (0.2, 32, dense, dense_q, None, w1, b1), wtg),
        ("with 64 features B=16 N=512 M=128 K=64, (W, T, G) = (384, 32, 128)",
         (0.4, 64, sa1_xyz[:b].contiguous(), sa2_q, src, w_src, b_src), dict(window=384, qtile=32, gblk=128)),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            _, n_ov, total = check_bucketed(args, dtype, f"{label} {dtype}", **cfg)
            if label.startswith("a cloud that forces"):
                require(n_ov == total, "the tight cloud did not overflow every tile")

    # d. SSG Trainer.evaluate at N=2048 with votes, kernel path against plain path.
    data, labels = make_synthetic_dataset(num_per_class=4, num_classes=NUM_CLASSES, num_points=NUM_POINT, seed=5)
    trainer = Trainer(TrainerConfig(num_point=NUM_POINT, batch_size=32))
    state = trainer.init_state(0)
    stats_rng = np.random.RandomState(23)
    with torch.no_grad():
        for k_, buf in state.model.named_buffers():
            vals = stats_rng.randn(*buf.shape)
            buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if k_.endswith(".var") else 0.05 * np.abs(vals)))
    counters = (fps, sa_ball_mlp_pool, sa_ball_mlp_pool_bucketed, rank_sort_points)

    def run():
        return trainer.evaluate(state, data, labels, num_votes=3, shuffle=False)

    res, counts = counted_run(counters, run)
    print(f"evaluate SSG main path launches: {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel of the evaluate path never launched: {counts}")
    before = [c.launches for c in counters]
    with plain_path():
        ref = run()
    require([c.launches for c in counters] == before, "the plain evaluate path launched a kernel")
    require(res["total_seen"] == ref["total_seen"] == len(labels), "evaluate dropped a cloud")
    require(np.array_equal(res["predictions"], ref["predictions"]), "evaluate's predictions differ from the plain path")
    print(f"evaluate SSG N=2048, {len(labels)} clouds, batch 32, 3 votes: accuracy {res['accuracy']:.4f} "
          f"(plain path {ref['accuracy']:.4f}), mean loss {res['mean_loss']:.6f} (plain path {ref['mean_loss']:.6f}), "
          f"predictions equal")

    def wall_ms(path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if path == "plain":
            with plain_path():
                run()
        else:
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = {"kernel": [], "plain": []}
    for path in ("kernel", "plain", "plain", "kernel"):
        times[path].append(wall_ms(path))
    print(f"time evaluate SSG N=2048 ({len(labels)} clouds, 3 votes): kernel path "
          f"{sum(times['kernel']) / 2:.4f} ms, plain path {sum(times['plain']) / 2:.4f} ms "
          f"(rounds {', '.join(f'{v:.4f}' for v in times['kernel'] + times['plain'])}) ({smi})")
    return {"rank_sort_points": {**rec5, **work5.record()}, "sa_ball_mlp_pool_bucketed": {**rec4, **work4.record()}}


def write_bin_clouds(root: str, rng, count: int = DATA_CLOUDS) -> tuple[str, int, int]:
    """Raw ScanObjectNN object files under ``root`` (phases 14 and 15):
    ``count`` clouds of 2100-2600 points, two of them below NUM_POINT (1500 and 2000),
    11 floats a point after a count header: the coordinates of a synthetic
    prototype's points (semantic label 3 + the class) among background
    points (labels 0, 1, 2 and -1), normals, colours and an instance id.
    The pickled file list names them with the ``objects_bin/`` prefix.
    Returns (the list's path, the clouds of at least NUM_POINT points, of
    which at least NUM_POINT foreground points)."""
    import os
    import pickle

    import numpy as np

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset

    per_class = -(-count // NUM_CLASSES)
    shapes, labels = make_synthetic_dataset(num_per_class=per_class, num_classes=NUM_CLASSES, num_points=2600, seed=9)
    sizes = rng.randint(2100, 2601, count)
    sizes[[3, 17]] = (1500, 2000)
    entries, with_bg, fg_only = [], 0, 0
    for i, (n, label) in enumerate(zip(sizes, labels[:count])):
        n_bg = rng.randint(0, 200)
        n_minus = rng.randint(0, 30)
        pts = np.concatenate([shapes[i][: n - n_bg - n_minus], 3.0 * rng.rand(n_bg + n_minus, 3) - 1.5])
        sem = np.concatenate([np.full(n - n_bg - n_minus, 3.0 + label), rng.choice([0.0, 1.0, 2.0], n_bg),
                              np.full(n_minus, -1.0)])
        perm = rng.permutation(n)
        rows = np.concatenate([pts, rng.randn(n, 3), rng.rand(n, 3), np.full((n, 1), float(i)), sem[:, None]], 1)
        name = f"scene{i:03d}_{label}.bin"
        np.concatenate([np.float32([n]), rows[perm].astype(np.float32).reshape(-1)]).tofile(os.path.join(root, name))
        entries.append({"filename": "objects_bin/" + name, "label": int(label)})
        with_bg += n >= NUM_POINT
        fg_only += n - n_bg - n_minus >= NUM_POINT
    path = os.path.join(root, "objects.pickle")
    with open(path, "wb") as f:
        pickle.dump(entries, f)
    return path, with_bg, fg_only


def data_phase(smi: str, dev) -> None:
    """Phase 14 (module doc): the data loaders on files the phase writes."""
    import importlib.util
    import os
    import tempfile

    import numpy as np
    import torch

    from scanobjectnn_torch.data import io
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset, write_synthetic_h5
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.RandomState(24)

    def trainer_of(model, num_point):
        trainer = Trainer(TrainerConfig(model=model, num_point=num_point, batch_size=DATA_BATCH))
        state = trainer.init_state(0)
        with torch.no_grad():
            for k_, buf in state.model.named_buffers():
                vals = rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if k_.endswith(".var") else 0.05 * np.abs(vals)))
        return trainer, state

    def evaluate(label, trainer, state, counters, data, labels, **kw):
        """The kernel path (each kernel counted) and the plain path."""
        def run():
            return trainer.evaluate(state, data, labels, num_votes=3, shuffle=False, **kw)

        t0 = time.perf_counter()
        res, counts = counted_run(counters, run)
        ms = (time.perf_counter() - t0) * 1e3
        require(all(c > 0 for c in counts.values()), f"a kernel of the {label} evaluation never launched: {counts}")
        with plain_path():
            ref = run()
        require(res["total_seen"] == ref["total_seen"] == len(labels), f"{label}: evaluate dropped a cloud")
        require(np.array_equal(res["predictions"], ref["predictions"]),
                f"{label}: the predictions differ from the plain path's")
        print(f"evaluate {label}: {res['total_seen']} clouds, batch {DATA_BATCH}, 3 votes, launches {counts}; "
              f"accuracy {res['accuracy']:.4f} (plain path {ref['accuracy']:.4f}), predictions equal; "
              f"{ms:.1f} ms on the kernel path ({smi})")
        return res, ref

    with tempfile.TemporaryDirectory() as tmp:
        # a. An h5 of the synthetic dataset with masks, through the port's
        #    writer and loader, where the machine has h5py; else the arrays
        #    that file would hold.
        kw = dict(num_per_class=4, num_classes=NUM_CLASSES, num_points=NUM_POINT, seed=7, with_mask=True)
        if importlib.util.find_spec("h5py") is not None:
            path = os.path.join(tmp, "synthetic_withmask.h5")
            write_synthetic_h5(path, **kw)
            data, labels, masks = io.load_withmask_h5(path)
            source, origin = f"{path.rsplit('/', 1)[-1]} written and read", "the h5 file"
        else:
            data, labels, masks = make_synthetic_dataset(**kw)
            source = ("h5py is not installed on this machine: no h5 file written or read; the arrays "
                      "write_synthetic_h5 would write, from make_synthetic_dataset")
            origin = "the synthetic arrays"
        require(data.shape == (4 * NUM_CLASSES, NUM_POINT, 3) and data.dtype == np.float32
                and labels.dtype == np.int64 and masks.shape == data.shape[:2], "the synthetic dataset")
        print(f"data h5: {source}: data {data.shape} {data.dtype}, labels {labels.shape}, masks {masks.shape} "
              f"({int((masks == -1).sum())} background points)")

        # b. SSG at num_point 2048 under "auto": #1, #5, #4 and #3.
        trainer, state = trainer_of("pointnet2_cls_ssg", NUM_POINT)
        ssg_counters = (fps, rank_sort_points, sa_ball_mlp_pool_bucketed, sa_ball_mlp_pool)
        evaluate(f"SSG on {origin} N={NUM_POINT}", trainer, state, ssg_counters, data, labels)

        # c. BGA at num_point 1024 with the binary masks: §2's gate.
        bga, bga_state = trainer_of("pointnet2_cls_bga", SEG_POINT)
        bin_masks = io.convert_to_binary_mask(masks).astype(np.int64)
        res, ref = evaluate(f"BGA on {origin} N={SEG_POINT}", bga, bga_state,
                            (fps, sa_ball_mlp_pool, knn_point_kernel, gather_rows), data, labels, masks=bin_masks,
                            keep_points=True)
        agree = float((res["seg_predictions"] == ref["seg_predictions"]).mean())
        print(f"evaluate BGA: per-point argmax agreement {agree:.4f}, seg accuracy {res['seg_accuracy']:.4f} "
              f"(plain path {ref['seg_accuracy']:.4f})")
        require(agree >= SEG_AGREEMENT, f"BGA per-point agreement {agree} below {SEG_AGREEMENT}")

        # d. Ragged .bin clouds from a pickled file list, with and without background.
        listing, want_bg, want_fg = write_bin_clouds(tmp, rng)
        for with_bg, want in ((True, want_bg), (False, want_fg)):
            clouds, cloud_labels = io.load_data(listing, num_points=NUM_POINT, with_bg=with_bg, data_dir=tmp)
            require(len(clouds) == want and len(cloud_labels) == want,
                    f"load_data(with_bg={with_bg}) kept {len(clouds)} clouds, not {want}")
            sizes = [pc.shape[0] for pc in clouds]
            clouds = io.normalize_data(io.center_data(clouds))
            require(all(abs(float(np.sqrt((pc ** 2).sum(-1)).max()) - 1.0) < 1e-5 for pc in clouds),
                    "normalize_data left a cloud off the unit sphere")
            print(f"data .bin: load_data(with_bg={with_bg}) kept {len(clouds)} of {DATA_CLOUDS} clouds "
                  f"({min(sizes)}-{max(sizes)} points), centred and normalised")
            evaluate(f"SSG over the ragged clouds (with_bg={with_bg}) N={NUM_POINT}", trainer, state, ssg_counters,
                     clouds, np.asarray(cloud_labels))


def cli_phase(smi: str) -> None:
    """Phase 15 (module doc): the command line, ``cli.main`` in a temporary
    working directory, on raw ``.bin`` clouds; the old working directory
    comes back even after a failure."""
    import collections
    import os
    import re
    import tempfile

    import torch

    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool
    from scanobjectnn_torch.train import cli
    from scanobjectnn_torch.train.trainer import Trainer
    from scanobjectnn_torch.utils.profiling import TRACE_FILE

    import numpy as np

    counters = (fps, query_ball_group, gather_rows, scatter_add_rows, sa_ball_mlp_pool, rank_sort_points,
                sa_ball_mlp_pool_bucketed)

    def snapshot():
        out = {c.__name__: c.launches for c in counters}
        out["fps"] -= fps.index_launches
        out["fps_indices"] = fps.index_launches
        return out

    # Launches by the Trainer method they ran in: training epochs, evaluations.
    by_part = {"train_epoch": collections.Counter(), "evaluate": collections.Counter()}

    def tallied(name):
        method = getattr(Trainer, name)

        def run(self, *args, **kw):
            before = snapshot()
            out = method(self, *args, **kw)
            for k, v in snapshot().items():
                by_part[name][k] += v - before[k]
            return out

        return run

    def run(label, argv):
        for part in by_part.values():
            part.clear()
        t0 = time.perf_counter()
        with mock.patch.object(Trainer, "train_epoch", tallied("train_epoch")), \
                mock.patch.object(Trainer, "evaluate", tallied("evaluate")):
            _, counts = counted_run(counters, lambda: cli.main(argv))
        secs = time.perf_counter() - t0
        def moved(d):
            return {k: v for k, v in d.items() if v}

        print(f"cli {label}: {' '.join(argv)}: {secs:.2f} s wall, launches {moved(counts)} (training "
              f"{moved(by_part['train_epoch'])}, evaluations {moved(by_part['evaluate'])}) ({smi})")
        return counts

    def records(log_dir):
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def sidecar(name):
        with open(os.path.join("log", name)) as f:
            return json.load(f)

    def epoch_seconds(log_dir):
        with open(os.path.join(log_dir, "log_train.txt")) as f:
            return [float(m.group(1)) for m in re.finditer(r"^epoch \d+ .*\((\d+\.\d)s\)$", f.read(), re.M)]

    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # a. The clouds and their listing, in the working directory.
            listing, kept, _ = write_bin_clouds(tmp, np.random.RandomState(15), count=CLI_CLOUDS)
            require(kept == CLI_CLOUDS - 2, f"{kept} clouds of {NUM_POINT} points or more")
            files = ["--train_file", os.path.basename(listing), "--test_file", os.path.basename(listing)]
            ssg = ["--model", "pointnet2_cls_ssg", "--num_point", str(TRAIN_POINT), "--batch_size", str(TRAIN_BATCH)]
            train = ["train"] + ssg + ["--log_dir", "log"] + files
            print(f"cli data: {CLI_CLOUDS} raw .bin clouds (1500-2600 points) and {os.path.basename(listing)} "
                  f"in the working directory")

            # b. Train two epochs.
            run("train", train + ["--max_epoch", "2"])
            with open("log/log_train.txt") as f:
                epochs = [line for line in f if line.startswith("epoch ")]
            require(len(epochs) == 2, f"log_train.txt has {len(epochs)} epoch lines, not 2")
            require([r["epoch"] for r in records("log")] == [0, 1], "metrics.jsonl epochs are not [0, 1]")
            for name in ("checkpoint", "checkpoint_best", "best.json", "last.json"):
                require(os.path.exists(os.path.join("log", name)), f"fit wrote no log/{name}")
            require(sidecar("last.json")["epoch"] == 1, "last.json is not at epoch 1")
            train_parts, eval_parts = by_part["train_epoch"], by_part["evaluate"]
            for k in ("fps_indices", "query_ball_group", "gather_rows", "scatter_add_rows"):
                require(train_parts[k] > 0, f"{k} never launched in the training epochs: {dict(train_parts)}")
            for k in ("fps", "sa_ball_mlp_pool"):
                require(eval_parts[k] > 0, f"{k} never launched in the evaluations: {dict(eval_parts)}")
            best = sidecar("best.json")["accuracy"]
            secs = epoch_seconds("log")
            evals = [r["eval_seconds"] for r in records("log")]
            print(f"cli train: epochs {', '.join(f'{v:.1f}' for v in secs)} s (log), evaluations "
                  f"{', '.join(f'{v:.3f}' for v in evals)} s (metrics.jsonl), best accuracy {best:.4f} ({smi})")

            # c. Resume for one more epoch.
            run("train --resume", train + ["--max_epoch", "3", "--resume"])
            require([r["epoch"] for r in records("log")] == [0, 1, 2], "the resumed run did not add exactly epoch 2")
            resumed_best = sidecar("best.json")["accuracy"]
            require(resumed_best >= best, f"best.json went from {best} to {resumed_best}")
            print(f"cli train --resume: epoch 2 in {epoch_seconds('log')[-1]:.1f} s (log), evaluation "
                  f"{records('log')[-1]['eval_seconds']:.3f} s, best accuracy {resumed_best:.4f} ({smi})")

            # d. Evaluate on the kernel path, then on the plain path.
            evaluate = ["evaluate", "--num_point", str(TRAIN_POINT), "--batch_size", str(TRAIN_BATCH),
                        "--num_votes", "3", "--log_dir", "log"] + files
            run("evaluate", evaluate)
            os.replace("log/pred_label.txt", "pred_kernel.txt")
            lax = run("evaluate --ops_backend lax", evaluate + ["--ops_backend", "lax"])
            require(set(lax.values()) == {0}, f"the lax evaluation launched kernels: {lax}")
            with open("pred_kernel.txt", "rb") as f, open("log/pred_label.txt", "rb") as g:
                kernel_bytes, lax_bytes = f.read(), g.read()
            require(kernel_bytes == lax_bytes, "pred_label.txt differs between the kernel and the lax path")
            print(f"cli evaluate: pred_label.txt ({len(kernel_bytes.splitlines())} lines) equal byte for byte on "
                  f"the kernel and the lax path")

            # e. The bucketed path at 2048 points.
            counts = run("evaluate N=2048", ["evaluate", "--num_point", str(NUM_POINT), "--batch_size",
                                            str(TRAIN_BATCH), "--num_votes", "3", "--log_dir", "log"] + files)
            for k in ("rank_sort_points", "sa_ball_mlp_pool_bucketed"):
                require(counts[k] > 0, f"{k} never launched in the 2048-point evaluation: {counts}")

            # f. The confusion matrix.
            run("draw_cmat", ["draw_cmat", "--num_point", str(TRAIN_POINT), "--log_dir", "log"] + files)
            wrote = [n for n in ("cmat.pdf", "cmat.pdf.txt") if os.path.isfile(os.path.join("log", n))]
            require(len(wrote) == 1, f"draw_cmat wrote {wrote}")
            print(f"cli draw_cmat: wrote log/{wrote[0]}"
                  + ("" if wrote[0] == "cmat.pdf" else " (matplotlib is not installed: the text table)"))

            # g. A profiled epoch into a fresh log directory.
            run("train --profile", ["train"] + ssg + ["--log_dir", "log_profile", "--max_epoch", "1", "--profile"]
                + files)
            with open(os.path.join("log_profile", "profile", TRACE_FILE)) as f:
                events = json.load(f)["traceEvents"]
            kernels = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
            for want in ("fps_kernel", "ballgroup_kernel"):
                require(any(want in name for name in kernels), f"the profile trace names no {want}")
            named = {w: sum(n for name, n in kernels.items() if w in name) for w in ("fps_kernel", "ballgroup_kernel")}
            print(f"cli train --profile: {sum(kernels.values())} kernel events in {TRACE_FILE}, {named}; "
                  f"fit's epoch {epoch_seconds('log_profile')[-1]:.1f} s (log) ({smi})")
        finally:
            os.chdir(old_cwd)


def sa_layer_phase(smi: str, dev) -> dict:
    """Phase 10 (module doc).  Returns the records of #10 (summed over the
    four f32 ``SAModule`` calls) and #8 (over its two calls)."""
    import numpy as np
    import torch

    from scanobjectnn_torch import ops
    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.nn import pointnet_modules
    from scanobjectnn_torch.nn.pointnet_modules import SAModule
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import ball_query_plain, query_ball_group, query_ball_point
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel
    from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool, sa_mlp_pool_plain

    b, n = SA_LAYER_BATCH, SA_LAYER_POINT
    data, _ = make_synthetic_dataset(num_per_class=3, num_classes=NUM_CLASSES, num_points=n, seed=6)
    x = torch.from_numpy(data[np.random.RandomState(16).permutation(len(data))[:b]]).to(dev)
    records = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
               for k in ("sa_mlp_pool", "query_ball_point")}

    # 10a. SAModule's kNN and K > 64 branches at SSG's SA1 and SA2 shapes,
    # f32 and bf16, seeded weights and random positive BN running stats.
    gen, stats_rng = torch.Generator().manual_seed(16), np.random.RandomState(17)
    layers = {}
    for label, args in (
        ("SA1 knn K32", (512, None, 32, (64, 64, 128), 0, False, True)),
        ("SA1 ball K128", (512, 0.2, 128, (64, 64, 128), 0, False, False)),
        ("SA2 knn K32", (128, None, 32, (128, 128, 256), 128, False, True)),
        ("SA2 ball K128", (128, 0.4, 128, (128, 128, 256), 128, False, False)),
    ):
        f32 = init_params(SAModule(*args), gen)
        with torch.no_grad():
            for key, buf in f32.named_buffers():
                vals = stats_rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
        bf16 = SAModule(*args, dtype=torch.bfloat16)
        bf16.load_state_dict(f32.state_dict())
        layers[label] = {"f32": f32.to(dev).eval(), "bf16": bf16.to(dev).eval()}
    with torch.no_grad():
        l1_xyz, l1_points = layers["SA1 knn K32"]["f32"](x, None)
    inputs = {"SA1": (x, None), "SA2": (l1_xyz, l1_points.contiguous())}
    calls = []

    def recorder(*args, dtype):
        calls.append((args, dtype))
        return sa_mlp_pool(*args, dtype=dtype)

    def run():
        return {(label, name): m(*inputs[label[:3]]) for label, ms in layers.items() for name, m in ms.items()}

    counters = (fps, knn_point_kernel, query_ball_group, sa_mlp_pool)
    with torch.no_grad(), mock.patch.object(pointnet_modules, "sa_mlp_pool", recorder):
        got, counts = counted_run(counters, run)
    print(f"SAModule knn / K=128 inference B={b} (four layers, f32 and bf16): launches {counts}")
    require(all(c > 0 for c in counts.values()) and counts["sa_mlp_pool"] == 8,
            f"a kernel of SAModule's knn / K > 64 path never launched: {counts}")
    before = [c.launches for c in counters]
    with torch.no_grad(), plain_path():
        ref = run()
    require([c.launches for c in counters] == before, "the plain SAModule path launched a kernel")
    for key, (new_xyz, pooled) in got.items():
        require(torch.equal(new_xyz, ref[key][0]), f"SAModule centroids differ ({key})")
        require(bool(torch.isfinite(pooled.float()).all()) and float(ref[key][1].float().abs().max()) > 0.1,
                f"SAModule output ({key})")
        check_pooled(pooled, ref[key][1], pooled.dtype, f"SAModule {key[0]} {key[1]} B={b} against the plain path")

    # 10b. #10 on the inputs those layers handed it, against its plain version; timed.
    work = Work()
    for (args, dtype), (label, name) in zip(calls, got):
        what = f"sa_mlp_pool {label} {name} B={b}"
        err = check_pooled(sa_mlp_pool(*args, dtype=dtype), sa_mlp_pool_plain(*args, dtype=dtype), dtype, what)
        ms = cuda_ms(lambda: sa_mlp_pool(*args, dtype=dtype))
        plain_ms = cuda_ms(lambda: sa_mlp_pool_plain(*args, dtype=dtype), iters=3)
        b10, m10, k10 = (args[0] if args[0] is not None else args[1]).shape[:3]
        print(f"time {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"{fma_rate(mlp_ops(args[3], b10 * m10 * k10), ms)} ({smi})")
        records["sa_mlp_pool"]["max_abs_err"] = max(records["sa_mlp_pool"]["max_abs_err"], err)
        if name == "f32":
            records["sa_mlp_pool"]["ms"] += ms
            records["sa_mlp_pool"]["plain_ms"] += plain_ms
            samlp_work(work, args, dtype)
    records["sa_mlp_pool"].update(work.record())

    # 10c. #8 through ops.query_ball_point at N=1024, M=512: K=32 at SSG
    # SA1's radius, K=128 at MSG SA1's widest.
    _, q = fps_plain(x, 512)
    shapes = ((32, 0.2), (128, 0.4))
    outs, counts = counted_run((query_ball_point,), lambda: [ops.query_ball_point(r, k, x, q) for k, r in shapes])
    print(f"ops.query_ball_point B={b} N={n} M=512: launches {counts}")
    require(counts["query_ball_point"] == 2, f"query_ball_point launches {counts}")
    work = Work()
    for (k, radius), (idx, cnt) in zip(shapes, outs):
        want_idx, want_cnt = ball_query_plain(radius, k, x, q)
        require(torch.equal(idx, want_idx.int()) and torch.equal(cnt, want_cnt.int()),
                f"query_ball_point differs from ball_query_plain (K={k})")
        ms = cuda_ms(lambda: query_ball_point(radius, k, x, q))
        plain_ms = cuda_ms(lambda: ball_query_plain(radius, k, x, q), iters=3)
        print(f"query_ball_point K={k} r={radius}: idx and cnt equal to ball_query_plain (mean cnt "
              f"{float(cnt.float().mean()):.2f}, {float((cnt == k).float().mean()):.3f} of the rows full); "
              f"time kernel {ms:.4f} ms (device {device_ms(lambda: query_ball_point(radius, k, x, q)):.4f}), "
              f"plain {plain_ms:.4f} ms ({smi})")
        records["query_ball_point"]["ms"] += ms
        records["query_ball_point"]["plain_ms"] += plain_ms
        work.add(9.0 * scanned_points(radius, k, x, q), 12 * (b * n + b * 512) + b * 512 * (4 * k + 4))
    records["query_ball_point"].update(work.record())
    return records


def poolkey_work(work: Work, z32, cdtype) -> None:
    """#18: z32 read once, pooled, kmax and cnt written; per element the two
    affine chains, two roundings, two relus and the compare (about 14
    operations)."""
    import torch

    rows, c = z32[..., 0, :].numel() // z32.shape[-1], z32.shape[-1]
    elt = 2 if cdtype == torch.bfloat16 else 4
    work.add(14.0 * z32.numel(), 4 * z32.numel() + rows * c * (elt + 8) + 16 * c)


def poolkey_plan(z32) -> dict:
    """#18's launch plan for a call on ``z32`` (``poolkey_kernel.plan``)."""
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import plan
    from scanobjectnn_torch.ops.cuda.satrain_kernel import sm_count

    k, c = z32.shape[-2:]
    return plan(z32.numel() // (k * c), k, c, sm_count(z32.device), z32.data_ptr() % 16 == 0)._asdict()


def satrain_work(work: Work, z1, widths) -> None:
    """#17, the least work of the backward: one forward recompute of the
    layers' products, the dW and dy products (2 C_{i-1} C_i operations a row
    each, f32 on the CUDA cores), about 20 elementwise operations a row and
    channel; z1 read, dz1 written, d_pooled and the parameters read once."""
    rows = z1[..., 0].numel()
    products = sum(2 * a * c for a, c in zip(widths, widths[1:]))
    nbytes = 2 * z1.element_size() * z1.numel() + 4 * (z1.shape[0] * z1.shape[1]) * widths[-1]
    nbytes += 4 * sum(a * c for a, c in zip(widths, widths[1:])) * 2 + 4 * 8 * sum(widths)
    work.add(float(rows) * (3 * products + 20 * sum(widths)), nbytes)


# #17's calls of the phase-11 steps at B=16 (groups = B * M, K, widths), for
# the kernels' build and the records.
SATRAIN_CALLS = {
    "SSG SA1": (16 * 512, 32, (64, 64, 128)),
    "SSG SA2": (16 * 128, 64, (128, 128, 256)),
    "SSG group-all": (16, 128, (256, 512, 1024)),
    "MSG SA1 K=128": (16 * 512, 128, (64, 96, 128)),
    "MSG SA2 K=128": (16 * 128, 128, (128, 128, 256)),
}
SATRAIN_KERNELS = ("consts_kernel", "pool_kernel", "combine_kernel", "walk_kernel", "reduce_kernel")


def check_satrain_kernels(smi: str) -> None:
    """Registers, local memory and blocks per SM of #17's walk and pool
    kernels, built as their plans pick them at phase 11's calls; no local
    memory allowed."""
    import torch

    from scanobjectnn_torch.ops.cuda.satrain_kernel import kernel_info, plan, sm_count

    for label, (groups, k, widths) in SATRAIN_CALLS.items():
        layout = plan(groups, k, widths, sm_count(torch.cuda.current_device()))
        for walk in (True, False):
            info = kernel_info(groups, k, widths, walk)
            name = "walk_kernel" if walk else "pool_kernel"
            print(f"kernel #17 {name} {label} (rows {layout.rows}, pool in the pass {layout.pool_in_pass}): "
                  f"{info['registers']} registers a thread, {info['local_bytes']} local bytes, {info['smem_bytes']} "
                  f"shared bytes a block, {info['blocks_per_sm']} blocks per SM ({smi})")
            require(info["local_bytes"] == 0, f"#17 {name} {label} uses local memory: {info}")
            require(info["blocks_per_sm"] >= 1, f"#17 {name} {label} fits no block on an SM: {info}")


def satrain_design_ops(rows: int, widths, layout) -> float:
    """#17's own operations under ``layout`` (``satrain_kernel.plan``): a
    forward recompute a pass (and the pool pass), the dy products each pass
    walks through, each dW once, and the forward and the products above the
    emitting layer again in every dW slice but the first."""
    prod = [0] + [2 * a * c for a, c in zip(widths, widths[1:])]  # prod[i]: layer i's product, a row
    fwd = sum(prod)
    ops = 0 if layout.pool_in_pass else fwd
    for p in layout.passes:
        walked = sum(prod[max(p.target, 0) + 1:])  # dy_{i-1} for i above the target
        ops += fwd + walked
        if 0 <= p.target < len(widths) - 1:
            ops += prod[p.target + 1] + (p.slices - 1) * (fwd + sum(prod[p.target + 2:]))
    return float(rows) * ops


def satrain_kernel_ms(fn, iters: int = 3) -> dict:
    """Device ms a call of #17's kernels by name, and their launches a call,
    from a torch.profiler trace (``profile_forward.device_spans``); the
    walk's passes apart, in launch order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_forward import device_spans

    fn()
    torch.cuda.synchronize()
    # A trace now and then comes back empty or without its first kernels:
    # take another.
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {name: {"ms": 0.0, "launches": 0} for name in SATRAIN_KERNELS}
        walks = []
        for start, end, name in device_spans(prof):
            for key in SATRAIN_KERNELS:
                if key in name:
                    out[key]["ms"] += (end - start) / 1e3 / iters
                    out[key]["launches"] += 1
                    if key == "walk_kernel":
                        walks.append((end - start) / 1e3)
        if walks and all(v["launches"] % iters == 0 for v in out.values()):
            break
    else:
        raise AssertionError(f"chip_smoke: 8 traces recorded #17's kernels unevenly over {iters} calls: {out}")
    for v in out.values():
        v["launches"] //= iters
    per_call = len(walks) // iters
    out["walk_passes_ms"] = [sum(walks[i::per_call]) / iters for i in range(per_call)]
    return out


def time_trainers(trainers: dict, batches, smi: str, label: str, n: int = 3) -> None:
    """Step time of two trainers' kernel paths (host clock around ``n``
    steps that end in a synchronize), in turns A, B, B, A."""
    import torch

    states = {name: t.init_state(seed=0) for name, t in trainers.items()}

    def step_ms(name: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches[:n]:
            trainers[name].train_step(states[name], batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    a, b = trainers
    times = {a: [], b: []}
    for name in (a, b, b, a):
        times[name].append(step_ms(name))
    for name, ms in times.items():
        print(f"time train step {label} {name}: {sum(ms) / len(ms):.4f} ms "
              f"(rounds {', '.join(f'{v:.4f}' for v in ms)}) ({smi})")


def clone_args(args):
    """Arguments of a recorded call, tensors (also in lists) cloned."""
    import torch

    def one(a):
        if torch.is_tensor(a):
            return a.detach().clone()
        if isinstance(a, (list, tuple)):
            return type(a)(one(x) for x in a)
        return a

    return tuple(one(a) for a in args)


def check_satrain_bwd(args, label: str) -> float:
    """#17 against its plain backward (the FUSED_* bounds) and bit-stable
    across two calls; returns the largest error / max|ref| of a cotangent
    outside the flipped share."""
    import torch

    from scanobjectnn_torch.ops.cuda.satrain_kernel import grouped_bn_mlp_pool_bwd, grouped_bn_mlp_pool_bwd_plain

    def flat(out):
        dz1, dgammas, dbetas, dws, dbs = out
        named = {"dz1": dz1, **{f"dgamma{i}": g for i, g in enumerate(dgammas)},
                 **{f"dbeta{i}": g for i, g in enumerate(dbetas)}, **{f"dw{i + 1}": g for i, g in enumerate(dws)}}
        return named, {f"dbias{i + 1}": g for i, g in enumerate(dbs)}

    (got, got_b), (again, again_b) = flat(grouped_bn_mlp_pool_bwd(*args)), flat(grouped_bn_mlp_pool_bwd(*args))
    want, want_b = flat(grouped_bn_mlp_pool_bwd_plain(*args))
    torch.cuda.synchronize()
    worst, readings, faults = 0.0, [], []
    for name, w in want.items():
        g = got[name]
        require(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, again[name]),
                f"#17 {name} is not bit-stable or has another type ({label})")
        diff = (g.float() - w.float()).abs()
        scale = max(float(w.float().abs().max()), 1e-30)
        err = float(diff.max()) / scale
        worst = max(worst, err)
        if name == "dz1":  # per row: a flipped gate or winner moves a whole element
            beyond = diff > FUSED_TOL * scale
            share = float(beyond.float().mean())
            readings.append(f"{name} {err:.2e} ({share:.1e} beyond {FUSED_TOL}, the rest within "
                            f"{float(torch.where(beyond, 0.0, diff).max()) / scale:.2e})")
            if share > FUSED_FLIP_SHARE:
                faults.append(f"{name}: {share} of the elements beyond {FUSED_TOL}")
        else:  # sums over every row
            readings.append(f"{name} {err:.2e}")
            if err > FUSED_SUM_TOL:
                faults.append(f"{name}: {err} > {FUSED_SUM_TOL}")
    for name, w in want_b.items():
        bound = FUSED_ZERO_TOL * max(1.0, float(want["dbeta" + name[5:]].abs().max()))
        noise = max(float(got_b[name].abs().max()), float(w.abs().max()))
        readings.append(f"{name} |{noise:.2e}|")
        if not torch.equal(got_b[name], again_b[name]) or noise > bound:
            faults.append(f"{name}: |db| {noise} > {bound} or not bit-stable")
    print(f"#17 {label}: bit-stable; error / max|ref|: {', '.join(readings)}")
    require(not faults, f"#17 differs from its plain version ({label}): {faults}")
    return worst


def mixed_phase(smi: str, dev) -> dict:
    """Phase 11 (module doc).  Returns the records of #18 (over one bf16 SSG
    step's three calls), #17 (over one f32 fused SSG step's SA1 and SA2
    calls) and the kNN's k > 64 path (over the two f32 ``SAModule(knn,
    nsample=128)`` layers' calls)."""
    import numpy as np
    import torch

    from scanobjectnn_torch.convert import init_params
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.nn.pointnet_modules import SAModule
    from scanobjectnn_torch.ops import exactpool, satrain
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel, knn_point_plain
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool, bn_relu_exactkey_pool_plain
    from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool
    from scanobjectnn_torch.ops.cuda.satrain_kernel import grouped_bn_mlp_pool_bwd, grouped_bn_mlp_pool_bwd_plain
    from scanobjectnn_torch.ops.cuda.satrain_kernel import plan as satrain_plan, sm_count
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    b, n = MIXED_BATCH, MIXED_POINT
    data, labels = make_synthetic_dataset(num_per_class=5, num_classes=NUM_CLASSES, num_points=2 * n, seed=11)
    batches = list(Batches(EpochSampler(data, labels, num_points=n, seed=0).epoch(), b))
    require(len(batches) > TRAIN_STEPS, f"only {len(batches)} batches for phase 11")
    records = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
               for k in ("bn_relu_exactkey_pool", "grouped_bn_mlp_pool_bwd", "knn_point_sorted")}
    base = (fps, query_ball_group, gather_rows, scatter_add_rows)
    n_zero = {"pointnet2_cls_ssg": 11, "pointnet2_cls_msg": 23}

    def steps(trainer, state, first: int = 0):
        return [float(trainer.train_step(state, batch)[1]["loss"]) for batch in batches[first:TRAIN_STEPS]]

    # 11a. bf16 steps (exact keys), #18's calls recorded and held to the plain version.
    calls = []

    def record(real):
        def recorder(*args):
            calls.append(clone_args(args))
            return real(*args)
        return recorder

    work = Work()
    for model in n_zero:
        short = model.split("_")[-1].upper()
        trainer = Trainer(TrainerConfig(model=model, batch_size=b, dtype="bfloat16", device=str(dev)))
        require(trainer.pool_mode == "keys", f"bf16 pool_precision 'auto' resolved to {trainer.pool_mode}")
        state = trainer.init_state(seed=0)
        calls.clear()
        with mock.patch.object(exactpool, "bn_relu_exactkey_pool", record(bn_relu_exactkey_pool)):
            losses, counts = counted_run(base + (bn_relu_exactkey_pool,), lambda: steps(trainer, state))
        per_step = 3 if short == "SSG" else 7
        print(f"{short} bf16 (keys) training main path: {TRAIN_STEPS} steps, losses {[round(v, 6) for v in losses]}, "
              f"launches {counts}")
        require(all(c > 0 for c in counts.values()) and all(math.isfinite(v) for v in losses)
                and counts["bn_relu_exactkey_pool"] == per_step * TRAIN_STEPS,
                f"the {short} bf16 training path: launches {counts}, losses {losses}")
        for i, args in enumerate(calls[:per_step]):
            z32 = args[0]
            label = f"{short} bf16 call {i} z32 {list(z32.shape)}"
            got, want = bn_relu_exactkey_pool(*args), bn_relu_exactkey_pool_plain(*args)
            torch.cuda.synchronize()
            require(all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)),
                    f"#18 differs from its plain version ({label})")
            ms, plain_ms = cuda_ms(lambda: bn_relu_exactkey_pool(*args)), cuda_ms(
                lambda: bn_relu_exactkey_pool_plain(*args), iters=3)
            one = Work()
            poolkey_work(one, z32, args[5])
            print(f"#18 {label}: pooled, kmax and cnt equal to the plain version (min cnt {float(got[2].min()):.0f}, "
                  f"{float((got[2] > 1).float().mean()):.4f} of the columns tie); time kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {one.record()['bound_ms']:.4f} ms ({one.record()['bound_by']}), plan "
                  f"{poolkey_plan(z32)} ({smi})")
            if short == "SSG":
                records["bn_relu_exactkey_pool"]["ms"] += ms
                records["bn_relu_exactkey_pool"]["plain_ms"] += plain_ms
                poolkey_work(work, z32, args[5])
        calls.clear()
        # 11c. The bf16 step against the plain path; timed beside the f32 step.
        compare_steps(trainer, batches[TRAIN_STEPS], n_zero[model], f"{short} bf16 keys B={b}",
                      grad_tol=BF16_STEP_GRAD_TOL, zero_tol=None)
        time_steps(trainer, state, batches, smi, f"{short} B={b} N={n} bf16 keys")
        f32 = Trainer(TrainerConfig(model=model, batch_size=b, device=str(dev)))
        time_trainers({"bf16 keys": trainer, "f32": f32}, batches, smi, f"{short} B={b} N={n}, kernel path,")
    records["bn_relu_exactkey_pool"].update(work.record())

    # 11b. Steps with the fused tail, f32 and bf16 (native), #17's calls recorded.
    work = Work()
    selected = {"SSG": {(512, 32), (128, 64), (1, 128)}, "MSG": {(512, 128), (128, 128)}}  # (M, K)
    for model in n_zero:
        short = model.split("_")[-1].upper()
        for dtype in ("float32", "bfloat16"):
            trainer = Trainer(TrainerConfig(model=model, batch_size=b, dtype=dtype, pool_precision="native",
                                            fused_sa_train=True, device=str(dev)))
            state = trainer.init_state(seed=0)
            calls.clear()
            with mock.patch.object(satrain, "grouped_bn_mlp_pool_bwd", record(grouped_bn_mlp_pool_bwd)):
                losses, counts = counted_run(base + (grouped_bn_mlp_pool_bwd,), lambda: steps(trainer, state))
            per_step = 3 if short == "SSG" else 7
            print(f"{short} {dtype} fused-tail training main path: losses {[round(v, 6) for v in losses]}, "
                  f"launches {counts}")
            require(all(c > 0 for c in counts.values()) and all(math.isfinite(v) for v in losses)
                    and counts["grouped_bn_mlp_pool_bwd"] == per_step * TRAIN_STEPS,
                    f"the {short} fused-tail path: launches {counts}, losses {losses}")
            for args in calls[:per_step]:
                z1, widths = args[0], [int(g.shape[0]) for g in args[1]]
                mk = tuple(z1.shape[1:3])
                if mk not in selected[short]:
                    continue
                label = f"{short} {dtype} z1 {list(z1.shape)} widths {widths}"
                err = check_satrain_bwd(args, label)
                ms = cuda_ms(lambda: grouped_bn_mlp_pool_bwd(*args), iters=5)
                plain_ms = cuda_ms(lambda: grouped_bn_mlp_pool_bwd_plain(*args), iters=3)
                one = Work()
                satrain_work(one, z1, widths)
                rows, groups = z1[..., 0].numel(), z1.shape[0] * z1.shape[1]
                layout = satrain_plan(groups, z1.shape[2], widths, sm_count(z1.device))
                own = satrain_design_ops(rows, widths, layout)
                three = one.ops_s * F32_OPS_PER_S
                split = satrain_kernel_ms(lambda: grouped_bn_mlp_pool_bwd(*args))
                # The kernel launches what its plan lays out.
                want_launches = {"consts_kernel": 1, "pool_kernel": int(not layout.pool_in_pass),
                                 "combine_kernel": int(layout.pool_segs > 1), "walk_kernel": len(layout.passes),
                                 "reduce_kernel": len(layout.passes) - 1}
                got_launches = {key: split[key]["launches"] for key in SATRAIN_KERNELS}
                require(got_launches == want_launches,
                        f"#17 {label} launched {got_launches}, its plan lays out {want_launches}")
                print(f"time #17 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{one.record()['bound_ms']:.4f} ms ({one.record()['bound_by']}); "
                      f"{three / ms / 1e9:.2f} TFLOP/s of the 3-product work ({three / 1e9:.3f} GFLOP), "
                      f"{own / ms / 1e9:.2f} of its own ({own / 1e9:.3f} GFLOP: rows {layout.rows}, pool in the pass "
                      f"{layout.pool_in_pass}, blocks {[q.blocks for q in layout.passes]}); device ms by kernel "
                      f"{ {key: round(split[key]['ms'], 4) for key in SATRAIN_KERNELS if split[key]['launches']} }, "
                      f"walk passes {[round(v, 4) for v in split['walk_passes_ms']]} ({smi})")
                records["grouped_bn_mlp_pool_bwd"]["max_abs_err"] = max(
                    records["grouped_bn_mlp_pool_bwd"]["max_abs_err"], err)
                if short == "SSG" and dtype == "float32" and mk != (1, 128):  # the record: SA1 + SA2
                    records["grouped_bn_mlp_pool_bwd"]["ms"] += ms
                    records["grouped_bn_mlp_pool_bwd"]["plain_ms"] += plain_ms
                    satrain_work(work, z1, widths)
            calls.clear()
            if dtype == "float32":
                # 11d. Fused against unfused, f32, kernel path; both timed.
                unfused = Trainer(TrainerConfig(model=model, batch_size=b, device=str(dev)))
                compare_steps(trainer, batches[TRAIN_STEPS], n_zero[model], f"{short} f32 fused tail B={b}",
                              grad_tol=FUSED_STEP_GRAD_TOL, against=unfused)
                time_trainers({"fused tail": trainer, "unfused": unfused}, batches, smi, f"{short} B={b} N={n} f32")
                for name, t in (("fused tail", trainer), ("unfused", unfused)):
                    st = t.init_state(seed=0)
                    t.train_step(st, batches[0])
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t.train_step(st, batches[1])
                    torch.cuda.synchronize()
                    print(f"peak memory train step {short} B={b} N={n} f32 {name}: "
                          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB ({smi})")
                    del st
    records["grouped_bn_mlp_pool_bwd"].update(work.record())

    # 11e. SAModule(knn=True, nsample=128): the kNN's k > 64 path, at SSG's SA1 and SA2 shapes.
    bb = SA_LAYER_BATCH
    x = torch.from_numpy(data[np.random.RandomState(18).permutation(len(data))[:bb], :SA_LAYER_POINT]).to(dev)
    gen, stats_rng = torch.Generator().manual_seed(19), np.random.RandomState(20)
    layers = {}
    for label, args in (("SA1 knn K128", (512, None, 128, (64, 64, 128), 0, False, True)),
                        ("SA2 knn K128", (128, None, 128, (128, 128, 256), 128, False, True))):
        f32 = init_params(SAModule(*args), gen)
        with torch.no_grad():
            for key, buf in f32.named_buffers():
                vals = stats_rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
        bf16 = SAModule(*args, dtype=torch.bfloat16)
        bf16.load_state_dict(f32.state_dict())
        layers[label] = {"f32": f32.to(dev).eval(), "bf16": bf16.to(dev).eval()}
    with torch.no_grad():
        l1_xyz, l1_points = layers["SA1 knn K128"]["f32"](x, None)
    inputs = {"SA1": (x, None), "SA2": (l1_xyz, l1_points.contiguous())}

    def run():
        return {(label, name): m(*inputs[label[:3]]) for label, ms in layers.items() for name, m in ms.items()}

    counters = (fps, knn_point_kernel, sa_mlp_pool)
    with torch.no_grad():
        got, counts = counted_run(counters, run)
        sorted_launches = knn_point_kernel.sort_launches
        with plain_path():
            ref = run()
    print(f"SAModule knn K=128 inference B={bb} (two layers, f32 and bf16): launches {counts}, "
          f"of them the kNN's sort {sorted_launches}")
    require(all(c > 0 for c in counts.values()) and sorted_launches == 4, f"SAModule knn K=128 launches {counts}")
    for key, (new_xyz, pooled) in got.items():
        require(torch.equal(new_xyz, ref[key][0]) and bool(torch.isfinite(pooled.float()).all()),
                f"SAModule knn K=128 output ({key})")
        check_pooled(pooled, ref[key][1], pooled.dtype, f"SAModule {key[0]} {key[1]} B={bb} against the plain path")
    work = Work()
    for layer, (xyz, _) in inputs.items():
        npoint = 512 if layer == "SA1" else 128
        _, q = fps_plain(xyz, npoint)
        args = (q.contiguous(), xyz.contiguous(), 128)
        d, i = knn_point_kernel(*args)
        ref_d, ref_i = knn_point_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(i, ref_i) and torch.equal(d, ref_d), f"the k=128 kNN differs from knn_point_plain ({layer})")
        ms, plain_ms = cuda_ms(lambda: knn_point_kernel(*args)), cuda_ms(lambda: knn_point_plain(*args), iters=3)
        print(f"knn k=128 {layer} B={bb} M{q.shape[1]} N{xyz.shape[1]}: idx and d2 equal to knn_point_plain; time "
              f"kernel {ms:.4f} ms (device {device_ms(lambda: knn_point_kernel(*args)):.4f}), plain {plain_ms:.4f} ms "
              f"({smi})")
        records["knn_point_sorted"]["ms"] += ms
        records["knn_point_sorted"]["plain_ms"] += plain_ms
        knn_work(work, q, xyz, 128)
    records["knn_point_sorted"].update(work.record())
    return records


class CardDecisions:
    """The card's relu gates and max-pool winners, fed to the CPU.  Inside
    ``with``, ``torch.relu`` records each call's mask (x > 0, on the CPU)
    and ``F.max_pool3d`` its winners' indices; or, given ``feed`` (a
    recording), ``torch.relu`` applies the recorded masks and
    ``F.max_pool3d`` takes the recorded winners, call by call, and each
    gate or winner where the two differ must lie within PN_GATE_MARGIN x
    max(1, |x|max of the call) of 0 or of the CPU's own winner (their
    count in ``flips``)."""

    def __init__(self, feed: "CardDecisions | None" = None):
        self.feeding = feed is not None
        self.masks, self.winners = (feed.masks, feed.winners) if feed is not None else ([], [])
        self.flips = self.relus = self.pools = 0

    def _near(self, differ, gap, x) -> None:
        if bool(differ.any()):
            self.flips += int(differ.sum())
            worst, scale = float(gap[differ].abs().max()), max(1.0, float(x.abs().max()))
            require(worst <= PN_GATE_MARGIN * scale, f"a decision differs by {worst} between the card and the CPU")

    def relu(self, x):
        import torch

        if not self.feeding:
            self.masks.append((x.detach() > 0).cpu())
            return self.real_relu(x)
        mask = self.masks[self.relus]
        self.relus += 1
        require(mask.shape == x.shape, f"relu gates: the call shapes differ, {tuple(mask.shape)} {tuple(x.shape)}")
        self._near(mask != (x.detach() > 0), x.detach(), x.detach())
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype))

    def max_pool3d(self, x, kernel_size, stride=None):
        if not self.feeding:
            out, idx = self.real_pool(x, kernel_size, stride, return_indices=True)
            self.winners.append(idx.cpu())
            return out
        idx = self.winners[self.pools]
        self.pools += 1
        out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        own = self.real_pool(x.detach(), kernel_size, stride)
        self._near(own != out.detach(), own - out.detach(), x.detach())
        return out

    def __enter__(self):
        import torch

        self.real_relu, self.real_pool = torch.relu, torch.nn.functional.max_pool3d
        self.patches = [mock.patch.object(torch, "relu", self.relu),
                        mock.patch.object(torch.nn.functional, "max_pool3d", self.max_pool3d)]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()
        if self.feeding and exc[0] is None:
            require((self.relus, self.pools) == (len(self.masks), len(self.winners)),
                    f"card decisions: {self.relus} relus and {self.pools} pools fed {len(self.masks)} and "
                    f"{len(self.winners)}")


def random_stats(model, rng) -> None:
    """Random positive BN running stats (phase 3's draw) into ``model``."""
    import numpy as np
    import torch

    with torch.no_grad():
        for key, buf in model.named_buffers():
            if key.endswith((".mean", ".var")):
                vals = rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))


def pointnet_phase(smi: str, dev) -> None:
    """Phase 16 (module doc): the PointNet family and 3DmFV-Net."""
    import copy
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from profile_forward import profile_one
    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.pipeline import EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import ThreeDmFVNet, get_model
    from scanobjectnn_torch.nn.fisher import fisher_vector
    from scanobjectnn_torch.ops import exactpool
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool, bn_relu_exactkey_pool_plain
    from scanobjectnn_torch.train import cli
    from scanobjectnn_torch.train import trainer as trainer_module
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    # Clouds in the unit cube (with parts), and the same with a quarter of
    # each cloud moved to background points 2-3 away (with masks) for
    # pointnet_seg.  3DmFV takes only the first: a point beyond its grid
    # GMM's reach (every posterior underflowing to 0) makes the Fisher
    # vector 0/0, in the JAX package as here.
    view, masked = (EpochSampler(*arrays[:2], num_points=PN_POINT, seed=0, parts=arrays[-1],
                                 masks=convert_to_binary_mask(arrays[2]).astype(np.int64) if bg else None).epoch()
                    for bg in (False, True)
                    for arrays in [make_synthetic_dataset(num_per_class=5, num_classes=NUM_CLASSES,
                                                          num_points=2 * PN_POINT, seed=16, with_mask=bg,
                                                          with_parts=True)])
    require(len(view["points"]) >= PN_TRAIN_BATCH, "too few clouds for phase 16")
    x_cpu = torch.from_numpy(view["points"][:PN_BATCH])
    x = x_cpu.to(dev)

    # 16a. Inference: the card against the CPU on the same weights.
    stats_rng = np.random.RandomState(17)
    card_fv = None
    for name in PN_NAMES + ("3dmfv_net_cls",):
        dtypes = {"f32": None, "bf16": torch.bfloat16}
        stats_state = None
        for dname, dtype in dtypes.items():
            cpu = get_model(name, generator=torch.Generator().manual_seed(0), device="cpu", dtype=dtype).eval()
            if stats_state is None:
                random_stats(cpu, stats_rng)
                stats_state = {k: v.clone() for k, v in cpu.state_dict().items()}
            cpu.load_state_dict(stats_state)
            card = copy.deepcopy(cpu).to(dev)
            xc = torch.from_numpy(masked["points"][:PN_BATCH]) if name == "pointnet_seg" else x_cpu
            xd = xc.to(dev)
            with torch.no_grad():
                want, got = cpu(xc), card(xd)
            for key in ("logits", "seg_logits"):
                if key not in want:
                    continue
                g, w = got[key].cpu(), want[key]
                require(g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g.float()).all()),
                        f"{name} {dname} {key}: {tuple(g.shape)} {g.dtype}")
                require(float(w.float().abs().max()) > 0.1, f"{name} {dname} {key} vanished")
                if dname == "bf16":
                    err, _ = check_bf16(g, w, PN_BF16_ULPS, f"{name} bf16 card against the CPU: {key}", share=1.0)
                else:
                    err, tol = float((g - w).abs().max()), F32_LOGIT_TOL * scale_of(w)
                    print(f"{name} f32 card against the CPU: {key} max abs err {err:.3e} (bound {tol:.3e})")
                    require(err <= tol, f"{name} f32 {key} on the card differs from the CPU: {err} > {tol}")
                agree = float((g.float().argmax(-1) == w.float().argmax(-1)).float().mean())
                if name == "3dmfv_net_cls" and dname == "bf16":
                    # The module's note above PN_BATCH: the classes agree
                    # where the CPU's top two logits lie farther apart than
                    # both sides moved.
                    top2 = w.float().topk(2, dim=-1).values
                    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
                    same = g.float().argmax(-1) == w.float().argmax(-1)
                    print(f"{name} bf16: logits argmax agreement with the CPU {agree:.4f}; {int((~clear).sum())} of "
                          f"{len(clear)} clouds' top two logits within twice the largest error {err:.3e}, the "
                          f"others all agreeing: {bool(same[clear].all())}")
                    require(bool(same[clear].all()), f"{name} bf16 classes differ where the top two logits are clear")
                    continue
                need = SEG_AGREEMENT if key == "seg_logits" else (1.0 if dname == "f32" else BF16_CLASS_AGREEMENT)
                print(f"{name} {dname}: {key} argmax agreement with the CPU {agree:.4f} (bound {need})")
                require(agree >= need, f"{name} {dname} {key} agreement {agree}")
            with torch.no_grad():
                ms = cuda_ms(lambda: card(xd))
            print(f"time forward {name} {dname} B={PN_BATCH} N={PN_POINT}: {ms:.4f} ms "
                  f"({PN_BATCH / ms * 1e3:.1f} clouds/s) ({smi})")
            if name == "3dmfv_net_cls" and dname == "f32":
                card_fv, fv_logits = card, got["logits"]

    marks = {"a": time.perf_counter()}
    # 16b. TF32: 3DmFV's f32 logits do not change with cuDNN's TF32 flag on.
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            again = card_fv(x)["logits"]
        require(torch.backends.cudnn.allow_tf32, "the model did not put cuDNN's TF32 flag back")
        conv = card_fv.inception3.conv3.Conv_0
        probe = torch.randn(PN_BATCH, 5, 5, 5, conv.kernel.shape[3], generator=torch.Generator().manual_seed(3)).to(dev)
        with torch.no_grad():
            scoped = conv(probe)
            w = conv.kernel.permute(4, 3, 0, 1, 2)
            pad = conv.kernel.shape[0] // 2
            unscoped = torch.nn.functional.conv3d(probe.permute(0, 4, 1, 2, 3), w, conv.bias, padding=pad)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        exact = torch.nn.functional.conv3d(probe.permute(0, 4, 1, 2, 3), w, conv.bias, padding=pad)
    require(torch.equal(again, fv_logits), "3dmfv_net_cls's f32 logits changed with cuDNN's TF32 flag on")
    require(torch.equal(scoped.permute(0, 4, 1, 2, 3), exact), "_Conv ran differently from an f32 conv3d")
    print(f"3dmfv_net_cls f32 logits with cudnn.allow_tf32 True: equal bit for bit to the flag off; an unscoped "
          f"conv3d (inception3.conv3, 5^3 kernel, {conv.kernel.shape[3]} -> {conv.kernel.shape[4]}) with TF32 on "
          f"differs from f32 by {float((unscoped - exact).abs().max()):.3e} (scale {scale_of(exact):.3e})")

    marks["b"] = time.perf_counter()
    # 16c. bf16 PointNet steps, exact-key pooling: #18 three times a step.
    calls = []

    def recorder(*args):
        calls.append(clone_args(args))
        return bn_relu_exactkey_pool(*args)

    batch = {k: masked[k][:PN_BATCH] for k in ("points", "labels", "masks")}
    batch2 = {k: masked[k][PN_BATCH:2 * PN_BATCH] for k in ("points", "labels", "masks")}
    work, pooled_ms, pooled_plain_ms = Work(), 0.0, 0.0
    for name, n_zero in (("pointnet_cls", 17), ("pointnet_seg", 21)):
        trainer = Trainer(TrainerConfig(model=name, batch_size=PN_BATCH, dtype="bfloat16", device=str(dev)))
        require(trainer.pool_mode == "keys", f"bf16 pool_precision 'auto' resolved to {trainer.pool_mode}")
        state = trainer.init_state(seed=0)
        calls.clear()
        with mock.patch.object(exactpool, "bn_relu_exactkey_pool", recorder):
            (_, metrics), counts = counted_run((bn_relu_exactkey_pool,), lambda: trainer.train_step(state, batch))
        loss = float(metrics["loss"])
        print(f"{name} bf16 (keys) training step B={PN_BATCH}: loss {loss:.6f}, launches {counts}")
        require(counts["bn_relu_exactkey_pool"] == 3 and math.isfinite(loss), f"{name} bf16 step: {counts}, {loss}")
        for i, args in enumerate(calls):
            got, want = bn_relu_exactkey_pool(*args), bn_relu_exactkey_pool_plain(*args)
            torch.cuda.synchronize()
            label = f"{name} bf16 call {i} z32 {list(args[0].shape)}"
            require(all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)),
                    f"#18 differs from its plain version ({label})")
            ms = cuda_ms(lambda: bn_relu_exactkey_pool(*args))
            plain_ms = cuda_ms(lambda: bn_relu_exactkey_pool_plain(*args), iters=3)
            one = Work()
            poolkey_work(one, args[0], args[5])
            if name == "pointnet_cls":
                poolkey_work(work, args[0], args[5])
                pooled_ms, pooled_plain_ms = pooled_ms + ms, pooled_plain_ms + plain_ms
            print(f"#18 {label}: pooled, kmax and cnt equal to the plain version ({float((got[2] > 1).float().mean()):.4f} "
                  f"of the columns tie); time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{one.record()['bound_ms']:.4f} ms ({one.record()['bound_by']}), plan {poolkey_plan(args[0])} ({smi})")
        calls.clear()
        compare_steps(trainer, batch2, n_zero, f"{name} bf16 keys B={PN_BATCH}", grad_tol=BF16_STEP_GRAD_TOL,
                      zero_tol=None)
        f32 = Trainer(TrainerConfig(model=name, batch_size=PN_BATCH, device=str(dev)))
        time_trainers({"bf16 keys": trainer, "f32": f32}, [batch, batch2, batch], smi,
                      f"{name} B={PN_BATCH} N={PN_POINT}")
    print(f"#18 over one bf16 pointnet_cls step's three calls (B={PN_BATCH}, K=N={PN_POINT}, C=1024): kernel "
          f"{pooled_ms:.4f} ms, plain {pooled_plain_ms:.4f} ms, bound {work.record()['bound_ms']:.4f} ms "
          f"({work.record()['bound_by']}) ({smi})")

    marks["c"] = time.perf_counter()
    # 16d. f32 steps at B=64, the card against the CPU.
    def step(where: str, name: str, kw: dict, tbatch: dict, gates):
        trainer = Trainer(TrainerConfig(model=name, batch_size=PN_TRAIN_BATCH, model_kwargs=kw,
                                        device=str(dev) if where == "card" else "cpu"))
        st = trainer.init_state(seed=1)
        for module in st.model.modules():
            if hasattr(module, "dropout_keep"):
                module.dropout_keep = 1.0
        with gates:
            st, metrics = trainer.train_step(st, tbatch)
        persistent = st.model.state_dict()
        return trainer, st, (float(metrics["loss"]),
                             {n: None if p.grad is None else p.grad.float().cpu() for n, p in st.model.named_parameters()},
                             {n: b.cpu() for n, b in st.model.named_buffers() if n in persistent})

    with mock.patch.object(trainer_module, "standard_train_augment", lambda points, generator: points):
        for name, kw, n_zero in (("pointnet_cls", {}, 17), ("pointnet_partseg", {}, 19), ("3dmfv_net_cls", {}, 23),
                                 ("3dmfv_net_cls", PN_LEARNABLE_GMM, 23)):
            label = f"{name}{' learnable_gmm 3^3' if kw else ''} f32 B={PN_TRAIN_BATCH}"
            keys = ("points", "parts") if name == "pointnet_partseg" else ("points", "labels")
            tbatch = {k: view[k][:PN_TRAIN_BATCH] for k in keys}
            if name == "3dmfv_net_cls":
                gmm = ThreeDmFVNet(**kw).gmm_params()
                zeros = int((fisher_vector(torch.from_numpy(tbatch["points"]), *gmm) == 0).sum())
                print(f"{label}: {zeros} Fisher vector features exactly 0 (sign·sqrt has a NaN gradient at 0)")
                require(zeros == 0 or not kw, f"{label}: a zero Fisher vector feature would make the GMM's gradient NaN")
            record = CardDecisions()
            card_trainer, card_state, (loss_c, grads_c, stats_c) = step("card", name, kw, tbatch, record)
            torch.cuda.synchronize()
            feed = CardDecisions(feed=record)
            _, _, (loss_p, grads_p, stats_p) = step("cpu", name, kw, tbatch, feed)
            del record
            rule = fv_feeds_train_bn if name == "3dmfv_net_cls" else feeds_train_bn
            no_grad = [n for n in grads_p if grads_p[n] is None]
            zero = [n for n in grads_p if rule(n) and n not in no_grad]
            require(len(zero) == n_zero, f"{label}: expected {n_zero} biases before a BN, found {len(zero)}")
            require(all(grads_c[n] is None for n in no_grad), f"{label}: gradients on the card where the CPU has none")
            loss_err = abs(loss_c - loss_p) / abs(loss_p)
            grad_err, worst = max((float((grads_c[n] - grads_p[n]).abs().max()) / scale_of(grads_p[n]), n)
                                  for n in grads_p if n not in zero and n not in no_grad)
            zero_max = max(float(g[n].abs().max()) for g in (grads_c, grads_p) for n in zero)
            stat_err = max(float((stats_c[n] - stats_p[n]).abs().max()) / scale_of(stats_p[n]) for n in stats_p)
            print(f"train step {label}, card against the CPU: loss {loss_c:.7f} vs {loss_p:.7f} (rel err "
                  f"{loss_err:.3e}, bound {PN_STEP_LOSS_RTOL}); largest error / scale: gradients {grad_err:.3e} "
                  f"({worst}), BN stats {stat_err:.3e} (bound {TRAIN_GRAD_TOL}); the {n_zero} biases before a BN: "
                  f"max |grad| {zero_max:.3e} (bound {ZERO_GRAD_TOL}); {len(no_grad)} parameters without a "
                  f"gradient on both; the card's relu gates and max-pool winners fed to the CPU, {feed.flips} "
                  f"differing within rounding")
            require(loss_err <= PN_STEP_LOSS_RTOL, f"{label}: the loss differs from the CPU's")
            require(grad_err <= TRAIN_GRAD_TOL and stat_err <= TRAIN_GRAD_TOL,
                    f"{label}: gradients or BN stats differ from the CPU's")
            require(zero_max <= ZERO_GRAD_TOL, f"{label}: a bias before a BN has a gradient far from 0")
            res = profile_one(lambda: card_trainer.train_step(card_state, tbatch), 3)
            print(f"time train step {label}: host wall {res['host_wall_ms']:.4f} ms, {res['kernels']:.0f} kernels, "
                  f"device busy {res['device_busy_ms']:.4f} ms, idle share {res['idle_share_of_window']:.4f} ({smi})")
            if name == "3dmfv_net_cls":
                # Two equal steps on the card: equal bits in the loss, every
                # gradient and every BN statistic (cuDNN's deterministic
                # algorithms, the pool's backward without atomics), and the
                # caller's cuDNN flags as they were.
                cudnn = torch.backends.cudnn
                flags = (cudnn.allow_tf32, cudnn.deterministic)
                (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = (
                    step("card", name, kw, tbatch, contextlib.nullcontext())[2] for _ in range(2))
                differing = (["loss"] if loss_a != loss_b else []) + [
                    n for n in grads_a if (grads_a[n] is None) != (grads_b[n] is None)
                    or (grads_a[n] is not None and not torch.equal(grads_a[n], grads_b[n]))] + [
                    n for n in stats_a if not torch.equal(stats_a[n], stats_b[n])]
                print(f"{label}: two equal card steps: the loss, {len(grads_a)} gradients and {len(stats_a)} BN "
                      f"statistics " + ("equal bit for bit" if not differing else
                                        f"DIFFER ({len(differing)}, e.g. {differing[:3]})")
                      + f"; cuDNN allow_tf32, deterministic {flags} before and "
                        f"{(cudnn.allow_tf32, cudnn.deterministic)} after")
                require(not differing, f"{label}: two equal card steps differ in {differing}")
                require((cudnn.allow_tf32, cudnn.deterministic) == flags, f"{label}: the cuDNN flags changed")
                model = card_state.model.eval()
                points = torch.from_numpy(view["points"][:PN_TRAIN_BATCH]).to(dev)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                with torch.no_grad():
                    model(points)
                torch.cuda.synchronize()
                print(f"{label}: eval forward peak memory {(torch.cuda.max_memory_allocated() - base) / 2 ** 20:.1f} "
                      f"MiB above the {base / 2 ** 20:.1f} MiB held ({smi})")
            del card_trainer, card_state
            if name == "3dmfv_net_cls":
                # The bf16 step (no kernel of the repo's on this path):
                # against the plain path, two equal steps bit-equal, timed
                # beside the f32 step.
                bf16_steps(name, [tbatch, tbatch], dev, smi, (), 2, label.replace(" f32", ""),
                           batch_size=PN_TRAIN_BATCH, model_kwargs=kw)

    marks["d"] = time.perf_counter()
    # 16e. The command line on raw .bin clouds.
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            listing, _, _ = write_bin_clouds(tmp, np.random.RandomState(15), count=CLI_CLOUDS)
            files = ["--train_file", os.path.basename(listing), "--test_file", os.path.basename(listing)]
            for model, extra in (("pointnet_cls", ["--dtype", "bfloat16"]), ("3dmfv_net_cls", [])):
                log = f"log_{model}"
                argv = (["train", "--model", model, "--num_point", str(PN_POINT), "--batch_size", str(TRAIN_BATCH),
                         "--max_epoch", "1", "--log_dir", log] + extra + files)
                t0 = time.perf_counter()
                _, counts = counted_run((bn_relu_exactkey_pool,), lambda: cli.main(argv))
                secs = time.perf_counter() - t0
                with open(os.path.join(log, "log_train.txt")) as f:
                    epochs = re.findall(r"^epoch \d+ .*$", f.read(), re.M)
                with open(os.path.join(log, "metrics.jsonl")) as f:
                    records = [json.loads(line) for line in f]
                require(len(epochs) == 1 and [r["epoch"] for r in records] == [0]
                        and os.path.isdir(os.path.join(log, "checkpoint")),
                        f"cli {model}: epochs {epochs}, metrics {records}, {os.listdir(log)}")
                if "bfloat16" in extra:
                    require(counts["bn_relu_exactkey_pool"] > 0, f"the bf16 pointnet_cls run never launched #18")
                print(f"cli {' '.join(argv)}: {secs:.2f} s wall, {epochs[0]!r}, metrics.jsonl epoch 0 (eval "
                      f"{records[0]['eval_seconds']:.3f} s), checkpoint/ written, #18 launches "
                      f"{counts['bn_relu_exactkey_pool']} ({smi})")
        finally:
            os.chdir(old_cwd)
    marks["e"] = time.perf_counter()
    starts = [t_phase] + list(marks.values())[:-1]
    print(f"phase 16: {marks['e'] - t_phase:.1f} s (" + ", ".join(
        f"{k} {t - t0:.1f} s" for (k, t), t0 in zip(marks.items(), starts)) + f") ({smi})")


def range_phase(smi: str, dev) -> dict:
    """Phase 13 (module doc): the ranges the card once refused.  Returns
    the new routes' launches on their main paths, by counter and route."""
    import numpy as np
    import torch

    from scanobjectnn_torch import ops
    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.ops.cuda.edge_kernel import (
        edge_gather_knn, edge_reduce, edge_reduce_bwd_kernel, edge_reduce_bwd_ordered, edge_reduce_fwd_kernel,
    )
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import (
        knn_graph_kernel, knn_graph_plain, knn_point_kernel, knn_point_plain,
    )
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    g = torch.Generator(device=dev).manual_seed(13)

    # 13a. FPS above 8192 points through ops (a raw scan's size), counted.
    b, n, m = RANGE_FPS
    big = torch.randn(b, n, 3, device=dev, generator=g) * 0.5
    (idx, new_xyz), counts = counted_run((fps,), lambda: ops.farthest_point_sample_with_coords(big, m))
    only_idx, more = counted_run((fps,), lambda: ops.farthest_point_sample(big, m))
    require(fps.large_launches == 1, f"FPS at N={n} did not take the large-cloud kernel: {counts}, {more}")
    ref_idx, ref_xyz = fps_plain(big, m)
    torch.cuda.synchronize()
    require(torch.equal(idx, ref_idx) and torch.equal(new_xyz, ref_xyz) and torch.equal(only_idx, ref_idx),
            f"FPS at N={n} differs from fps_plain")
    lattice = (torch.randint(-3, 4, (2, n // 8, 3), device=dev, generator=g).float() * 0.25).repeat(1, 8, 1)
    lattice = lattice[:, torch.randperm(n, device=dev, generator=g)].contiguous()
    lattice[1, n // 3, 0] = float("nan")
    check_fps(lattice, 256, f"N={n} duplicated lattice points and a NaN row", fps, fps_plain)
    work = Work()
    fps_work(work, b, n, m)
    ms = cuda_ms(lambda: fps(big, m), iters=3)
    print(f"fps B={b} N={n} -> {m}: indices and coordinates equal to fps_plain; launches {counts} "
          f"(large-cloud kernel); time {ms:.4f} ms, plain {cuda_ms(lambda: fps_plain(big, m), iters=1):.4f} ms, "
          f"bound {work.record()['bound_ms']:.4f} ms ({work.record()['bound_by']}) ({smi})")

    # 13b. The general kNN at k = 128 on N = 50000 keys (sorted tiles merged).
    b, mq, n, k = RANGE_KNN
    keys = torch.rand(b, n, 3, device=dev, generator=g) * 2 - 1
    queries = keys[:, torch.randperm(n, device=dev, generator=g)[:mq]] + 0.01
    (d, i), counts = counted_run((knn_point_kernel,), lambda: knn_point_kernel(queries, keys, k))
    require(knn_point_kernel.tiled_launches == 1, f"kNN at N={n} did not merge sorted tiles: {counts}")
    ref_d, ref_i = knn_point_plain(queries, keys, k)
    torch.cuda.synchronize()
    require(torch.equal(i, ref_i) and torch.equal(d, ref_d), f"kNN at N={n}, k={k} differs from knn_point_plain")
    work = Work()
    knn_work(work, queries, keys, k)
    ms = cuda_ms(lambda: knn_point_kernel(queries, keys, k), iters=3)
    print(f"knn_point B={b} M={mq} N={n} k={k}: indices and distances equal to knn_point_plain; time {ms:.4f} ms, "
          f"plain {cuda_ms(lambda: knn_point_plain(queries, keys, k), iters=1):.4f} ms, bound "
          f"{work.record()['bound_ms']:.4f} ms ({work.record()['bound_by']}) ({smi})")

    # 13b'. k = 20000 on the same keys: the selected words past a block's
    # shared memory, the full sort's route (three queries; the bias from a
    # generator of its own, so that the draws after it stay as they were).
    kf = RANGE_FULLSORT_K
    few = queries[:, :3].contiguous()
    bias = torch.rand(b, n, device=dev, generator=torch.Generator(device=dev).manual_seed(131)) * 0.1
    (d, i), counts = counted_run((knn_point_kernel,), lambda: knn_point_kernel(few, keys, kf, bias))
    require(knn_point_kernel.fullsort_launches == 1 and knn_point_kernel.tiled_launches == 1,
            f"kNN at N={n}, k={kf} did not take the full sort over merged tiles: {counts}")
    ref_d, ref_i = knn_point_plain(few, keys, kf, bias)
    torch.cuda.synchronize()
    require(torch.equal(i, ref_i) and torch.equal(d, ref_d), f"kNN at N={n}, k={kf} differs from knn_point_plain")
    print(f"knn_point B={b} M=3 N={n} k={kf} with a bias: the full sort (the selected words do not fit a block), "
          f"equal to knn_point_plain; time {cuda_ms(lambda: knn_point_kernel(few, keys, kf, bias), iters=3):.4f} ms "
          f"({smi})")

    # 13c. The self-kNN graph above k = 32 (the general kernel) at DGCNN's
    # shapes, on duplicated points, and at k = 100 (the sort).
    bg, ng, kg = DGCNN_BATCH, DGCNN_POINT, RANGE_GRAPH_K
    lat = (torch.randint(-3, 4, (bg, ng // 8, 3), device=dev, generator=g).float() * 0.25).repeat(1, 8, 1)
    for label, feats, kk in (
        ("C=3", torch.randn(bg, ng, 3, device=dev, generator=g), kg),
        ("C=64", torch.randn(bg, ng, 64, device=dev, generator=g), kg),
        ("duplicated lattice points C=3", lat[:, torch.randperm(ng, device=dev, generator=g)].contiguous(), kg),
        ("C=64", torch.randn(4, ng, 64, device=dev, generator=g), 100),
    ):
        idx, counts = counted_run((knn_graph_kernel,), lambda: knn_graph_kernel(feats, kk))
        require(knn_graph_kernel.routed_launches == 1, f"the graph at k={kk} did not take the general kernel")
        require(torch.equal(idx, knn_graph_plain(feats, kk)), f"the graph at k={kk} differs ({label})")
        work = Work()
        graph_work(work, feats, kk)
        ms = device_ms(lambda: knn_graph_kernel(feats, kk))
        print(f"knn_graph {label} B={feats.shape[0]} N={ng} k={kk}: indices equal to the plain version; device "
              f"time {ms:.4f} ms, bound {work.record()['bound_ms']:.4f} ms ({work.record()['bound_by']}) ({smi})")

    # 13d. dgcnn with k = 40: inference (f32, bf16) and a training step,
    # against the plain path by the DGCNN gates.
    data, labels = make_synthetic_dataset(num_per_class=5, num_classes=NUM_CLASSES, num_points=2 * ng, seed=4)
    batches = list(Batches(EpochSampler(data, labels, num_points=ng, seed=0).epoch(), bg))
    x = torch.from_numpy(batches[0]["points"]).to(dev)
    models = eval_models("dgcnn", np.random.RandomState(13), k=kg)
    graph_counters = (knn_graph_kernel, edge_reduce_fwd_kernel, edge_gather_knn, gather_rows)
    check_inference(models, x, graph_counters, smi, f"dgcnn k={kg}")
    trainer = Trainer(TrainerConfig(model="dgcnn", batch_size=bg, model_kwargs={"k": kg}, device=str(dev)))
    state = trainer.init_state(seed=0)
    counters = graph_counters + (edge_reduce_bwd_kernel, scatter_add_rows)
    losses, counts = counted_run(counters, lambda: [float(trainer.train_step(state, batches[0])[1]["loss"])])
    routed = knn_graph_kernel.routed_launches
    print(f"dgcnn k={kg} training main path: loss {losses}, launches {counts}, of the graph's {routed} "
          f"through the general kNN kernel")
    require(all(c > 0 for c in counts.values()) and routed == counts["knn_graph_kernel"],
            f"a kernel of the dgcnn k={kg} training path never launched: {counts}")
    require(all(math.isfinite(v) for v in losses), f"non-finite dgcnn k={kg} training loss: {losses}")
    compare_steps(trainer, batches[1], 12, f"dgcnn k={kg} B={bg}")

    # 13e. The EdgeConv backward on clouds one point too large for one
    # channel's staged slice: the per-edge route.
    b, n, cv = RANGE_EDGE
    feats = torch.randn(b, n, 3, device=dev, generator=g)
    vals = torch.randn(b, n, cv, device=dev, generator=g)
    red = edge_reduce(feats, vals, DGCNN_K)
    saved = (vals, red["idx"], red["mmax"], red["mmin"], red["cntmax"], red["cntmin"])
    cot = [torch.randn(b, n, cv, device=dev, generator=g) for _ in range(4)]
    dvals, counts = counted_run((edge_reduce_bwd_kernel,), lambda: edge_reduce_bwd_kernel(*saved, *cot))
    require(edge_reduce_bwd_kernel.routed_launches == 1, f"the backward at N={n} did not take the per-edge route")
    require(torch.equal(dvals, edge_reduce_bwd_ordered(*saved, *cot)),
            f"the backward at N={n} differs from edge_reduce_bwd_ordered")
    print(f"edge_reduce backward B={b} N={n} k={DGCNN_K} Cv={cv}: per-edge route, equal to edge_reduce_bwd_ordered; "
          f"device time {device_ms(lambda: edge_reduce_bwd_kernel(*saved, *cot)):.4f} ms ({smi})")
    return {"fps": {"large_launches": LAUNCH_ROUTES["fps.large_launches"]},
            "knn_graph": {"routed_launches": LAUNCH_ROUTES["knn_graph_kernel.routed_launches"]},
            "knn_point": {"warp_launches": LAUNCH_ROUTES["knn_point_kernel.warp_launches"]},
            "knn_point_sorted": {"tiled_launches": LAUNCH_ROUTES["knn_point_kernel.tiled_launches"],
                                 "fullsort_launches": LAUNCH_ROUTES["knn_point_kernel.fullsort_launches"]},
            "edge_reduce_bwd": {"routed_launches": LAUNCH_ROUTES["edge_reduce_bwd_kernel.routed_launches"]},
            "edge_gather_knn": {"fused_launches": LAUNCH_ROUTES["edge_gather_knn.fused_launches"],
                                "routed_launches": LAUNCH_ROUTES["edge_gather_knn.routed_launches"]}}


# Data parallelism (phase 17): the global batch of the SSG and BGA steps
# (phase 4's and 5's B=16, N=1024), two momentum steps; SSG f32 with the
# fused SA training tail (#17's backward), SSG bf16 with exact-key pooling
# (#18), so both kernels run under the group.  17a: a group of one rank
# (NCCL) against no group: bit for bit.  17b: two gloo ranks on the one
# card (NCCL refuses two ranks on one device), each B/2, against one
# process on B; every kernel launches on the ranks as often as in the one
# process.  A step is read by its update (``dp_update_reading``): the
# change it made to the parameters, and to the BN statistics, each as one
# vector against the one process's change, the distance's L2 norm over the
# reference change's, and the loss over its magnitude.  Rounding moves a few
# channels far (E[x²] - E[x]² cancels where a channel's mean is large
# against its spread: a 2-ulp nudge of the moments moved the largest entry
# of some step-1 updates by half their largest), so no entry is held alone;
# a fault moves the whole update.  f32: each step's loss and updates within
# DP_STEP_LIMITS; step 2's are loose: it starts from states that already
# differ by that rounding, which ``dgcnn_bga``'s BNs over 16 clouds amplify
# (on an H100 a nudge moved its step-2 update by 0.67 of its norm), so the
# gate bites at step 1.
# bf16: the ranks' moments round otherwise than one process's,
# which moves bf16 roundings, so each step's update and loss are held
# against the one-process f32 step, no farther from it than
# BF16_TENSOR_RATIO times the one-process bf16 step (the mixed-train rule),
# or within DP_STEP_LIMITS.  Printed beside every limit: the reading of the
# one process with its BN moments nudged by DP_NUDGE (two f32 ulps,
# ``dp_nudged_moments``), what a rounding of the moments alone moves; and
# of three planted faults on the same two ranks (``DP_CONTROLS``): the
# BatchNorms' group taken away (local moments), no gradient average, each
# rank's own draws (no ``global_batch``).  Each control must fail the
# comparison of its case.  A rank that has not finished within
# DP_JOIN_TIMEOUT seconds is killed and fails the phase; 17c's command
# within DP_CLI_TIMEOUT.
DP_BATCH, DP_POINT, DP_STEPS, DP_WORLD = 16, 1024, 2, 2
DP_CASES = (("pointnet2_cls_ssg", "float32"), ("pointnet2_cls_ssg", "bfloat16"), ("dgcnn_bga", "float32"))
DP_CONTROLS = {"local_bn": ("pointnet2_cls_ssg float32", "pointnet2_cls_ssg bfloat16", "dgcnn_bga float32"),
               "no_average": ("pointnet2_cls_ssg float32", "dgcnn_bga float32"),
               "local_draws": ("pointnet2_cls_ssg float32", "dgcnn_bga float32")}
DP_STEP_LIMITS = ((1e-3, 0.2), (1e-2, 1.0))  # (loss, update) relative distances, steps 1 and 2
DP_JOIN_TIMEOUT, DP_CLI_TIMEOUT = 420, 300
DP_TIMED_STEPS = 3
DP_NUDGE = 2.0 ** -22


def dp_counters():
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group
    from scanobjectnn_torch.ops.cuda.edge_kernel import edge_gather_knn, edge_reduce_bwd_kernel, edge_reduce_fwd_kernel
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_kernel
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool
    from scanobjectnn_torch.ops.cuda.satrain_kernel import grouped_bn_mlp_pool_bwd

    return (fps, query_ball_group, gather_rows, scatter_add_rows, knn_graph_kernel, edge_reduce_fwd_kernel,
            edge_reduce_bwd_kernel, edge_gather_knn, bn_relu_exactkey_pool, grouped_bn_mlp_pool_bwd)


def dp_spec() -> dict:
    """Phase 17's batches (the global batch of each step, with masks) and
    trainer configurations."""
    import numpy as np

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset

    data, labels, masks = make_synthetic_dataset(num_per_class=3, num_classes=NUM_CLASSES, num_points=DP_POINT,
                                                 seed=17, with_mask=True)
    order = np.random.RandomState(17).permutation(len(data))
    batches = []
    for i in range(DP_STEPS):
        rows = order[i * DP_BATCH:(i + 1) * DP_BATCH]
        batches.append({"points": data[rows], "labels": labels[rows], "masks": (masks[rows] >= 0).astype(np.int64)})
    configs = {f"{m} {d}": dict(model=m, dtype=d, num_classes=NUM_CLASSES, num_point=DP_POINT, batch_size=DP_BATCH,
                                optimizer="momentum", fused_sa_train=(m, d) == ("pointnet2_cls_ssg", "float32"))
               for m, d in DP_CASES}
    return {"batches": batches, "configs": configs, "resident": {"points": data, "labels": labels}}


def dp_nudged_moments(nudge: float):
    """``BatchNorm.global_moments`` (DGCNN's pair BN's too) with each
    channel's E[x] and E[x²] scaled by 1 ± ``nudge``, the signs alternating
    over the channels and opposite for the two: a rounding of the moments
    in another order, as two ranks' averaged shard moments give."""
    import torch

    from scanobjectnn_torch.nn.layers import BatchNorm

    real = BatchNorm.global_moments

    def nudged(self, mean, mean2):
        mean, mean2 = real(self, mean, mean2)
        sign = 1.0 - 2.0 * (torch.arange(mean.shape[0], device=mean.device) % 2)
        return mean * (1.0 + nudge * sign), mean2 * (1.0 - nudge * sign)

    return mock.patch.object(BatchNorm, "global_moments", nudged)


@contextlib.contextmanager
def dp_control(name: str | None, model):
    """A planted fault of the two-rank step (``DP_CONTROLS``); None: none."""
    from scanobjectnn_torch.nn.layers import configure_parallel
    from scanobjectnn_torch.train import trainer as trainer_lib

    with contextlib.ExitStack() as stack:
        if name == "local_bn":
            configure_parallel(model, None)
        elif name == "no_average":
            stack.enter_context(mock.patch.object(trainer_lib.Trainer, "_average_gradients", lambda self, m: None))
        elif name == "local_draws":
            stack.enter_context(mock.patch.object(trainer_lib, "global_batch", lambda mesh: contextlib.nullcontext()))
        elif name is not None:
            raise ValueError(f"unknown control {name!r}")
        yield


def dp_steps(config: dict, batches, mesh=None, timed: bool = False, nudge: float = 0.0,
             control: str | None = None) -> dict:
    """``DP_STEPS`` momentum steps of a ``Trainer`` (on ``mesh``; with
    ``nudge``, its BN moments nudged by ``dp_nudged_moments``; with a
    ``control``'s fault): the losses, the state before and after each step,
    the launches by kernel; with ``timed``, then the step's time by CUDA
    events and the collectives' share of it."""
    import torch

    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(**config), mesh=mesh)
    state = trainer.init_state()

    def snapshot():
        return {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}

    def run():
        losses, states = [], [snapshot()]
        for b in batches:
            losses.append(float(trainer.train_step(state, b)[1]["loss"]))
            states.append(snapshot())
        return losses, states

    before = dict(LAUNCHES)
    with dp_nudged_moments(nudge) if nudge else contextlib.nullcontext(), dp_control(control, state.model):
        (losses, states), _ = counted_run(dp_counters(), run)
    launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v > before.get(k, 0)}
    out = {"losses": losses, "launches": launches, "states": states}
    if timed:
        batch = batches[0]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        trainer.train_step(state, batch)  # warm
        torch.cuda.synchronize()
        start.record()
        for _ in range(DP_TIMED_STEPS):
            trainer.train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"] = start.elapsed_time(end) / DP_TIMED_STEPS
        # The collectives timed apart: each all_reduce between synchronizes,
        # by the host clock, over the same steps, against those steps' wall.
        spent = [0.0]
        real = torch.distributed.all_reduce

        def timed_all_reduce(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            work = real(*args, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return work

        with mock.patch.object(torch.distributed, "all_reduce", timed_all_reduce):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["collective_share"], out["instrumented_ms"] = spent[0] / wall, wall * 1e3 / DP_TIMED_STEPS
    return out


def dp_resident_epoch(spec: dict, mesh=None) -> dict:
    """17d: one resident epoch (``train_epoch_device``) of SSG f32, 17b's
    configuration, over ``spec["resident"]`` (DP_STEPS global batches):
    each step's loss and the state around it, the launches, the summary and
    the epoch's seconds (host clock to a synchronize)."""
    import torch

    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(TrainerConfig(**spec["configs"]["pointnet2_cls_ssg float32"]), mesh=mesh)
    state = trainer.init_state()
    device_data = trainer.upload_dataset(spec["resident"])

    def snapshot():
        return {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}

    losses, states = [], [snapshot()]
    real_step = trainer.train_step

    def step(st, batch):
        st, metrics = real_step(st, batch)
        losses.append(float(metrics["loss"]))
        states.append(snapshot())
        return st, metrics

    trainer.train_step = step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, summary), counts = counted_run(dp_counters(), lambda: trainer.train_epoch_device(state, device_data))
    return {"losses": losses, "states": states, "launches": {k: v for k, v in counts.items() if v},
            "summary": summary, "seconds": time.perf_counter() - t0}


def dp_update_reading(got: dict, want: dict, f32: dict | None = None) -> list:
    """Per step, the largest reading of ``got`` against ``want`` over its
    limit (at most 1 passes) and where it is (module doc): the update of
    the parameters and that of the BN statistics, each as one vector, by
    the distance's L2 norm over the reference update's, and the loss; with
    ``f32`` (a bf16 case), each held against the f32 step by the
    BF16_TENSOR_RATIO rule."""
    import torch

    def update(run, i, buffers):
        keys = [k for k, v in want["states"][i + 1].items() if v.is_floating_point()
                and k.endswith((".mean", ".var")) == buffers]
        return torch.cat([(run["states"][i + 1][k].float() - run["states"][i][k].float()).reshape(-1) for k in keys])

    out = []
    for i in range(DP_STEPS):
        worst = [0.0, "nothing"]

        def read(err, limit, what):
            if err / limit > worst[0]:
                worst[:] = [err / limit, f"{what} {err:.3e} against {limit:.3e}"]

        loss_tol, update_tol = DP_STEP_LIMITS[i]
        ref_run = want if f32 is None else f32
        ref = ref_run["losses"][i]
        far, near = (abs(x["losses"][i] - ref) / abs(ref) for x in (got, want))
        if f32 is None:
            read(far, loss_tol, "loss")
        else:
            read(far, max(BF16_TENSOR_RATIO * near, loss_tol), "loss from f32")
        for buffers, what in ((False, "parameter update"), (True, "BN statistics update")):
            ref = update(ref_run, i, buffers)
            norm = float(ref.norm())
            far, near = (float((update(x, i, buffers) - ref).norm()) / norm for x in (got, want))
            if f32 is None:
                read(far, update_tol, what)
            else:
                read(far, max(BF16_TENSOR_RATIO * near, update_tol), f"{what} from f32")
        out.append(tuple(worst))
    return out


def dp_rank(rank: int, init_file: str, spec_path: str, out_path: str) -> None:
    """Phase 17b's rank ``rank`` of DP_WORLD gloo ranks on cuda:0: the
    cases, then the controls."""
    import torch
    import torch.distributed as dist

    from scanobjectnn_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    spec = torch.load(spec_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=DP_WORLD)
    try:
        mesh = make_mesh("cuda:0")
        out = {label: dp_steps(cfg, spec["batches"], mesh, timed=True) for label, cfg in spec["configs"].items()}
        out["controls"] = {(c, label): dp_steps(spec["configs"][label], spec["batches"], mesh, control=c)
                           for c, labels in DP_CONTROLS.items() for label in labels}
        out["resident"] = dp_resident_epoch(spec, mesh)
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)


def dp_phase(smi: str, dev) -> None:
    """Phase 17 (module doc): data parallelism."""
    import multiprocessing
    import os
    import signal
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from scanobjectnn_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    spec = dp_spec()

    # a. A group of one rank: every collective a copy.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_mesh(str(dev))
        for label, cfg in spec["configs"].items():
            grouped = dp_steps(cfg, spec["batches"], mesh)
            alone = dp_steps(cfg, spec["batches"])
            require(grouped["launches"] == alone["launches"], f"17a {label}: launches {grouped['launches']} "
                    f"with the group, {alone['launches']} without")
            differ = [k for i, st in enumerate(alone["states"]) for k, v in st.items()
                      if not torch.equal(grouped["states"][i][k], v)]
            require(grouped["losses"] == alone["losses"] and not differ,
                    f"17a {label}: the world-one group's steps differ from the no-group steps: {differ[:5]}")
            print(f"dp 17a {label} B={DP_BATCH} N={DP_POINT}: {DP_STEPS} momentum steps on a group of one rank "
                  f"(NCCL) bit-equal to the no-group trainer's (losses {grouped['losses']}, "
                  f"{len(alone['states'][-1])} tensors a step); launches {grouped['launches']}")
    finally:
        dist.destroy_process_group()

    # b. Two gloo ranks on the one card against one process on the global batch.
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.pt")
        torch.save(spec, spec_path)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp_rank, args=(r, os.path.join(tmp, "init"), spec_path,
                                                   os.path.join(tmp, f"rank{r}.pt"))) for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, DP_JOIN_TIMEOUT - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in hung:
            procs[r].kill()
            procs[r].join(30)
        require(not hung, f"17b: rank(s) {hung} still running after {DP_JOIN_TIMEOUT} s: killed")
        require([p.exitcode for p in procs] == [0] * DP_WORLD, f"17b: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]
        print(f"dp 17b: {DP_WORLD} gloo ranks on {dev} finished in {time.perf_counter() - t0:.1f} s")

    one = {label: dp_steps(cfg, spec["batches"]) for label, cfg in spec["configs"].items()}
    nudged = {label: dp_steps(cfg, spec["batches"], nudge=DP_NUDGE)
              for label, cfg in spec["configs"].items() if label.endswith("float32")}
    f32_ref = dp_steps(dict(spec["configs"]["pointnet2_cls_ssg bfloat16"], dtype="float32"), spec["batches"])

    def two_ranks(results):
        return {"losses": [float(np.mean([r["losses"][i] for r in results])) for i in range(DP_STEPS)],
                "states": results[0]["states"]}

    def shown(readings):
        return "; ".join(f"step {i + 1} {ratio:.3e} ({where})" for i, (ratio, where) in enumerate(readings))

    failures = []
    for label in spec["configs"]:
        want = one[label]
        f32 = f32_ref if label.endswith("bfloat16") else None
        for r in ranks[1:]:
            differ = [k for k, v in ranks[0][label]["states"][-1].items()
                      if not torch.equal(r[label]["states"][-1][k], v)]
            require(not differ, f"17b {label}: the ranks' states differ: {differ[:5]}")
        got = two_ranks([r[label] for r in ranks])
        readings = dp_update_reading(got, want, f32)
        if max(ratio for ratio, _ in readings) > 1.0:
            failures.append(f"17b {label}: {shown(readings)}")
        print(f"dp 17b {label} global B={DP_BATCH} N={DP_POINT}, {DP_STEPS} momentum steps on {DP_WORLD} ranks "
              f"against one process, largest reading over its limit: {shown(readings)}; losses {got['losses']}, "
              f"one process {want['losses']}" + (f", f32 {f32['losses']}" if f32 else ""))
        if label in nudged:
            print(f"dp 17b {label} reference: the one process with its BN moments nudged by {DP_NUDGE:.3e}: "
                  f"{shown(dp_update_reading(nudged[label], want))}")
        for control, labels in DP_CONTROLS.items():
            if label in labels:
                bad = dp_update_reading(two_ranks([r["controls"][(control, label)] for r in ranks]), want, f32)
                if max(ratio for ratio, _ in bad) <= 1.0:
                    failures.append(f"17b {label}: the {control} control passes the comparison: {shown(bad)}")
                print(f"dp 17b {label} control {control} (must fail): {shown(bad)}")
        for r, res in enumerate(ranks):
            res = res[label]
            print(f"dp 17b {label} rank {r}: launches {res['launches']}; step {res['step_ms']:.4f} ms (CUDA "
                  f"events, {DP_TIMED_STEPS} steps on B={DP_BATCH // DP_WORLD}), collectives "
                  f"{100 * res['collective_share']:.1f}% of {res['instrumented_ms']:.4f} ms with each all_reduce "
                  f"between synchronizes ({smi})")
        need = {"pointnet2_cls_ssg float32": ("fps_indices", "query_ball_group", "gather_rows", "scatter_add_rows",
                                              "grouped_bn_mlp_pool_bwd"),
                "pointnet2_cls_ssg bfloat16": ("fps_indices", "query_ball_group", "gather_rows", "scatter_add_rows",
                                               "bn_relu_exactkey_pool"),
                "dgcnn_bga float32": ("knn_graph_kernel", "edge_reduce_fwd_kernel", "edge_reduce_bwd_kernel",
                                      "edge_gather_knn")}[label]
        for r in ranks:
            require(all(r[label]["launches"].get(k, 0) > 0 for k in need),
                    f"17b {label}: a kernel of the path never launched: {r[label]['launches']}")
            require(r[label]["launches"] == want["launches"],
                    f"17b {label}: launches {r[label]['launches']} on a rank, {want['launches']} in one process")
    require(not failures, "; ".join(failures))

    # d. A resident epoch on the two ranks against one process.
    t_d = time.perf_counter()
    alone = dp_resident_epoch(spec)
    for r in ranks[1:]:
        differ = [k for k, v in ranks[0]["resident"]["states"][-1].items()
                  if not torch.equal(r["resident"]["states"][-1][k], v)]
        require(not differ, f"17d: the ranks' states differ after the resident epoch: {differ[:5]}")
    require(len(alone["losses"]) == DP_STEPS, f"17d: {len(alone['losses'])} steps in the epoch")
    readings = dp_update_reading(two_ranks([r["resident"] for r in ranks]), alone)
    require(max(ratio for ratio, _ in readings) <= 1.0, f"17d: {shown(readings)}")
    for r in ranks:
        require(r["resident"]["launches"] == alone["launches"], f"17d: launches {r['resident']['launches']} on a "
                f"rank, {alone['launches']} in one process")
    require(all(alone["launches"].get(k, 0) > 0 for k in ("fps", "query_ball_group", "gather_rows", "scatter_add_rows",
                                                          "grouped_bn_mlp_pool_bwd")),
            f"17d: a kernel of the epoch never launched: {alone['launches']}")
    print(f"dp 17d pointnet2_cls_ssg float32: one resident epoch ({len(spec['resident']['labels'])} clouds of "
          f"{DP_POINT} points, {DP_STEPS} global batches of {DP_BATCH}) on {DP_WORLD} ranks against one process, "
          f"largest reading over its limit: {shown(readings)}; summaries "
          f"{[r['resident']['summary'] for r in ranks]}, one process {alone['summary']}; launches "
          f"{alone['launches']} on each; the ranks' epochs "
          f"{', '.join('%.2f' % r['resident']['seconds'] for r in ranks)} s, one process {alone['seconds']:.2f} s; "
          f"17d {time.perf_counter() - t_d:.1f} s in this process ({smi})")

    # c. The command line under torch.distributed.run, one rank, NCCL.
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            listing, _, _ = write_bin_clouds(tmp, np.random.RandomState(15), count=CLI_CLOUDS)
            repo = os.path.dirname(os.path.abspath(__file__))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                    "-m", "scanobjectnn_torch.train.cli", "train", "--device", "cuda", "--model",
                    "pointnet2_cls_ssg", "--num_point", str(TRAIN_POINT), "--batch_size", str(TRAIN_BATCH),
                    "--max_epoch", "1", "--log_dir", "log", "--train_file", os.path.basename(listing),
                    "--test_file", os.path.basename(listing)]
            t0 = time.perf_counter()
            # Its own session, so a hung launcher goes with its workers.
            proc = subprocess.Popen(argv, cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, start_new_session=True)
            try:
                _, err = proc.communicate(timeout=DP_CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                require(False, f"17c: torch.distributed.run did not finish within {DP_CLI_TIMEOUT} s: killed")
            secs = time.perf_counter() - t0
            require(proc.returncode == 0, f"17c: exit {proc.returncode}: {err[-3000:]}")
            with open("log/log_train.txt") as f:
                log = f.read()
            epochs = sum(line.startswith("epoch 000") for line in log.splitlines())
            require("devices=1" in log and epochs == 1, f"17c: log_train.txt {log[-2000:]}")
            require(os.path.isfile("log/checkpoint/state.pt"), "17c: no checkpoint")
            with open("log/metrics.jsonl") as f:
                require(len(f.read().splitlines()) == 1, "17c: metrics.jsonl does not hold one epoch")
            print(f"dp 17c: python -m torch.distributed.run --nproc_per_node 1 -m scanobjectnn_torch.train.cli train "
                  f"--device cuda (NCCL, {CLI_CLOUDS} raw .bin clouds, 1 epoch): exit 0 in {secs:.1f} s wall, "
                  f"log line 'devices=1', checkpoint written ({smi})")
        finally:
            os.chdir(old_cwd)
    print(f"dp phase 17: {time.perf_counter() - t_phase:.1f} s ({smi})")



# The device-resident path (phase 18): RESIDENT_CLOUDS synthetic clouds of
# RESIDENT_STORED points uploaded once (``Trainer.upload_dataset``).  A
# resident epoch against ``train_epoch`` over the view it drew
# (``Trainer._epoch_view``: the same step, so the same draws), from the same
# initial state: bit for bit, every parameter, BN statistic, optimizer
# moment, the step, the step generator's state and the summary.  The second
# SSG epoch runs ``Trainer._epoch_impl`` (the epoch up to its readback)
# under ``torch.cuda.set_sync_debug_mode("error")``: no synchronising call
# may be made; the epoch's one readback (``_epoch_summary``'s ``tolist``,
# named by its line) follows outside.  ``evaluate_device(shuffle=False)``
# against ``evaluate(shuffle=False)``: the same keys, predictions, labels
# and every tally equal, the mean loss within RESIDENT_LOSS_RTOL.
RESIDENT_CLOUDS, RESIDENT_STORED = 240, 2048
RESIDENT_EVAL_CLOUDS, RESIDENT_PARTS = 60, 5
RESIDENT_LOSS_RTOL = 1e-5


def state_tensors(state) -> dict:
    """A ``TrainState``'s tensors: the model's state dict, the optimizer's
    state, the step (as a tensor) and the generator's state."""
    import torch

    out = {f"model {k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer {i} {k}": torch.as_tensor(v) for k, v in st.items()})
    out["step"] = torch.tensor(state.step)
    out["generator"] = state.generator.get_state()
    return out


def named_readback() -> str:
    """``file:line`` of the resident epoch's one readback."""
    import inspect

    from scanobjectnn_torch.train import trainer as trainer_lib

    lines, first = inspect.getsourcelines(trainer_lib.Trainer._epoch_summary)
    line = first + next(i for i, text in enumerate(lines) if ".tolist()" in text)
    return f"scanobjectnn_torch/train/trainer.py:{line}"


def resident_epochs(trainer, counters, data: dict, epochs: int, label: str, smi: str) -> None:
    """Phase 18a/18b: ``epochs`` resident epochs of ``trainer`` on ``data``,
    the first counting ``counters``' launches, the second under the sync
    debug mode; each bit-equal to ``train_epoch`` over its view."""
    import torch

    device_data = trainer.upload_dataset(data)
    resident, host = trainer.init_state(), trainer.init_state()
    for epoch in range(epochs):
        view = trainer._epoch_view(resident.step, device_data)
        host_view = {k: v.cpu().numpy() for k, v in view.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if epoch == 0:
            (resident, summary), counts = counted_run(counters,
                                                      lambda: trainer.train_epoch_device(resident, device_data))
            require(all(n > 0 for n in counts.values()), f"18 {label}: a kernel of the epoch never launched: {counts}")
            how = f"launches {counts}"
        else:
            torch.cuda.set_sync_debug_mode("error")
            try:
                resident, totals, n_batches = trainer._epoch_impl(resident, device_data)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            summary = trainer._epoch_summary(totals, n_batches)
            how = (f"the epoch up to its readback under set_sync_debug_mode('error'): nothing raised; its one "
                   f"readback {named_readback()} after it")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        host, host_summary = trainer.train_epoch(host, mock.Mock(epoch=lambda: host_view))
        got, want = state_tensors(resident), state_tensors(host)
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        require(not differ and summary == host_summary,
                f"18 {label} epoch {epoch}: the resident epoch differs from train_epoch over its view: {differ[:5]}, "
                f"{summary} against {host_summary}")
        print(f"resident 18 {label} epoch {epoch} ({len(data['labels'])} clouds of {RESIDENT_STORED} points, "
              f"{resident.step} steps so far): bit-equal to train_epoch over the view it drew ({len(want)} tensors, "
              f"the summary {summary}); {how}; {secs:.4f} s wall ({smi})")


def resident_evaluation(trainer, state, data: dict, counters, votes: int, label: str, smi: str) -> None:
    """Phase 18c: ``evaluate_device(shuffle=False)`` against
    ``evaluate(shuffle=False)``; both timed by the host clock to a
    synchronize, in turns."""
    import numpy as np
    import torch

    def host():
        return trainer.evaluate(state, data["points"], data["labels"], masks=data.get("masks"), parts=data.get("parts"),
                                num_votes=votes, shuffle=False)

    def device():
        return trainer.evaluate_device(state, trainer.upload_dataset(data), num_votes=votes, shuffle=False)

    got, counts = counted_run(counters, device)
    require(all(n > 0 for n in counts.values()), f"18c {label}: a kernel of the evaluation never launched: {counts}")
    want = host()
    require(list(got) == list(want), f"18c {label}: keys {list(got)} against {list(want)}")
    for key, value in want.items():
        if key == "mean_loss":
            require(abs(got[key] - value) <= RESIDENT_LOSS_RTOL * abs(value), f"18c {label}: mean_loss {got[key]} "
                    f"against {value}")
        elif isinstance(value, np.ndarray):
            require(np.array_equal(got[key], value, equal_nan=True), f"18c {label}: {key} differs")
        else:
            require(got[key] == value, f"18c {label}: {key} {got[key]} against {value}")

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = {"host": [], "device": []}
    for path in ("host", "device", "device", "host"):
        times[path].append(wall_ms(host if path == "host" else device))
    numbers = {k: v for k, v in got.items() if isinstance(v, (int, float))}
    print(f"resident 18c {label}: evaluate_device(shuffle=False) equal to evaluate(shuffle=False) ({numbers}); "
          f"launches {counts}; host evaluate {sum(times['host']) / 2:.4f} ms, evaluate_device (the upload included) "
          f"{sum(times['device']) / 2:.4f} ms (rounds host, device, device, host: "
          f"{', '.join(f'{v:.4f}' for v in times['host'][:1] + times['device'] + times['host'][1:])}) ({smi})")


def resident_phase(smi: str, dev) -> None:
    """Phase 18 (module doc): the device-resident path."""
    import os
    import tempfile

    import numpy as np
    import torch

    from scanobjectnn_torch.data.io import convert_to_binary_mask
    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_group
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps
    from scanobjectnn_torch.ops.cuda.gather_kernel import gather_rows, scatter_add_rows
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel
    from scanobjectnn_torch.ops.cuda.poolkey_kernel import bn_relu_exactkey_pool
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool
    from scanobjectnn_torch.train import table5
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    points, labels, masks, parts = make_synthetic_dataset(
        num_per_class=RESIDENT_CLOUDS // NUM_CLASSES, num_classes=NUM_CLASSES, num_points=RESIDENT_STORED, seed=18,
        with_mask=True, with_parts=True)
    masks = convert_to_binary_mask(masks).astype(np.int64)
    train_counters = (fps, query_ball_group, gather_rows, scatter_add_rows)

    # a. SSG f32, B=16, N=1024: two epochs.
    ssg = Trainer(TrainerConfig(num_point=TRAIN_POINT, batch_size=TRAIN_BATCH))
    resident_epochs(ssg, train_counters, {"points": points, "labels": labels}, 2, "a pointnet2_cls_ssg f32", smi)
    # b. BGA bf16 with masks (exact keys, #18; the FP decoder's kNN).
    bga = Trainer(TrainerConfig(model="pointnet2_cls_bga", dtype="bfloat16", num_point=TRAIN_POINT,
                                batch_size=TRAIN_BATCH))
    resident_epochs(bga, (*train_counters, bn_relu_exactkey_pool, knn_point_kernel),
                    {"points": points, "labels": labels, "masks": masks}, 1, "b pointnet2_cls_bga bf16", smi)

    # c. evaluate_device against evaluate: SSG at phase 12's configuration
    # (60 clouds of N=2048, batch 32, 3 votes, random BN statistics), BGA
    # with masks and part segmentation with parts at N=1024.
    data, ssg_labels = make_synthetic_dataset(num_per_class=4, num_classes=NUM_CLASSES, num_points=NUM_POINT, seed=5)
    trainer = Trainer(TrainerConfig(num_point=NUM_POINT, batch_size=32))
    state = trainer.init_state(0)
    stats_rng = np.random.RandomState(23)
    with torch.no_grad():
        for key, buf in state.model.named_buffers():
            vals = stats_rng.randn(*buf.shape)
            buf.copy_(torch.from_numpy(0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)))
    resident_evaluation(trainer, state, {"points": data, "labels": ssg_labels},
                        (fps, sa_ball_mlp_pool, sa_ball_mlp_pool_bucketed, rank_sort_points), 3,
                        f"pointnet2_cls_ssg N={NUM_POINT}, {len(ssg_labels)} clouds, batch 32, 3 votes", smi)
    rows = np.random.RandomState(18).permutation(RESIDENT_CLOUDS)[:RESIDENT_EVAL_CLOUDS]
    bga = Trainer(TrainerConfig(model="pointnet2_cls_bga", num_point=TRAIN_POINT, batch_size=32))
    resident_evaluation(bga, bga.init_state(0), {"points": points[rows], "labels": labels[rows], "masks": masks[rows]},
                        (fps, sa_ball_mlp_pool, knn_point_kernel), 3,
                        f"pointnet2_cls_bga N={TRAIN_POINT} with masks, {RESIDENT_EVAL_CLOUDS} clouds, batch 32, "
                        f"3 votes", smi)
    partseg = Trainer(TrainerConfig(model="pointnet_partseg", num_classes=RESIDENT_PARTS, num_point=TRAIN_POINT,
                                    batch_size=32))
    resident_evaluation(partseg, partseg.init_state(0),
                        {"points": points[rows], "labels": labels[rows], "parts": parts[rows]}, (), 3,
                        f"pointnet_partseg N={TRAIN_POINT} with parts 0-2 of {RESIDENT_PARTS}, "
                        f"{RESIDENT_EVAL_CLOUDS} clouds, batch 32, 3 votes", smi)

    # d. One Table-5 row through the harness's array function.
    test_rows = np.setdiff1d(np.arange(RESIDENT_CLOUDS), rows)[:RESIDENT_EVAL_CLOUDS]
    with tempfile.TemporaryDirectory() as tmp:
        args = table5.build_parser().parse_args(["--epochs", "1", "--log_root", tmp, "--device", "cuda"])
        row = table5.train_and_evaluate("pointnet_cls", "cls", {"points": points, "labels": labels},
                                        {"points": points[test_rows], "labels": labels[test_rows]}, args)
        require(0.0 <= row["accuracy"] <= 1.0 and os.path.isfile(os.path.join(tmp, "pointnet_cls", "checkpoint_best",
                                                                               "state.pt")),
                f"18d: the Table-5 row {row}")
    print(f"resident 18d: table5.train_and_evaluate('pointnet_cls', 1 epoch on {RESIDENT_CLOUDS} clouds, batch 32, "
          f"the best checkpoint restored, {args.votes} votes on {RESIDENT_EVAL_CLOUDS} clouds at N={args.num_point}): "
          f"{row} ({smi})")
    print(f"resident phase 18: {time.perf_counter() - t_phase:.1f} s ({smi})")


# The synthetic-hard harness (phase 19): its clouds of 2 x SYNTH_POINT points
# subsampled to SYNTH_POINT, its batch SYNTH_BATCH; SYNTH_EPOCHS epochs of
# the whole training set in 19c; SYNTH_ROW_CLOUDS training clouds (two steps)
# a row in 19d.  FPS at M > N equal to its plain version; #3 held as in
# phase 2 (f32: ``check_pooled``'s bound).
SYNTH_POINT, SYNTH_BATCH, SYNTH_EPOCHS, SYNTH_ROW_CLOUDS = 128, 24, 2, 48
SYNTH_ROW_KEYS = {"model", "dtype", "bga", "accuracy", "seg_accuracy", "avg_part_accuracy", "wall_sec"}


def harness_counters():
    """Every kernel wrapper the harness's rows can launch."""
    from scanobjectnn_torch.ops.cuda.ballgroup_kernel import query_ball_point
    from scanobjectnn_torch.ops.cuda.dupmask_kernel import duplicate_mask_kernel
    from scanobjectnn_torch.ops.cuda.knn_kernel import knn_point_kernel
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool
    from scanobjectnn_torch.ops.cuda.samlp_kernel import sa_mlp_pool
    from scanobjectnn_torch.ops.cuda.spider_kernel import spider_conv_bwd_kernel, spider_conv_fwd_kernel

    return (*dp_counters(), query_ball_point, sa_ball_mlp_pool, sa_mlp_pool, knn_point_kernel, duplicate_mask_kernel,
            spider_conv_fwd_kernel, spider_conv_bwd_kernel, rank_sort_points, sa_ball_mlp_pool_bucketed)


def synth_phase(smi: str, dev) -> None:
    """Phase 19 (module doc): the synthetic-hard harness at its shapes."""
    import argparse
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from scanobjectnn_torch.nn import pointnet_modules
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain
    from scanobjectnn_torch.train import synth_hard

    t_phase = time.perf_counter()
    # a. FPS at M > N: once every point is taken, index 0 (all distances 0).
    rng = np.random.RandomState(19)
    for n in (128, 100):
        xyz = torch.from_numpy(rng.randn(2, n, 3).astype(np.float32)).to(dev)
        label = f"B=2 {n}->512 (M > N)"
        check_fps(xyz, 512, label, fps, fps_plain)
        idx = fps(xyz, 512, with_coords=False)
        require(torch.equal(idx, fps_plain(xyz, 512)[0]), f"FPS indices without coordinates differ ({label})")
        require(not bool(idx[:, n:].any()) and all(len(set(r[:n].tolist())) == n for r in idx),
                f"FPS at M > N: every point once, then index 0 ({label})")
        work = Work()
        fps_work(work, 2, n, 512)
        print(f"time fps {label}: kernel {cuda_ms(lambda: fps(xyz, 512)):.4f} ms, indices only "
              f"{cuda_ms(lambda: fps(xyz, 512, with_coords=False)):.4f} ms, plain "
              f"{cuda_ms(lambda: fps_plain(xyz, 512), iters=3):.4f} ms, bound {work.record()} ({smi})")

    # b. #3 at the harness's eval calls, recorded from f32 forwards.
    train, test = synth_hard.build_data(2 * SYNTH_POINT)
    view = np.random.RandomState(19).permutation(2 * SYNTH_POINT)[:SYNTH_POINT]
    x = torch.from_numpy(test["points"][:SYNTH_BATCH][:, view]).to(dev)
    calls = []

    def recorder(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items() if k != "dtype"}))
        return sa_ball_mlp_pool(*args, **kw)

    for name in ("pointnet2_cls_ssg", "pointnet2_cls_msg"):
        model = eval_models(name, np.random.RandomState(19), num_classes=6)["f32"]
        calls.clear()
        with torch.no_grad(), mock.patch.object(pointnet_modules, "sa_ball_mlp_pool", recorder):
            logits = model(x)["logits"]
        require(logits.shape == (SYNTH_BATCH, 6) and bool(torch.isfinite(logits).all()), f"{name} logits at N=128")
        require([(a[2].shape[1], a[3].shape[1]) for a, _ in calls][0] == (SYNTH_POINT, 512),
                f"{name}: SA1 is not 512 centroids from {SYNTH_POINT} points")
        with torch.no_grad():
            for i, (args, kw) in enumerate(calls):
                label = (f"{name} call {i} B={SYNTH_BATCH} N={args[2].shape[1]} M={args[3].shape[1]} K={args[1]} "
                         f"r{args[0]}")
                check_sa(args, torch.float32, label, sa_ball_mlp_pool, sa_ball_mlp_pool_plain, **kw)
                work = Work()
                sa_work(work, args, torch.float32, kw.get("use_xyz", True))
                print(f"time sa_ball_mlp_pool {label}: kernel "
                      f"{cuda_ms(lambda: sa_ball_mlp_pool(*args, dtype=torch.float32, **kw)):.4f} ms, plain "
                      f"{cuda_ms(lambda: sa_ball_mlp_pool_plain(*args, dtype=torch.float32, **kw), iters=3):.4f} "
                      f"ms, bound {work.record()} ({smi})")
    require(any(a[1] == SYNTH_POINT for a, _ in calls), "MSG's K = 128 = N call never ran")

    # c. The harness's command: two rows, the second merged into the first's files.
    counters = harness_counters()
    with tempfile.TemporaryDirectory() as tmp:
        md, js = os.path.join(tmp, "synth.md"), os.path.join(tmp, "synth.json")
        base = ["--epochs", str(SYNTH_EPOCHS), "--output", md, "--json", js]
        for argv, need in ((["--models", "pointnet2_cls_bga"],
                            ("fps", "query_ball_group", "gather_rows", "scatter_add_rows", "sa_ball_mlp_pool",
                             "knn_point_kernel")),
                           (["--models", "pointnet2_cls_ssg:bfloat16", "--pool_f32", "keys", "--merge"],
                            ("fps", "query_ball_group", "gather_rows", "scatter_add_rows", "sa_ball_mlp_pool",
                             "bn_relu_exactkey_pool"))):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                _, launches = counted_run(counters, lambda: synth_hard.main(base + argv))
            print(f"synth 19c: synth_hard.main {' '.join(argv)} ({SYNTH_EPOCHS} epochs): "
                  f"{time.perf_counter() - t0:.1f} s, launches {launches}, of them indices-only FPS "
                  f"{fps.index_launches}, chunked #3 {sa_ball_mlp_pool.chunked_launches} ({smi})")
            require(all(launches[k] > 0 for k in need), f"19c: a kernel of the harness never launched: {launches}")
        with open(js) as f:
            rows = json.load(f)
        with open(md) as f:
            lines = f.read().splitlines()
    print(f"synth 19c: rows {rows}")
    require([(r["model"], r["dtype"]) for r in rows] == [("pointnet2_cls_bga", "float32"),
                                                        ("pointnet2_cls_ssg", "bfloat16+poolkeys")],
            f"19c: the json's rows {rows}")
    require(all(set(r) == SYNTH_ROW_KEYS and 0.0 <= r["accuracy"] <= 1.0 for r in rows)
            and 0.0 <= rows[0]["seg_accuracy"] <= 1.0, f"19c: the rows' keys or accuracies {rows}")
    require(lines[1].startswith(f"Device: {smi.splitlines()[0]}") and len(lines) == 9,
            f"19c: the markdown {lines[:2]}")

    # d. Every row through run_row on a slice of the data: launches by kernel.
    args = argparse.Namespace(epochs=1, num_point=SYNTH_POINT, pool_f32=None, device="cuda")
    small = {k: v[:SYNTH_ROW_CLOUDS] for k, v in train.items()}
    small_test = {k: v[:SYNTH_BATCH] for k, v in test.items()}
    for model, supervision, dtype in synth_hard.ROWS:
        t0 = time.perf_counter()
        row, launches = counted_run(counters, lambda: synth_hard.run_row(model, supervision, dtype, small,
                                                                         small_test, args))
        accs = [row[k] for k in ("accuracy", "avg_part_accuracy") if row[k] is not None]
        require(set(row) == SYNTH_ROW_KEYS and all(0.0 <= a <= 1.0 for a in accs), f"19d: {model} {dtype}: {row}")
        print(f"synth 19d: {model} {dtype}: {time.perf_counter() - t0:.2f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} } ({smi})")

    synth_step_checks(train, smi, dev)
    print(f"synth phase 19: {time.perf_counter() - t_phase:.1f} s ({smi})")

def synth_step_checks(train: dict, smi: str, dev) -> None:
    """Phase 19e: one training step of BGA f32 and of SSG bf16 with exact
    keys at the harness's shapes (B=SYNTH_BATCH clouds of its training set
    at SYNTH_POINT points).  Every kernel call of the step is recorded and
    held to its plain version on the same inputs (equal; #7 bit-stable and
    equal to the CPU's index-order sum), then the step to the plain path's
    (``compare_steps``)."""
    import torch

    from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
    from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

    view = EpochSampler(train["points"], train["labels"], masks=train["masks"], num_points=SYNTH_POINT,
                        seed=0).epoch()
    batch = next(iter(Batches(view, SYNTH_BATCH)))
    for model, dtype, pool, n_zero, step_tol in (
        ("pointnet2_cls_bga", "float32", "auto", 19, TRAIN_GRAD_TOL),
        ("pointnet2_cls_ssg", "bfloat16", "keys", 11, BF16_STEP_GRAD_TOL),
    ):
        trainer = Trainer(TrainerConfig(model=model, num_classes=6, num_point=SYNTH_POINT, batch_size=SYNTH_BATCH,
                                        dtype=dtype, augment_rotate=False, pool_precision=pool, device=str(dev)))
        step_batch = batch if trainer.kind != "cls" else {k: batch[k] for k in ("points", "labels")}
        calls = []
        with recording(calls):
            trainer.train_step(trainer.init_state(seed=0), step_batch)
        torch.cuda.synchronize()
        need = {"fps", "query_ball_group", "gather_rows", "scatter_add_rows",
                "knn_point_kernel" if dtype == "float32" else "bn_relu_exactkey_pool"}
        require({name for name, *_ in calls} == need, f"19e: {model} {dtype} called {[c[0] for c in calls]}")
        for i, (name, wrapper, plain, args, kw) in enumerate(calls):
            label = f"{model} {dtype} call {i} {name} {[list(a.shape) for a in args if hasattr(a, 'shape')]}"
            got = wrapper(*args, **kw)
            if name == "scatter_add_rows":
                # Bit-stable, and the CPU's index-order sum bit for bit.
                want = plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args), **kw)
                require(torch.equal(got, wrapper(*args, **kw)) and torch.equal(got.cpu(), want),
                        f"19e: #7 differs from the CPU's index-order sum ({label})")
                continue
            want = plain(*args, **kw)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            require(len(got) == len(want) and all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)),
                    f"19e: {name} differs from its plain version ({label})")
        print(f"synth 19e: {model} {dtype} one step at B={SYNTH_BATCH} N={SYNTH_POINT}: "
              f"{len(calls)} kernel calls equal to their plain versions "
              f"{ {n: sum(c[0] == n for c in calls) for n in sorted(need)} } ({smi})")
        compare_steps(trainer, step_batch, n_zero, f"synth {model} {dtype} B={SYNTH_BATCH} N={SYNTH_POINT}",
                      grad_tol=step_tol, zero_tol=ZERO_GRAD_TOL if dtype == "float32" else None)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU")
    # f32 matmuls must not run in TF32 (the plain path is the f32 reference).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
    from scanobjectnn_torch.models import get_model
    from scanobjectnn_torch.ops.cuda import _build
    from scanobjectnn_torch.nn.pointnet_modules import configure_eval
    from scanobjectnn_torch.ops.cuda.fps_kernel import fps, fps_plain
    from scanobjectnn_torch.ops.cuda.ranksort_kernel import rank_sort_points
    from scanobjectnn_torch.ops.cuda.sabucket_kernel import sa_ball_mlp_pool_bucketed
    from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool, sa_ball_mlp_pool_plain

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 1. Build.
    t0 = time.perf_counter()
    _build.library()
    print(f"build: nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s "
          f"(library ready after {time.perf_counter() - t0:.2f} s)")
    check_sa_kernels(smi)
    check_satrain_kernels(smi)
    check_graph_fps_kernels(smi)
    check_edge_dup_kernels(smi)

    # Data and model.
    data, labels = make_synthetic_dataset(
        num_per_class=18, num_classes=NUM_CLASSES, num_points=NUM_POINT, seed=0
    )
    order = np.random.RandomState(0).permutation(len(data))[: 2 * BATCH]
    batches = [torch.from_numpy(data[order[i * BATCH:(i + 1) * BATCH]]).to(dev) for i in range(2)]
    stats_rng = np.random.RandomState(1)
    models = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = get_model("pointnet2_cls_ssg", generator=torch.Generator().manual_seed(0), dtype=dtype)
        with torch.no_grad():
            for key, buf in model.named_buffers():
                vals = stats_rng.randn(*buf.shape)
                buf.copy_(torch.from_numpy(
                    0.1 + 0.1 * np.abs(vals) if key.endswith(".var") else 0.05 * np.abs(vals)
                ))
        models[name] = model.eval()

    # 2. Kernels against their plain versions, at the main path's shapes.
    # errs: max abs error per kernel; per_forward: [kernel ms, plain ms] and
    # work: the bound, over the calls one bf16 forward makes (FPS both
    # layers, SA1+SA2).
    errs = {"fps": 0.0, "sa_ball_mlp_pool": 0.0}
    per_forward = {"fps": [0.0, 0.0], "sa_ball_mlp_pool": [0.0, 0.0]}
    work = {"fps": Work(), "sa_ball_mlp_pool": Work()}

    def record(kname, label, ms, plain_ms, in_bf16_forward):
        print(f"time {kname} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
        if in_bf16_forward:
            per_forward[kname][0] += ms
            per_forward[kname][1] += plain_ms

    x0 = batches[0]
    _, sa1_xyz = fps_plain(x0, 512)
    _, sa2_xyz = fps_plain(sa1_xyz, 128)
    g = torch.Generator().manual_seed(2)
    lattice = torch.randint(-3, 4, (8, 256, 3), generator=g).float() * 0.25
    ties = lattice.repeat(1, 8, 1)[:, torch.randperm(2048, generator=g)].contiguous().to(dev)
    nan_cloud = x0[:2].clone()
    nan_cloud[1, 5, 1] = float("nan")
    for xyz, npoint, label in (
        (x0, 512, "B=128 2048->512"), (sa1_xyz, 128, "B=128 512->128"),
        (ties, 512, "duplicated lattice points (ties)"), (nan_cloud, 64, "cloud with a NaN point"),
    ):
        errs["fps"] = max(errs["fps"], check_fps(xyz, npoint, label, fps, fps_plain))
    for xyz, npoint, label in ((x0, 512, "2048->512"), (sa1_xyz, 128, "512->128")):
        ms = cuda_ms(lambda: fps(xyz, npoint))
        print_fps_step(f"B={BATCH} {label}", ms, npoint, smi)
        record("fps", label, ms, cuda_ms(lambda: fps_plain(xyz, npoint), iters=3), True)
        fps_work(work["fps"], *xyz.shape[:2], npoint)

    for name in ("f32", "bf16"):
        model = models[name]
        dtype = torch.float32 if name == "f32" else torch.bfloat16
        with torch.no_grad():
            w1, b1 = model.sa1.mlp.folded()
            w2, b2 = model.sa2.mlp.folded()
            sa1_args = (0.2, 32, x0, sa1_xyz, None, w1, b1)
            pooled1, _ = sa_ball_mlp_pool_plain(*sa1_args, dtype=dtype)
            sa2_args = (0.4, 64, sa1_xyz, sa2_xyz, pooled1, w2, b2)
            for label, args in (("SA1", sa1_args), ("SA2", sa2_args)):
                full = f"{label} {name} B=128"
                errs["sa_ball_mlp_pool"] = max(
                    errs["sa_ball_mlp_pool"],
                    check_sa(args, dtype, full, sa_ball_mlp_pool, sa_ball_mlp_pool_plain),
                )
                ms = cuda_ms(lambda: sa_ball_mlp_pool(*args, dtype=dtype))
                record("sa_ball_mlp_pool", full, ms,
                       cuda_ms(lambda: sa_ball_mlp_pool_plain(*args, dtype=dtype), iters=3),
                       name == "bf16")
                print(f"rate sa_ball_mlp_pool {full}: {fma_rate(sa_flops(args), ms)} ({smi})")
                if name == "bf16":
                    sa_work(work["sa_ball_mlp_pool"], args, dtype)

    # 3. The main path: get_model -> model(points) under sa_bucket "auto" (SA1
    # through #5 and #4, SA2 through #3), counting kernel launches; the
    # logits equal to the "off" forward's (SA1 through #3).
    main_counters = (fps, sa_ball_mlp_pool, sa_ball_mlp_pool_bucketed, rank_sort_points)
    with torch.no_grad():
        logits, launches = counted_run(
            main_counters, lambda: {n: [m(x)["logits"] for x in batches] for n, m in models.items()}
        )
        print(f"main path launches: {launches}")
        require(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
        for name, m in models.items():
            configure_eval(m, "off")
            off = [m(x)["logits"] for x in batches]
            configure_eval(m, "auto")
            require(all(torch.equal(a, b) for a, b in zip(logits[name], off)),
                    f"{name} logits under sa_bucket 'auto' differ from 'off'")
            print(f"model {name}: logits under sa_bucket 'auto' equal to 'off' bit for bit")
    before = [c.launches for c in main_counters]

    # The same model on the plain path, same card.
    with torch.no_grad(), plain_path():
        ref = {name: [m(x)["logits"] for x in batches] for name, m in models.items()}
        plain_fwd_ms = {name: cuda_ms(lambda: m(batches[0]), iters=3) for name, m in models.items()}
    require([c.launches for c in main_counters] == before, "the plain path launched a kernel")

    for name in models:
        got, want = torch.cat(logits[name]), torch.cat(ref[name])
        require(got.shape == (2 * BATCH, NUM_CLASSES), f"logits shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got.float()).all()), f"non-finite logits ({name})")
        agree = float((got.float().argmax(1) == want.float().argmax(1)).float().mean())
        n_classes = int(want.float().argmax(1).unique().numel())
        if name == "bf16":
            check_bf16(got, want, BF16_LOGIT_ULPS, "model bf16: logits")
        else:
            err, tol = float((got - want).abs().max()), F32_LOGIT_TOL * scale_of(want)
            print(f"model f32: logits max abs err {err:.3e} (bound {tol:.3e})")
            require(err <= tol, f"f32 logits differ from the plain path: {err} > {tol}")
        print(f"model {name}: class agreement {agree:.4f}, {n_classes} distinct predicted classes")
        require(agree >= (BF16_CLASS_AGREEMENT if name == "bf16" else 1.0), f"{name} class agreement {agree}")

    with torch.no_grad():
        for name, m in models.items():
            ms = {}
            for setting in ("auto", "off", "off", "auto"):
                configure_eval(m, setting)
                ms.setdefault(setting, []).append(cuda_ms(lambda: m(batches[0])))
            auto, off = (sum(ms[k]) / 2 for k in ("auto", "off"))
            print(f"time forward {name} B={BATCH} N={NUM_POINT}: kernel path, sa_bucket 'auto' {auto:.4f} ms "
                  f"({BATCH / auto * 1e3:.1f} clouds/s), 'off' {off:.4f} ms (rounds auto, off, off, auto: "
                  f"{', '.join(f'{v:.4f}' for v in ms['auto'][:1] + ms['off'] + ms['auto'][1:])}), "
                  f"plain path {plain_fwd_ms[name]:.4f} ms ({smi})")

    # 4. Training.  5. BGA and part segmentation.  6. DGCNN and DGCNN-BGA.  7. SpiderCNN.  8. PointCNN.
    # 9. MSG.  10. The SA layer's other kernels.  11. Mixed precision and the fused tail.
    measured = {
        k: {"max_abs_err": errs[k], "ms": per_forward[k][0], "plain_ms": per_forward[k][1],
            **work[k].record(), "library_ms": None}
        for k in ("fps", "sa_ball_mlp_pool")
    }
    marks = [("1-3", time.perf_counter())]
    measured.update(train_phase(smi, dev))
    marks.append(("4", time.perf_counter()))
    measured["knn_point"] = seg_phase(smi, dev)
    marks.append(("5", time.perf_counter()))
    measured.update(dgcnn_phase(smi, dev))
    marks.append(("6", time.perf_counter()))
    measured.update(spider_phase(smi, dev))
    marks.append(("7", time.perf_counter()))
    measured["duplicate_mask"] = pointcnn_phase(smi, dev)
    marks.append(("8", time.perf_counter()))
    measured["sa_ball_mlp_pool_chunked"] = msg_phase(smi, dev)
    marks.append(("9", time.perf_counter()))
    measured.update(sa_layer_phase(smi, dev))
    marks.append(("10", time.perf_counter()))
    measured.update(mixed_phase(smi, dev))
    marks.append(("11", time.perf_counter()))
    measured.update(bucket_phase(smi, dev, models, x0, sa1_xyz))
    marks.append(("12", time.perf_counter()))
    routes = range_phase(smi, dev)
    marks.append(("13", time.perf_counter()))
    data_phase(smi, dev)
    marks.append(("14", time.perf_counter()))
    cli_phase(smi)
    marks.append(("15", time.perf_counter()))
    pointnet_phase(smi, dev)
    marks.append(("16", time.perf_counter()))
    dp_phase(smi, dev)
    marks.append(("17", time.perf_counter()))
    resident_phase(smi, dev)
    marks.append(("18", time.perf_counter()))
    synth_phase(smi, dev)
    marks.append(("19", time.perf_counter()))
    print("seconds by phase: " + ", ".join(f"{label} {t - t0:.1f}" for (label, t), t0 in
                                           zip(marks, [t_start] + [t for _, t in marks[:-1]])))

    require(not {"jax", "scanobjectnn_tpu"} & set(sys.modules), "JAX or the JAX package was imported")

    pallas, csrc = "scanobjectnn_tpu/ops/pallas/", "scanobjectnn_torch/csrc/"
    # name: (source, TPU kernel replaced, counter in LAUNCHES)
    sources = {
        "fps": (csrc + "fps.cu", pallas + "fps_kernel.py:151", "fps"),
        "fps_indices": (csrc + "fps.cu", pallas + "fps_kernel.py:126", "fps_indices"),
        "sa_ball_mlp_pool": (csrc + "safused.cu", pallas + "safused_kernel.py:354", "sa_ball_mlp_pool"),
        "sa_ball_mlp_pool_chunked": (csrc + "safused.cu", pallas + "safused_kernel.py:354",
                                     "sa_ball_mlp_pool_chunked"),
        "sa_mlp_pool": (csrc + "safused.cu", pallas + "samlp_kernel.py:213", "sa_mlp_pool"),
        "query_ball_point": (csrc + "ballgroup.cu", pallas + "ballquery_kernel.py:75", "query_ball_point"),
        "query_ball_group": (csrc + "ballgroup.cu", pallas + "ballquery_kernel.py:381", "query_ball_group"),
        "gather_rows": (csrc + "gather.cu", pallas + "onehot.py:223", "gather_rows"),
        "scatter_add_rows": (csrc + "gather.cu", pallas + "onehot.py:245", "scatter_add_rows"),
        "knn_point": (csrc + "knn.cu", pallas + "knn_kernel.py:196", "knn_point_kernel"),
        "knn_graph": (csrc + "knn.cu", pallas + "knn_kernel.py:81", "knn_graph_kernel"),
        "edge_reduce": (csrc + "edge.cu", pallas + "edge_kernel.py:210", "edge_reduce_fwd_kernel"),
        "edge_reduce_bwd": (csrc + "edge.cu", pallas + "edge_kernel.py:280", "edge_reduce_bwd_kernel"),
        "edge_gather_knn": (csrc + "knn.cu", pallas + "edge_kernel.py:469", "edge_gather_knn"),
        "spider_conv": (csrc + "spider.cu", pallas + "spider_kernel.py:256", "spider_conv_fwd_kernel"),
        "spider_conv_bwd": (csrc + "spider.cu", pallas + "spider_kernel.py:281", "spider_conv_bwd_kernel"),
        "duplicate_mask": (csrc + "dupmask.cu", pallas + "knn_kernel.py:131", "duplicate_mask_kernel"),
        "knn_point_sorted": (csrc + "knn.cu", pallas + "knn_kernel.py:196", "knn_point_kernel_sorted"),
        "bn_relu_exactkey_pool": (csrc + "poolkey.cu", pallas + "poolkey_kernel.py:125", "bn_relu_exactkey_pool"),
        "grouped_bn_mlp_pool_bwd": (csrc + "satrain_bwd.cu", pallas + "satrain_bwd.py:207",
                                    "grouped_bn_mlp_pool_bwd"),
        "rank_sort_points": (csrc + "ranksort.cu", pallas + "ranksort_kernel.py:154", "rank_sort_points"),
        "sa_ball_mlp_pool_bucketed": (csrc + "sabucket.cu", pallas + "sabucket_kernel.py:455",
                                      "sa_ball_mlp_pool_bucketed"),
    }
    print("launches, every main path together: " + ", ".join(f"{k} {v}" for k, v in sorted(LAUNCHES.items())))
    kernels = []
    for k, (src, tpu, counter) in sources.items():
        require(LAUNCHES.get(counter, 0) > 0, f"{k} never launched on a main path")
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": tpu,
                        "launches": LAUNCHES[counter], **measured[k], **routes.get(k, {})})
    require(all(v > 0 for r in routes.values() for v in r.values()), f"a new route never launched: {routes}")
    print("kernel ms / plain_ms / bound_ms: fps and sa_ball_mlp_pool (K <= 64) summed over one bf16 SSG forward's "
          "calls at B=128 under sa_bucket 'off' (FPS both layers, SA1+SA2; CUDA events); rank_sort_points over "
          "the two calls of the bf16 SSG forward's SA1 under 'auto' at B=128 (points N=2048, queries M=512; device "
          "time), sa_ball_mlp_pool_bucketed over its one call (SA1, with its prep: the sort keys and both "
          "rank_sort_points calls; CUDA events); sa_ball_mlp_pool_chunked (the same kernel at "
          "K > 64, up to 1024: K a multiple of 16) over the two K=128 calls of one bf16 pointnet2_cls_msg forward "
          "at B=32 (CUDA events); sa_mlp_pool over the four f32 SAModule calls of phase 10 at B=32 (knn K=32 and "
          "ball K=128 at SA1 and SA2; CUDA events); query_ball_point over its two calls at B=32, N=1024, M=512 "
          "(K=32, 128; CUDA events); fps_indices, ball group, gather and scatter-add over "
          "one f32 SSG training step's calls at B=16 (FPS both layers, ball group SA1+SA2, gather and scatter-add "
          "SA2; device time, torch.profiler); knn_point over one f32 BGA forward's calls at B=32 (fp1+fp2+fp3; "
          "device time); knn_graph, edge_reduce and edge_reduce_bwd over one f32 dgcnn "
          "forward's (and its backward's) calls at B=32 (5 graphs, EdgeConv 1-4; device time), edge_gather_knn "
          "over its T-Net call there (the fused graph and gather; CUDA events); spider_conv and spider_conv_bwd over one f32 spidercnn_cls_xyz forward's (and its "
          "backward's) calls at B=32 (conv1-4; CUDA events); duplicate_mask over one f32 pointcnn_seg forward's "
          "calls at B=32 (xconv_1-4, xdconv_4, xdconv_5; CUDA events); knn_point_sorted (the kNN at k > 64) "
          "over the two f32 SAModule(knn, nsample=128) calls of phase 11 at B=32 (CUDA events); "
          "bn_relu_exactkey_pool over one bf16 SSG step's three calls at B=16 (CUDA events; its launches include "
          "phase 16's bf16 PointNet steps and command line, whose calls phase 16 times apart); "
          "grouped_bn_mlp_pool_bwd over one f32 fused-tail SSG step's SA1 and SA2 calls at B=16 (CUDA events). "
          "library_ms: torch.argsort(stable=True) for rank_sort_points (device time), torch.gather for the "
          "gather, index_add_ "
          "for the scatter-add (device time), torch.matmul of the materialised outer product for spider_conv "
          "(CUDA events); "
          "launches: every main path's run together; fps, knn_graph, knn_point, knn_point_sorted, "
          "edge_reduce_bwd and edge_gather_knn also "
          "carry the launches of their routes added in phase 13's ranges (large_launches: FPS above 8192 points; "
          "routed_launches: the graph above k = 32 through the general kNN kernel, the EdgeConv backward above "
          "9685 points through its per-edge kernel, edge_gather_knn above k = 32 through the graph and the gather "
          "kernel; fused_launches: edge_gather_knn at k <= 32 through the one fused kernel; "
          "tiled_launches: the selection or sort over more than 16384 keys; fullsort_launches: the full sort, where "
          "the selected words do not fit a block; warp_launches: the kNN at 16 < k <= 64 through the warp lists)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

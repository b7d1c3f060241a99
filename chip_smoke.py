#!/usr/bin/env python3
"""Run the e2enet_tpu_torch port once on one CUDA card and check it.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --host-ms
                                   # only the host's time per call of the
                                   # up-link and the seg head (see host_only)
    python3 chip_smoke.py --trainer
                                   # only the build and the [trainer] phase
    python3 chip_smoke.py --options
                                   # only the build, [trainer]'s planned
                                   # task and the [options] phase
    python3 chip_smoke.py --dsff
                                   # only the build, [trainer]'s planned
                                   # task and the [dsff] phase
    python3 chip_smoke.py --2d
                                   # only the build, [trainer]'s planned
                                   # task and the [2d] phase
    python3 chip_smoke.py --cascade
                                   # only the build, [trainer]'s planned
                                   # task and the [cascade] phase
    python3 chip_smoke.py --variants
                                   # only the build, [trainer]'s planned
                                   # task and the [variants] phase
    python3 chip_smoke.py --ensembles
                                   # only the build, [trainer]'s planned
                                   # task, a short 3d_fullres and 2d fold
                                   # and the [ensembles] phase
    python3 chip_smoke.py --models
                                   # only the build, [trainer]'s planned
                                   # task and the [models] phase
    python3 chip_smoke.py --device_augment
                                   # only the build, [trainer]'s planned
                                   # task and the [device_augment] phase
    python3 chip_smoke.py --formats
                                   # only the [formats] phase (it builds
                                   # and launches no kernel)
    python3 chip_smoke.py --parallel
                                   # only the build and the [parallel]
                                   # phase
    python3 chip_smoke.py --spatial
                                   # only the build and the [spatial]
                                   # phase

Phases (any failure ends the run with a non-zero exit):
  1. device   name, torch/CUDA versions, nvidia-smi name and power limit
  2. build    compile every csrc/*.cu for sm_90a into build/ (one nvcc each,
              all at once); registers and spills per kernel
  3. kernels  each CUDA kernel against its plain torch version in bfloat16,
              at the main-path shapes and at ragged ones (odd D, W not a
              multiple of 8, 8-channel parts); the fused block, the strided
              transition and the lazy up-link block at all 8 mirror
              combinations (the fused block at CO 24 and 96). The fused
              block also at W 144, 160 and 600 and K 200 and 240 (up to 5
              K chunks), its row reporting every on-path shape under
              'shapes' with its taps on mma.sync (mma_ms, the control for
              its wgmma loop) and the host's time per call (host_ms); the
              strided transition also at N = 2 with a block's
              tiles straddling the samples, its bound counting the bytes a
              strided pass reads (half of x). The up-link and the seg head
              on the route each shape must take (checked by their route
              counters: the bulk route at the bench's shapes, the first
              design where only it fits), with the host's time per call
              (host_ms): the up-link also at N = 2 mirrored, the seg head
              also at 2 x 64^3 x 96 (logits), with tiles straddling two
              samples and a ragged last tile. Per call: kernel ms, plain ms,
              the bound (bytes or operations over the card's peak) and the
              share of it reached, and the time of one PyTorch call
              computing the core op, for context; for the lazy block also
              the materialised route (up-link kernel, then fused-block
              kernel), the fused block alone on the materialised concat
              (kernel1_ms: the conv without the up-link), the same kernel
              with its taps on mma.sync (mma_ms: the control for its wgmma
              loop), the host's time per call (host_ms), one launch per
              call, and the edges of its tile (H not a
              multiple of its rows, D = 2, output widths 10 and 40, three
              pending parts, W = 144 and 600, compact groups reading both
              depth parities, up parts wider than one K chunk)
  4. sparse   the bench's default serving path: ShiftUNet++ at the bench
              width (48 base features, 5 x (2,2,2) pools, 16 classes, bf16,
              random weights from seed 0) with the trained DSFF row masks
              (experiments/logs/bench_masks_trained.npz) baked in and the
              row-sparse plan attached; fast mode (flip-free mirror TTA, 8
              statically mirrored forwards per tile, bf16 probs head,
              level-0 up-links computed lazily), sliding-window inference of
              two seeded random 192^3 volumes with 128^3 patches, step 0.5,
              float16 accumulators. Launch counts, normalised finite
              probabilities, plan and mask densities; on one patch the
              kernel path and the plain path against a float32 run of the
              dense masked model, and the float32 sparse and dense masked
              models against each other; the lazy block against its plain
              version at the plan's level-0 shapes
  5. dense    the same model without masks (the bench's --dense path), fast
              mode, lazy up-links: two volumes, launch counts, the plain
              path's volume, one patch against float32, the flip-free
              8-pass mean against the data-flip one on one tile
  6. data-flip the data-flip TTA path with the float32 logits head (the
              seg-head kernel's logits mode) and the materialised up-link
              route (the up-link kernel), one volume
  7. predict  the users' entry point: a model folder at the bench geometry
              (one-stage plans: 128^3 patches, 5 x (2,2,2) pools, one CT
              modality, 15 foreground classes, 1 mm) whose fold 0 the
              port's save_checkpoint writes (bench width, seed 0, the
              trained masks), and an input folder of two seeded cases (192^3
              at 1 mm; 160 x 144 x 96 at (2.0, 0.8, 0.8) mm, which resamples
              under a patch on one axis); cli/predict.main twice: (A)
              --all_in_gpu True -z, the fast mode on the sparse plan, (B)
              the exact mode with --mode fastest. Per case: each output's
              shape, spacing, origin, direction and labels; its kernel
              launches (tiles x passes x kernel_launches_per_forward); the
              seconds in preprocessing (the background thread), in
              predict_case inside the folder run and alone on the same data,
              and in export. In A, case 1's npz probabilities against the
              plain path's and a float32 plain run's, exported alike: the
              kernel path within 1.25x the plain path's error, argmax
              agreement within 0.5 points
  8. bench    python -m e2enet_tpu_torch.bench in a subprocess: exit 0 and
              the one JSON line (the reference bench.py's keys); echoes it
              and the stderr summary (ms/volume, the exact-f32 companion,
              the host's enqueue vs the device's time per forward)
  9. train    the backward kernels (the block backward, serving TPU kernels
              #2 and #4, and the down-link backward #8) against their plain
              versions at the train step's shapes (batch 2) and ragged ones
              (the block backward also at D = 1, with no part wanted and
              with one of two; the down-link backward also with exact ties
              on aligned rows, at C = 96 and on its scalar route at C = 5),
              with times, bounds and cuDNN's / max_pool3d's backward for
              context (the block backward also beside the four-launch
              design's times, the down-link backward beside a copy of x);
              every forward kernel at its main-path shape with batch 2;
              then the row-masked DSFF trainer of
              training/train_bench_masks.py at the bench width (batch 2 of
              128^3, 16 classes, density 0.2, seed 0): 8 steps on one
              synthetic batch with a mask update after steps 4 and 8 (over
              the serving and train phases every up-link and seg-head call
              on the bulk route). Per step: launches equal kernel_launches_per_train_step, a finite
              loss, dead rows zero in the parameters and the momentum; the
              row counts hold over each update; the loss falls; ms per step
              (CUDA events) and the peak memory. On a 2 x 64^3 batch, one
              step's gradients through the kernels, through the bf16 plain
              path and through a float32 plain run
  9b. parallel data-parallel training and tile-sharded prediction
              (parallel/mesh.py) at the bench width (batch 2 x 128^3,
              kernel DSFF masks at 0.2, bf16), through the users' entry
              points: (a) a world of one NCCL rank, three sharded steps
              against the single-device steps (losses within 1e-3,
              launches per step); two gloo ranks over CUDA tensors on the
              one card (NCCL refuses two ranks on one device, so
              parallel.launch(..., backend="gloo", _shared_device=True)):
              (b) make_grad_step over the ranks, a row each of 2 x 64^3,
              within 1.25x one device's error against a float32 plain run,
              and Trainer(num_devices=2, dummy_load=True) at the bench plan
              (its state broadcast by replicate_state, its rows through
              pinned memory, a mask update at step 2): two steps' losses
              within 1e-3 of Trainer on one device, the same state on both
              ranks, launches per step and rank; (c) predict_case(
              num_devices=2) on a ModelBundle of the bench model folder
              (the sparse plan, fast mode) on a 128 x 128 x 256 volume (3
              tiles x 8 passes) against one device's: on the plain path the
              probabilities within 1e-3; on the kernel path, whose
              statistics' atomics make two runs of one device differ
              (printed beside it), the mean |dp| within 1e-3 and argmax
              agreement >= 99.5 %, the launches summed over the ranks; and
              predict_from_folder(num_devices=2) on one case of that size
              (rank 0 preprocesses, broadcasts and exports): its labels
              agree with one device's on >= 99.5 % of voxels, the launches
              summed over the ranks; (d) cli.predict --num_devices 2
              raising "only 1 present"
  9c. spatial H-sharded training over a (data x space) grid
              (parallel/halo.py, mesh.make_grid): (1) kernels #1, #2/#4
              and #5 in halo mode on H slabs of the bench shapes (1 x 128
              x 64 x 128: 48 -> 48 with the top row, the bottom row and
              both, 48 + 48 -> 48 with both, #5 48 -> 96 with its top row;
              1 x 64 x 32 x 64: 96 + 96 + 48 -> 96; the backward at batch
              2) against their plain versions with the same rows and
              against the rows of the whole-H kernel's output (halo ms
              beside the slab alone and the whole H); two gloo ranks on
              cuda:0 as a 1 x 2 grid: (2) make_sharded_train_step at the
              bench width (batch 2 x 128^3, each rank 2 x 128 x 64 x 128,
              kernel DSFF at 0.2; each after a first step from the same
              state) against one device's step run twice
              (the loss within 1e-3, the parameters within 4x the two
              runs' spread, the ranks' states equal to the bit, launches
              per step and rank kernel_launches_per_train_step(...,
              spatial=2), each rank's peak memory at most 0.7 of one
              device's); (3) Trainer(num_devices=2, spatial_parallel=2,
              dummy_load=True) against Trainer on one device; (4)
              dryrun._rank_run('cuda') on the two ranks
  10. trainer the users' chain from raw data (the plan CLI, cli/train.main,
              then cli/predict.main): a seeded raw task (write_raw_task: six
              cases of about 160^3 at 1 mm, one CT modality, 16 classes with
              class-specific intensities) that `python -m
              e2enet_tpu_torch.cli.plan_and_preprocess -t 501
              --verify_dataset_integrity` crops, fingerprints, plans and
              preprocesses in a fresh process (its exit code and wall
              seconds), and again in a spawned child with a spy on each step
              (the seconds of each), the two runs' plans and stage files
              equal; the plan asserted to be one stage, 128^3, 5 x (2, 2, 2)
              pools, batch 2, CT normalisation from the analyser's statistics;
              4 train and 2 validation cases in splits_final.pkl; the trainer
              at the bench width (48 base features, 128^3 patches, batch 2,
              bf16) with kernel-granular DSFF (density 0.2, a mask update
              every 4 steps): 2 epochs of 6 batches (2 validation batches
              each), then -c --epochs 3 from 'latest', which ends in the
              fold's validation (summary.json, postprocessing.json; the
              first run leaves its validation to it);
              cli.predict with the trained fold on one validation case.
              Checks: every loss finite, the first epoch's train loss above
              the last, launches per step equal to
              kernel_launches_per_train_step, after each mask update the
              parameters and momentum zero where the masks are and every
              kernel's alive count held, the state -c loads equal to the
              'latest' file to the bit and the epoch at 2, a finite Dice for
              every foreground label, the predicted labels in [0, 16), the
              augmentation on the C++ warp, no jax. Prints ms per step (CUDA
              events), the host's wait per batch in next(tr_gen), s per epoch,
              s per validation case (prediction, export), the peak memory
  11. options the trainer's options at the bench width (48 base features,
              16 classes, bf16, row masks at density 0.2, seed 0, the train
              phase's batch of 2 x 128^3): SGD, Ranger and Adam 8 steps each
              with gradient-growth mask updates (make_grad_step on the
              step's batch) after steps 4 and 8. Per step launches equal
              kernel_launches_per_train_step, a finite loss, dead rows zero
              in the parameters and every optimizer buffer; per update the
              gradient step's launches the same and the row counts held;
              the loss falling; ms per step, ms per update and the peak
              memory per optimizer. One step of each of the 12 losses of
              LOSS_REGISTRY (the region losses on one-hot targets from the
              labels): finite loss and gradient norm, launches as counted.
              make_grad_step on 2 x 64^3 against the bf16 plain path and a
              float32 plain run (the 1.25x rule) and its ms at 2 x 128^3.
              cli/train.main for one epoch on [trainer]'s task with -tr
              nnUNetTrainerV2_Ranger_lr3en4 --growth gradient --granularity
              kernel (4 batches, an update every 2 steps; the fold's
              validation, which [trainer] checks, left out): finite
              losses, launches per step and per gradient step, alive
              counts held, the 'latest' checkpoint's Ranger state loading
              back equal to the bit. Prints the phase's seconds
  12. dsff    every DSFF engine of the trainer at the bench width (48 base
              features, 16 classes, bf16, SGD, seed 0, the train phase's
              batch of 2 x 128^3): the local element prune (uniform_ori at
              0.3, 8 steps, random growth after step 4, gradient growth
              after step 8) beside 4 row-mask steps; the global prune (ERK
              at 0.3, gradient growth, the grow schedule's ratio, updates
              after steps 4 and 8); GMP from dense at three epochs of its
              ramp; the lottery ticket, snip from make_grad_step's
              gradients and GraSP on 1 x 64^3 (the plain path). Per step
              launches equal kernel_launches_per_train_step, a finite
              loss, dead elements zero in the parameters and momentum;
              per update every kernel's alive count held (local), the
              pruned count the host's global threshold's and the grown
              count within 5 sigma of the Bernoulli budget (global), each
              kernel's pruned count int(rate * size) plus ties (GMP), the
              densities of the lottery ticket, snip and GraSP within 1e-3
              of the target plus ties, GraSP launching no kernel. Then on
              [trainer]'s task cli/train.main with --sparse_init ERK
              --prune_mode global --growth gradient --update_frequency 2
              (one epoch of 4 batches, then -c for a second; every logged
              regrow_ratio the host's grow_schedule_ratio, the 'latest'
              element masks and fired masks in the flax layout loading
              back equal to the bit), --sparse_init GMP for 2 epochs (a
              GMP line per epoch, the density falling), and cli/predict.
              main on one case with the global run's fold (dense masked,
              no plan; launches tiles x passes x per forward; labels in
              [0, 16)). Prints ms per step, ms per mask update per mode,
              GraSP's seconds and peak memory, the phase's seconds
  13. 2d      2D plans and shiftConvPP_noshift at the bench width (48 base
              features, 16 classes, bf16, one group of shift 0 at every
              kernel site): the plan CLI with -pl3d None -pl2d
              ExperimentPlanner2D_v21 on [trainer]'s raw task in a fresh
              process (the plan asserted to be depth 1 with five (1, 2, 2)
              pools); every kernel of the 2D path against its plain version
              at the plan's shapes (batch B of 1 x H x W slices: #1 at each
              level-0 and level-1 block and in all 8 mirror passes, #2 at
              the nest nodes, #5 at stride (1, 2, 2) in all 8 passes, #6 at
              stride (1, 2, 2), #7 and #8 at window (1, 2, 2), #9 at the
              batch, #10 at one slice; the routes #6, #8, #9 and #10 took),
              #3 and #4 with the one-group table at the main path's shapes;
              one step's gradients of the 2D model against a float32 plain
              run (the 1.25x rule); cli/train.main --network 2d with
              kernel DSFF at 0.2 (one epoch of 4 + 1 batches at the planned
              batch, then -c to a second; launches per step, the loss
              falling, dead entries zero; no run validates, the tile loop
              of a 2D plan runs in the predict CLI below),
              --Tconv shiftConvPP_noshift on the 3D plan for 4 steps (the
              lazy route); cli/predict.main -m 2d --mode fastest on one
              case (launches tiles x passes x per forward, labels in
              [0, 16), probabilities summing to 1) and one slice of it
              against float32. Prints ms per step, the host's wait per
              batch, s per epoch, the peak memory
  14. cascade the 3d_lowres -> 3d_cascade_fullres cascade at the bench
              width (48 base features, 16 classes, bf16, kernel DSFF at
              0.2): #1 at the cascade's first block (one modality and the
              one-hot labels: 16 input channels, and 3 at 3 classes) and
              the block backward there (wgrad only, as the train step
              runs it, and with its input's gradient), #9 and #10 at 3
              classes, against their plain versions and timed; a task of
              three of [trainer]'s cases whose stage 1 is [trainer]'s plan
              and files and whose stage
              0 (1.25 mm, 128^3 median, 128^3 patches, 5 pools, batch 2)
              the port's get_properties_for_stage plans and its
              preprocessor writes; cli/train.main --network 3d_lowres
              --fold all (3 epochs of 6 + 1 batches; its validation left
              out) and its predict_next_stage over the three cases (a uint8
              segFromPrevStage file per case at the stage-1 shape, its
              launches tiles x passes x per forward); cli/train.main
              --network 3d_cascade_fullres --fold all (one epoch of 4 + 1
              batches, the validation over the three cases; 16 input
              channels, launches per step the 3D step's, a validation
              batch's one-hot channels 0/1 and at most one per voxel); one step's gradients of the trained
              cascade model against a float32 plain run (the 1.25x rule);
              cli/predict.main -m 3d_cascade_fullres --mode fastest on one
              raw case (the _lowres folder, shape and labels, launches per
              stage). Prints ms per step, the host's wait per batch (the
              cascade's one-hot augmentation runs on it), s per validation
              case, the peak memory, the phase's seconds
  15. variants the variants' knobs and the region trainers at the bench
              width (48 base features, bf16, kernel DSFF at 0.2) through
              cli/train.main: #1 at the region model's first block (four
              modalities: 4 -> 48, the 4-byte row route) and the block
              backward's wgrad there, #9 at 48 -> 3 regions, against their
              plain versions and timed; -tr
              nnUNetTrainerV2_noDeepSupervision and -tr
              nnUNetTrainerV2_DA5 on [trainer]'s task (4 + 1 batches each,
              no validation: launches per step with the seg head once, ms
              per step beside the deep-supervision step's; the trainer's
              AugmentParams apply_da_level's, the host's wait per batch);
              a BraTS-like raw task (four seeded ~136 x 160 x 136 cases at
              1 mm, four MR modalities, labels 0-3) planned by the plan
              CLI, then -tr nnUNetTrainerV2_fullEvals (regions, DC + BCE,
              a validation every epoch; 3 train and 1 validation case, 2
              epochs of 3 + 1 batches): validation_ep001/, _ep002/ (one
              pass) and validation_raw/ (8 passes) each with a summary.csv
              of the three regions and no postprocessing, the exported
              region probabilities finite in [0, 1], the labels in {0, 1,
              2, 3} at the case's geometry, every validation forward on #9
              and never #10; one step's gradients of the region model on 2
              x 64^3 x 4 channels against a float32 plain run (the 1.25x
              rule); load_pretrained_weights of [trainer]'s fold checkpoint
              into the region model (the count of the host's rule, the
              first block kept). Prints ms per step, the host's wait per
              batch, s per validation case, the phase's seconds
  16. ensembles the last step of the nnU-Net workflow on [trainer]'s
              task, with the 3d_fullres fold 0 of [trainer] and the 2d
              fold 0 of [2d]: cli/train.main --validation_only on each
              with validate(save_softmax=True, do_mirroring=False) on one
              validation case into a folder of its own (float16 softmax
              and its pkl; launches tiles x 1 pass x per forward);
              figure_out_what_to_submit over both networks
              (the pairwise ensemble built, scored and its postprocessing
              determined, the ranking of all three candidates, summary.csv
              a row per candidate); consolidate_folds on the 3d_fullres
              folder; cli/predict.main -z -m 3d_fullres (TTA) on that
              case (launches tiles x passes x per forward), merged with the 2d fold's saved softmax of it and the
              ensemble's postprocessing.json (labels, the input's
              geometry, the plain merge's labels under the decision);
              predict_from_folder_amos2022 with TTA on a 128^3 crop of
              that case written at (1.25, 0.8, 1.0) mm (its launches tiles
              x passes x per forward, the card's trilinear resample's
              labels equal to the CPU resample's of the same softmax where
              its top two differ by more than 1e-4, the input's geometry).
              Prints the seconds of each step, of
              resample_softmax_on_device (the softmax's upload and the
              resize alone by CUDA events beside it) and of the phase
  17. models the architecture switches and the remaining networks (Queue 1
              item 6): kernels #1-#10 at base 24 (nnUNetTrainerV2_
              3ConvPerStage's width: #1 at 1 -> 24, 24 -> 24, 24 + 24 -> 24,
              48 -> 48 and 48 + 48 + 24 -> 48, #3 at 24 + up 48 -> 24, #5 at
              24 -> 48, #6 at 48 -> 24, #7 and #10/#9 at C = 24, #2/#4 and #8
              at batch 2) against their plain versions, timed with bounds
              and library calls; one bf16 forward per new network (the
              norms, the nonlinearities, nonlin_before_norm, 3 convs per
              stage, seg_bias, allConv3x3, _313, _331, ori, nodff, resenc)
              at its preset's width on a 1 x 128^3 patch against a float32
              forward of the same weights (the kernel route by the 1.25x
              rule, its launches as counted; the materialised route
              launching nothing); cli/train.main on [trainer]'s task with -tr
              nnUNetTrainerV2_3ConvPerStage, _BN_ReLU and _ResencUNet (2
              epochs of 3 + 1 batches, no validation; finite and falling
              losses, launches per step as counted); cli/predict.main with
              TTA on one case with the resenc fold (data flips) and the
              BN_ReLU fold (flip-free, its network from the sidecar's
              switches); a reference-format .model of the 3-conv fold's
              weights (export_unetpp_state_dict) converted by
              convert_reference_model_to_native: its parameters the fold's,
              its labels the native checkpoint's. Prints the seconds of
              each step
  18. device_augment  the training batches augmented on the card
              (ops/device_augment.py): cli/train.main --device_augment on
              [trainer]'s task (2 epochs of 3 + 1 batches, no validation;
              finite losses, launches per step [trainer]'s, the training
              pipeline raw), the host's wait per batch beside [trainer]'s
              and the augmentation's device and host ms per batch in the
              loop; the augmenter at the generator patch -> 128^3, batch 2,
              on the card against the CPU with every transform on (data
              within 1e-4, targets equal but at .5 ties), its ms per batch
              warped, cropped, with every transform and with fresh draws,
              beside the host's augment_batch per batch
  19. formats challenge downloads in the other formats, on the host
              with numpy and the standard library (formats_phase): a
              PROMISE12 tree of .mhd files (two training MR cases of 20 x
              256^2 and 24 x 320^2, one with zlib, and a test case)
              through convert_promise2012; a DICOM series of 24 x 256^2
              (implicit VR, out of order, files without an extension)
              through read_dicom_series, and its volume through NRRD
              (gzip and raw); a PIR VerSe2019 tree (96 x 160 x 128)
              through convert_verse2019, which reorients it to RAS, then
              reverted; every voxel checked against its source. The plan
              CLI (-t 24 --verify_dataset_integrity) on the converted task
              in a fresh process; a base-8 fold at its plan written by
              save_checkpoint, packed by export_pretrained_model and
              installed into a fresh RESULTS_FOLDER (the installed files
              the packed ones, the weights restored by ModelBundle on the
              CPU). No kernel launches. Prints each step's seconds
  20. experiments  the experiment kernels (TPU kernels #11-#14) against
              their plain versions at the experiments' main shapes (1 x 128^3
              x 48 -> 48 bf16; the ring shift + conv on its TMA route,
              checked by its route counter, beside its first design (the
              control, also in turns) and #1 on the same input; the
              pipelined block at l0_48+48_to48 with both
              affines, also against kernel #1 itself, equal to the bit, and
              the ring's depth it took; the channels-first block on its TMA
              route, checked by its route counter; the products at 4096^3
              on the wgmma route, checked by its route counter, beside their
              mma.sync control and the int8 repack of B alone) and at ragged
              ones (D = 3, W = 13, C in {1, 8, 24}, N = 2, the ring shift +
              conv there on the route its rule gives, also at CO = 56, D = 1
              and 2 and H, W off its tile; the channels-first
              block there on its ldg route and at W = 72, H = 7 on its TMA
              route; M, N, K off the tile on both routes), the
              channels-first block with the affine and the statistics each
              on and off, the ring shift's backward; times, bounds and the
              library call (cuDNN's conv of the pre-shifted operand, #1
              beside the pipelined block, torch.matmul / torch._int_mm; none
              for the shift and the relayout's copy); the pipelined block
              also in turns with #1 and its one-stage control;
              then each experiment's `main` once with few repetitions, its
              launches counted as the "experiments" path
  21. report  one JSON line with every kernel's launches, error, times and
              bound, the nvidia-smi line, and last {"ok": true, ...}

Needs torch built for CUDA and nvcc; never imports jax.
"""
import json
import subprocess
import sys
import time

import numpy as np

T_START = time.perf_counter()


def stamp(done: str) -> None:
    """Print the seconds since the script started, after `done`."""
    print(f"[time] {done} done at {time.perf_counter() - T_START:.1f} s",
          flush=True)

PATCH = (128, 128, 128)
VOLUME = (192, 192, 192)
NUM_CLASSES = 16
TTA = 8
# the card's peaks (NVIDIA H100 SXM data sheet, dense): device memory
# bytes/s, bf16 tensor-core and float32 CUDA-core operations/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# kernel vs plain: both sum exact bf16 products in float32 from identical
# bf16 operands and differ only in summation order (~1e-6 relative), so a
# stored bf16 value differs by at most one rounding step; allow 2 bf16 ulps
# of the channel's largest |y|. Stats: float32 sums whose order changes with
# the atomics, relative to sum|y| (for the sum) and sum y^2. The down-link
# is exact but for the rounding of its affine: one bf16 step. Probabilities:
# one bf16 step at the largest probability (2^-8), sums to 1 within 1e-2.
# Logits: float32 sums in another order, 1e-4 of the largest |logit|.
Y_ULPS = 2.0
# two kernels that add the same exact products in another float32 order:
# a bf16 value moves by one step at most
ORDER_ULPS = 1.0
STATS_RTOL = 1e-3
PROB_ATOL = 2.0 ** -8
LOGIT_RTOL = 1e-4
# whole model on one patch: the kernel path and the plain path (both bf16)
# against the same weights run in float32. Last-bit bf16 differences grow
# through ~25 layers of a random-weight net, so the two bf16 paths need not
# agree closely with each other; the kernel path must be as close to the
# float32 model as the plain path is: mean |dlogit| within 1.25x, argmax
# agreement within 0.5 points. The same rule holds the flip-free 8-pass mean
# probabilities to the data-flip ones, both against a float32 data-flip run.
ERR_RATIO = 1.25
AGREE_SLACK = 0.005
# backward kernels vs plain: gx as y (ct is rounded to bf16 after float32
# sums in another order); gW, gb and g(affine) are float32 sums over up to
# 4.2M pixels (2 x 128^3) in another order and with atomics: within 2e-3 of
# the tensor's largest |value|
BWD_RTOL = 2e-3
# the four-launch block backward's ms per call at the train step's shapes
# (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's
BWD_FOUR_LAUNCH_MS = {"l0_48+u48_to48": 13.620, "l0_48_to48": 7.903,
              "l1_96+96+48_to96": 5.233, "l1_96_to96": 2.430}
# the experiment kernels: statistics within 1e-4 of their largest value;
# the bf16 product (float32 out) within 1e-3 of its largest |value| (sums
# over K = 4096 in another order); the rest as above or equal to the bit
EXP_STATS_RTOL = 1e-4
GEMM_RTOL = 1e-3
PEAK_INT8 = 1979e12
# the train phase
TRAIN_STEPS = 8
TRAIN_UPDATE_EVERY = 4
GRAD_PATCH = (64, 64, 64)
PROB_SUM_ATOL = 1e-2
FLIPS = [(fd, fh, fw) for fd in (False, True) for fh in (False, True)
         for fw in (False, True)]
# the fused block's calls on the serving paths (dense widths): level 0 the
# first block, the 48 -> 48 blocks and the data-flip path's nest nodes;
# level 1 the 96 -> 96 blocks and the nest nodes
FUSED_ON_PATH = ("l0_c1_to48", "l0_48_to48", "l0_48+48_to48", "l1_96_to96",
                 "l1_96+96+48_to96")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HOST_CALLS = 50


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """The host's time to enqueue one call of fn: `calls` calls issued back
    to back and not waited for, after the device has drained (what a
    host-bound path pays per call; few enough calls that the launch queue
    does not fill)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(least ms on the card, what bounds it)"""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def f16_weights():
    """(the float16 Gaussian weight sum per voxel, tile count), as the
    predictor accumulates it. The Gaussian's tails fall below float16's
    normal range (2^-14) near the tile corners and its corners (~1e-11)
    underflow to 0, so voxels reached only by tile corners get few-bit or
    zero weights; the reference's float16 accumulation does the same."""
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, gaussian_importance_map)
    g = gaussian_importance_map(PATCH).astype(np.float16)
    w = np.zeros(VOLUME, np.float16)
    steps = compute_steps_for_sliding_window(PATCH, VOLUME, 0.5)
    starts = [(a, b, c) for a in steps[0] for b in steps[1] for c in steps[2]]
    for a, b, c in starts:
        w[a:a + PATCH[0], b:b + PATCH[1], c:c + PATCH[2]] += g
    return w, len(starts)


def bf16_ulp(v):
    """ulp of bfloat16 (8 significant bits) at |v|, elementwise."""
    import torch
    e = torch.floor(torch.log2(v.clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def y_err(y, y_ref, ulps):
    """(within `ulps` bf16 steps of each channel's largest |y|, max abs)"""
    import torch
    yk, yp = y.float(), y_ref.float()
    check(bool(torch.isfinite(yk).all()), "non-finite kernel output")
    dims = tuple(range(yk.dim() - 1))
    err = (yk - yp).abs()
    tol = ulps * bf16_ulp(yp.abs().amax(dim=dims))
    return bool((err.amax(dim=dims) <= tol).all()), float(err.max())


def stats_err(s_k, s_p, y_ref):
    abs_sum = y_ref.float().abs().sum(dim=(1, 2, 3))
    d1 = (s_k[..., 0] - s_p[..., 0]).abs() / abs_sum.clamp_min(1e-30)
    d2 = (s_k[..., 1] - s_p[..., 1]).abs() / s_p[..., 1].abs().clamp_min(
        1e-30)
    return float(max(d1.max(), d2.max()))


class Rnd:
    """Seeded random tensors on the card."""

    def __init__(self, seed):
        import torch
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def __call__(self, *shape, scale=1.0, shift=0.0):
        import torch
        return (torch.randn(shape, generator=self.gen, device="cuda")
                * scale + shift)

    def affine(self, N, C):
        return self(N, C, scale=0.3, shift=1.0), self(N, C, scale=0.2)


def report(name, shape, res, extra=""):
    print(f"  {name} {shape}: max abs err {res['max_abs_err']:.3e}{extra}  "
          f"kernel {res['ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  "
          f"bound {res['bound_ms']:.4f} ms by {res['bound_by']} "
          f"({100 * res['bound_ms'] / res['ms']:.1f} % of it)  library "
          f"{res['library_ms']:.4f} ms", flush=True)


def fused_case(name, N, D, H, W, part_c, affine, CO, rnd, reps,
               flips=(False, False, False), groups=None):
    """Kernel #1 vs plain on random bf16 inputs (groups: the shift groups,
    default shiftConvPP's); with reps, also the same kernel with its taps
    on mma.sync (the control for its wgmma loop: mma_ms, y within
    ORDER_ULPS of the kernel's) and the host's time per call (host_ms)."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import fused_block as fb
    parts = [rnd(N, D, H, W, c).to(torch.bfloat16) for c in part_c]
    affines = [rnd.affine(N, c) if a else None
               for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = rnd(CO, scale=0.1)
    y_k, s_k = fb.fused_shift_conv_block(parts, kernel, bias, affines, flips,
                                         groups)
    y_p, s_p = fb.fused_shift_conv_block_ref(parts, kernel, bias, affines,
                                             flips, groups)
    torch.cuda.synchronize()
    ok, err = y_err(y_k, y_p, Y_ULPS)
    srel = stats_err(s_k, s_p, y_p)
    check(ok, f"{name}: y differs by more than {Y_ULPS} bf16 ulps")
    check(srel <= STATS_RTOL, f"{name}: stats rel err {srel}")
    if reps == 0:
        return dict(max_abs_err=err)
    # the library's bf16 conv of the already shifted, normalised operand:
    # context for the kernel's time, not a replacement for it
    x2 = torch.cat(parts, -1).reshape(N * D, H, W, C).permute(0, 3, 1, 2)
    w2 = kernel.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b_ms, b_by = bound(nbytes(*parts, y_k) + 9 * C * CO * 2,
                       2.0 * N * D * H * W * 9 * C * CO, PEAK_BF16)
    y_m, _ = fb.fused_shift_conv_block(parts, kernel, bias, affines, flips,
                                       groups, wgmma=False)
    check(y_err(y_m, y_k, ORDER_ULPS)[0], f"{name}: the mma.sync control's "
                                          f"y differs by more than "
                                          f"{ORDER_ULPS} ulp")
    args = (parts, kernel, bias, affines, flips, groups)
    res = dict(max_abs_err=err, stats_rel=srel,
               ms=cuda_ms(lambda: fb.fused_shift_conv_block(*args), reps),
               mma_ms=cuda_ms(lambda: fb.fused_shift_conv_block(
                   *args, wgmma=False), reps),
               host_ms=host_ms(lambda: fb.fused_shift_conv_block(*args)),
               plain_ms=cuda_ms(lambda: fb.fused_shift_conv_block_ref(*args),
                                reps),
               library_ms=cuda_ms(lambda: F.conv2d(x2, w2, padding=1), reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} C={list(part_c)} "
           f"affine={list(affine)} CO={CO}", res,
           f" (stats rel {srel:.2e}; taps on mma.sync {res['mma_ms']:.4f} "
           f"ms; host {res['host_ms']:.4f} ms per call)")
    return res


def lazy_check(name, parts, up, kernel, bias, affines, flips, groups,
               reps):
    """Kernel #3 (the fused block with a lazy up-link part) vs plain on the
    given inputs, one launch per call; with reps, also the same kernel with
    its taps on mma.sync (the control for its wgmma loop: mma_ms), the
    materialised route (#6, then #1), #1 alone on the materialised concat
    (the conv without the up-link: kernel1_ms) and cuDNN's conv of the
    materialised operand."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import fused_block as fb
    from e2enet_tpu_torch.ops import qfused, qlink
    args = (parts, up, kernel, bias, affines, flips, groups)
    before = qfused.lazy_up_fused_block.launches
    y_k, s_k = qfused.lazy_up_fused_block(*args)
    check(qfused.lazy_up_fused_block.launches == before + 1,
          f"{name}: not one lazy launch per call")
    y_p, s_p = qfused.lazy_up_fused_block_ref(*args)
    torch.cuda.synchronize()
    ok, err = y_err(y_k, y_p, Y_ULPS)
    srel = stats_err(s_k, s_p, y_p)
    check(ok, f"{name} flips={flips}: y differs by more than {Y_ULPS} bf16 "
              f"ulps")
    check(srel <= STATS_RTOL, f"{name} flips={flips}: stats rel err {srel}")
    if reps == 0:
        return dict(max_abs_err=err)
    y_m, _ = qfused.lazy_up_fused_block(*args, wgmma=False)
    check(y_err(y_m, y_p, Y_ULPS)[0], f"{name}: the mma.sync control's y "
                                      f"differs by more than {Y_ULPS} ulps")
    N, D, H, W, CO = y_k.shape
    cin, cout = up.kernel.shape[:2]
    C = kernel.shape[1]

    def materialised():
        return fb.fused_shift_conv_block(
            list(parts) + [qlink.uplink(*up)], kernel, bias,
            list(affines) + [None], flips, groups)

    concat = list(parts) + [qlink.uplink(*up)]

    x2 = torch.cat(list(parts) + [qlink.uplink_ref(*up)], -1).reshape(
        N * D, H, W, C).permute(0, 3, 1, 2)
    w2 = kernel.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    # the conv's and the up-link's products; each input read once
    b_ms, b_by = bound(nbytes(*parts, up.raw, y_k) + (9 * C * CO
                                                      + 8 * cin * cout) * 2,
                       2.0 * N * D * H * W * (9 * C * CO + cin * cout),
                       PEAK_BF16)
    res = dict(max_abs_err=err, stats_rel=srel,
               ms=cuda_ms(lambda: qfused.lazy_up_fused_block(*args), reps),
               host_ms=host_ms(lambda: qfused.lazy_up_fused_block(*args)),
               mma_ms=cuda_ms(lambda: qfused.lazy_up_fused_block(
                   *args, wgmma=False), reps),
               plain_ms=cuda_ms(lambda: qfused.lazy_up_fused_block_ref(*args),
                                reps),
               materialised_ms=cuda_ms(materialised, reps),
               kernel1_ms=cuda_ms(lambda: fb.fused_shift_conv_block(
                   concat, kernel, bias, list(affines) + [None], flips,
                   groups), reps),
               library_ms=cuda_ms(lambda: F.conv2d(x2, w2, padding=1), reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} C={[p.shape[-1] for p in parts]}"
           f"+up {cin}->{cout} CO={CO}", res,
           f" (stats rel {srel:.2e}; host {res['host_ms']:.4f} ms per call; "
           f"taps on mma.sync {res['mma_ms']:.4f} ms; materialised #6 + #1 "
           f"{res['materialised_ms']:.4f} ms, #1 alone on its concat "
           f"{res['kernel1_ms']:.4f} ms)")
    return res


def lazy_case(name, N, Dc, Hc, Wc, part_c, affine, cin, cout, CO, rnd, reps,
              flips=(False, False, False), groups=None):
    """Kernel #3 vs plain on random bf16 inputs: parts at (2Dc, 2Hc, 2Wc),
    the level-below pending raw at (Dc, Hc, Wc)."""
    import torch
    from e2enet_tpu_torch.ops import qfused
    bf = torch.bfloat16
    parts = [rnd(N, 2 * Dc, 2 * Hc, 2 * Wc, c).to(bf) for c in part_c]
    affines = [rnd.affine(N, c) if a else None
               for c, a in zip(part_c, affine)]
    up = qfused.LazyUp(rnd(N, Dc, Hc, Wc, cin).to(bf), *rnd.affine(N, cin),
                       rnd(cin, cout, 2, 2, 2, scale=(1.0 / cin) ** 0.5))
    C = sum(part_c) + cout
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    return lazy_check(name, parts, up, kernel, rnd(CO, scale=0.1), affines,
                      flips, groups, reps)


def strided_read_bytes(x, Do, flips, sd=2, groups=None):
    """The bytes of x a strided pass must read: output depth do of a
    channel group with shift s reads source depth sd*do + parity - s, so at
    a depth stride of 2 each channel reads the source depths of one parity
    class (about half of x), each once."""
    from e2enet_tpu_torch.ops.fused_block import shift_groups
    from e2enet_tpu_torch.ops.shift import strided_depth_source
    N, D, H, W, C = x.shape
    groups, parity = strided_depth_source(groups or shift_groups(C), sd,
                                          flips[0])
    rows = sum((c1 - c0) * len({sd * do + parity - sh for do in range(Do)}
                               & set(range(D)))
               for c0, c1, sh in groups)
    return N * rows * H * W * x.element_size()


def strided_case(name, N, D, H, W, C, CO, rnd, reps, flips=(False,) * 3,
                 stride=(2, 2, 2), groups=None):
    """Kernel #5 vs plain (groups: the shift groups, default
    shiftConvPP's)."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import qstride
    x = rnd(N, D, H, W, C).to(torch.bfloat16)
    m, o = rnd.affine(N, C)
    k = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = rnd(CO, scale=0.1)
    args = (x, m, o, k, b, stride, flips, groups)
    y_k, s_k = qstride.strided_fused(*args)
    y_p, s_p = qstride.strided_fused_ref(*args)
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape, f"{name}: shape {tuple(y_k.shape)}")
    ok, err = y_err(y_k, y_p, Y_ULPS)
    srel = stats_err(s_k, s_p, y_p)
    check(ok, f"{name} flips={flips}: y differs by more than {Y_ULPS} "
              f"bf16 ulps")
    check(srel <= STATS_RTOL, f"{name} flips={flips}: stats rel err {srel}")
    if reps == 0:
        return dict(max_abs_err=err)
    x2 = x.reshape(N * D, H, W, C).permute(0, 3, 1, 2)
    w2 = k.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    _, Do, Ho, Wo, _ = y_k.shape
    b_ms, b_by = bound(strided_read_bytes(x, Do, flips, stride[0], groups)
                       + nbytes(y_k) + 9 * C * CO * 2,
                       2.0 * N * Do * Ho * Wo * 9 * C * CO, PEAK_BF16)
    # (a depth stride of 2 slices the folded batch: one sample)
    res = dict(max_abs_err=err, stats_rel=srel,
               ms=cuda_ms(lambda: qstride.strided_fused(*args), reps),
               plain_ms=cuda_ms(lambda: qstride.strided_fused_ref(*args),
                                reps),
               library_ms=cuda_ms(lambda: F.conv2d(
                   x2[::stride[0]], w2, stride=stride[1:], padding=1), reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} C={C} CO={CO}", res,
           f" (stats rel {srel:.2e})")
    return res


def uplink_case(name, N, D, H, W, C, cout, rnd, reps, flips=(False,) * 3,
                route="bulk", stride=(2, 2, 2)):
    """Kernel #6 vs plain, on the route its shape must take (checked by the
    route counter; route None: the route it took, recorded); with reps,
    also the host's time per call (host_ms)."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import qlink
    x = rnd(N, D, H, W, C).to(torch.bfloat16)
    m, o = rnd.affine(N, C)
    k = rnd(C, cout, *stride, scale=(1.0 / C) ** 0.5)
    before = dict(qlink.uplink.routes)
    y_k = qlink.uplink(x, m, o, k, flips)
    if route is None:
        route = next((r for r, n in qlink.uplink.routes.items()
                      if n != before[r]), None)
        check(route is not None, f"{name}: no route counted")
    check(qlink.uplink.routes[route] == before[route] + 1,
          f"{name}: not on the {route} route ({before} -> "
          f"{qlink.uplink.routes})")
    y_p = qlink.uplink_ref(x, m, o, k, flips)
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape, f"{name}: shape {tuple(y_k.shape)}")
    ok, err = y_err(y_k, y_p, Y_ULPS)
    check(ok, f"{name}: y differs by more than {Y_ULPS} bf16 ulps")
    if reps == 0:
        print(f"  {name} N={N} D={D} H={H} W={W} Cin={C} Cout={cout} "
              f"flips={list(flips)}: route {route}, max abs err {err:.3e}",
              flush=True)
        return dict(max_abs_err=err, kernel_route=route)
    # the library's transposed conv of the normalised input, channels-last
    x3 = x.permute(0, 4, 1, 2, 3)
    k3 = k.to(torch.bfloat16)
    kv = int(np.prod(stride))
    b_ms, b_by = bound(nbytes(x, y_k) + C * kv * cout * 2,
                       2.0 * N * D * H * W * C * kv * cout, PEAK_BF16)
    res = dict(max_abs_err=err, kernel_route=route,
               ms=cuda_ms(lambda: qlink.uplink(x, m, o, k, flips), reps),
               host_ms=host_ms(lambda: qlink.uplink(x, m, o, k, flips)),
               plain_ms=cuda_ms(lambda: qlink.uplink_ref(x, m, o, k, flips),
                                reps),
               library_ms=cuda_ms(lambda: F.conv_transpose3d(
                   x3, k3, stride=stride), reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} Cin={C} Cout={cout} "
           f"flips={list(flips)}", res,
           f" (route {route}; host {res['host_ms']:.4f} ms per call)")
    return res


def downlink_case(name, N, D, H, W, C, rnd, reps, window=(2, 2, 2)):
    """Kernel #7 vs plain."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import qlink
    x = rnd(N, D, H, W, C).to(torch.bfloat16)
    m, o = rnd(N, C), rnd(N, C, scale=0.2)          # both signs of mult
    y_k = qlink.downlink(x, m, o, window)
    y_p = qlink.downlink_ref(x, m, o, window)
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape, f"{name}: shape {tuple(y_k.shape)}")
    ok, err = y_err(y_k, y_p, 1.0)
    check(ok, f"{name}: y differs by more than one bf16 ulp")
    if reps == 0:
        return dict(max_abs_err=err)
    x3 = x.permute(0, 4, 1, 2, 3)
    # two compares per input value, the affine and lrelu per output
    b_ms, b_by = bound(nbytes(x, y_k, m, o),
                       2.0 * x.numel() + 4.0 * y_k.numel(), PEAK_F32)
    res = dict(max_abs_err=err,
               ms=cuda_ms(lambda: qlink.downlink(x, m, o, window), reps),
               plain_ms=cuda_ms(lambda: qlink.downlink_ref(x, m, o, window),
                                reps),
               library_ms=cuda_ms(lambda: F.max_pool3d(x3, window), reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} C={C}", res)
    return res


def seghead_case(name, N, D, H, W, C, K, probs, rnd, reps, route="bulk"):
    """Kernel #10 (probs) or its logits mode #9 vs plain, on the route its
    shape must take (checked by the route counter; route None: the route
    it took, recorded); with reps, also the host's time per call
    (host_ms)."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import qlink
    x = rnd(N, D, H, W, C).to(torch.bfloat16)
    m, o = rnd.affine(N, C)
    w = rnd(K, C, scale=(2.0 / C) ** 0.5)
    pd = torch.bfloat16 if probs else None
    before = dict(qlink.seghead.routes)
    y_k = qlink.seghead(x, m, o, w, pd)
    if route is None:
        route = next((r for r, n in qlink.seghead.routes.items()
                      if n != before[r]), None)
        check(route is not None, f"{name}: no route counted")
    check(qlink.seghead.routes[route] == before[route] + 1,
          f"{name}: not on the {route} route ({before} -> "
          f"{qlink.seghead.routes})")
    y_p = qlink.seghead_ref(x, m, o, w, pd)
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape and y_k.dtype == y_p.dtype,
          f"{name}: {tuple(y_k.shape)} {y_k.dtype}")
    check(bool(torch.isfinite(y_k.float()).all()), f"{name}: non-finite")
    err = float((y_k.float() - y_p.float()).abs().max())
    if probs:
        s_dev = float((y_k.float().sum(-1) - 1.0).abs().max())
        check(err <= PROB_ATOL, f"{name}: probs differ by {err}")
        check(s_dev <= PROB_SUM_ATOL, f"{name}: probs sum off by {s_dev}")
        extra = f" (max |sum p - 1| {s_dev:.2e}"
    else:
        tol = LOGIT_RTOL * float(y_p.abs().max())
        check(err <= tol, f"{name}: logits differ by {err} > {tol}")
        extra = f" (logits within {err / tol:.3f} of the limit"
    extra += f"; route {route}"
    if reps == 0:
        print(f"  {name} N={N} D={D} H={H} W={W} C={C} K={K} "
              f"{'probs' if probs else 'logits'}: max abs err {err:.3e}"
              f"{extra})", flush=True)
        return dict(max_abs_err=err, kernel_route=route)
    wb = w.to(torch.bfloat16)
    n_vox = N * D * H * W
    # 1x1 products and sums, plus the softmax's ~4 operations per class
    b_ms, b_by = bound(nbytes(x, y_k, m, o, wb),
                       n_vox * (2.0 * C * K + 4.0 * K), PEAK_F32)
    res = dict(max_abs_err=err, kernel_route=route,
               ms=cuda_ms(lambda: qlink.seghead(x, m, o, w, pd), reps),
               host_ms=host_ms(lambda: qlink.seghead(x, m, o, w, pd)),
               plain_ms=cuda_ms(lambda: qlink.seghead_ref(x, m, o, w, pd),
                                reps),
               library_ms=cuda_ms(lambda: F.linear(x, wb), reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} C={C} K={K}", res,
           extra + f"; host {res['host_ms']:.4f} ms per call)")
    return res


def close_max(a, b):
    """max |a - b| over max |b|"""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def block_bwd_case(name, N, D, H, W, part_c, affine, CO, rnd, reps,
                   want=None, groups=None):
    """The block backward kernels (#2 / #4) vs their plain version on random
    bf16 inputs, y from the forward kernel; want: per part whether its
    gradient is wanted (default all); groups: the shift groups (default
    shiftConvPP's)."""
    import torch
    from e2enet_tpu_torch.ops import fused_block as fb
    bf = torch.bfloat16
    parts = [rnd(N, D, H, W, c).to(bf) for c in part_c]
    affines = [rnd.affine(N, c) if a else None
               for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = rnd(CO, scale=0.1)
    y, _ = fb.fused_shift_conv_block(parts, kernel, bias, affines,
                                     groups_override=groups)
    gy = rnd(N, D, H, W, CO, scale=1e-3).to(bf)
    gstats = rnd(N, CO, 2, scale=1e-4)
    args = (parts, kernel, bias, affines, y, gy, gstats, (False,) * 3,
            groups)
    want = [True] * len(parts) if want is None else list(want)
    gp, gk, gb, ga = fb.fused_shift_conv_block_bwd(*args, want=want)
    rp, rk, rb, ra = fb.fused_shift_conv_block_bwd_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for w, g, r in zip(want, gp, rp):
        check((g is None) == (not w), f"{name}: gx wanted {w}, got {g}")
        if g is None:
            continue
        ok, e = y_err(g, r, Y_ULPS)
        check(ok, f"{name}: gx differs by more than {Y_ULPS} bf16 ulps")
        err = max(err, e)
    rel = max([close_max(gk, rk), close_max(gb, rb)]
              + [close_max(g[i], r[i]) for g, r in zip(ga, ra)
                 if g is not None for i in (0, 1)])
    check(rel <= BWD_RTOL, f"{name}: gW/gb/g(affine) rel err {rel}")
    if reps == 0:
        return dict(max_abs_err=err, rel_err=rel)
    # cuDNN's dgrad (where a part is wanted) + wgrad of the bf16 conv on the
    # already shifted, normalised operand, one call
    x2 = torch.cat(parts, -1).reshape(N * D, H, W, C).permute(0, 3, 1, 2)
    w2 = kernel.to(bf)
    g2 = gy.reshape(N * D, H, W, CO).permute(0, 3, 1, 2)

    def library():
        return torch.ops.aten.convolution_backward(
            g2, x2, w2, None, (1, 1), (1, 1), (1, 1), False, (0, 0), 1,
            (any(want), True, False))
    # read parts, y and gy, write the wanted parts' gx, gW and gb; the
    # wgrad GEMM and the wanted parts' dgrad
    c_wanted = sum(c for c, w in zip(part_c, want) if w)
    b_ms, b_by = bound(nbytes(*parts) + nbytes(*[p for p, w in zip(parts, want)
                                                if w]) + nbytes(y, gy)
                       + 9 * C * CO * (2 + 4) + CO * 4,
                       2.0 * N * D * H * W * 9 * CO * (C + c_wanted),
                       PEAK_BF16)
    res = dict(max_abs_err=err, rel_err=rel,
               ms=cuda_ms(lambda: fb.fused_shift_conv_block_bwd(
                   *args, want=want), reps),
               plain_ms=cuda_ms(lambda: fb.fused_shift_conv_block_bwd_ref(
                   *args), max(1, reps // 4)),
               library_ms=cuda_ms(library, reps),
               bound_ms=b_ms, bound_by=b_by)
    report(name, f"N={N} D={D} H={H} W={W} C={list(part_c)} "
           f"affine={list(affine)} CO={CO}", res,
           f" (gW/gb/g(affine) rel {rel:.2e})")
    if name in BWD_FOUR_LAUNCH_MS:
        print(f"    {name}: kernel {res['ms']:.4f} ms against the four-launch "
              f"backward's {BWD_FOUR_LAUNCH_MS[name]} ms (PERF.md), bound "
              f"{b_ms:.4f} ms, cuDNN {res['library_ms']:.4f} ms", flush=True)
    return res


def downlink_bwd_case(name, N, D, H, W, C, rnd, reps, ties=False,
                      window=(2, 2, 2)):
    """The down-link backward kernel (#8) vs its plain version; with reps,
    also the kernel it ran (kernel_route: vec or scalar)."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.ops import qlink
    x = rnd(N, D, H, W, C)
    if ties:
        x = torch.round(2 * x)
    x = x.to(torch.bfloat16)
    m, o = rnd(N, C), rnd(N, C, scale=0.2)
    gy = rnd(N, D // window[0], H // window[1], W // window[2], C).to(
        torch.bfloat16)
    gx, gm, go = qlink.downlink_bwd(x, m, o, gy, window)
    rx, rm, ro = qlink.downlink_bwd_ref(x, m, o, gy, window)
    torch.cuda.synchronize()
    err = float((gx.float() - rx.float()).abs().max())
    check(err == 0.0, f"{name}: gx differs from the plain version by {err}")
    rel = max(close_max(gm, rm), close_max(go, ro))
    check(rel <= 1e-4, f"{name}: g(mult)/g(off) rel err {rel}")
    if reps == 0:
        return dict(max_abs_err=err, rel_err=rel)
    x3 = x.permute(0, 4, 1, 2, 3)
    y3, idx = F.max_pool3d(x3, window, return_indices=True)
    g3 = gy.permute(0, 4, 1, 2, 3)
    # read x and gy, write gx; 8 compares and the routing per input value
    b_ms, b_by = bound(2 * nbytes(x) + nbytes(gy, m, o),
                       4.0 * x.numel(), PEAK_F32)
    res = dict(max_abs_err=err, rel_err=rel,
               ms=cuda_ms(lambda: qlink.downlink_bwd(x, m, o, gy, window),
                          reps),
               plain_ms=cuda_ms(lambda: qlink.downlink_bwd_ref(
                   x, m, o, gy, window), max(1, reps // 4)),
               library_ms=cuda_ms(
                   lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                       g3, x3, list(window), list(window), [0, 0, 0],
                       [1, 1, 1], False, idx), reps),
               bound_ms=b_ms, bound_by=b_by,
               copy_ms=cuda_ms(lambda: x.clone(), reps))
    names = device_kernel_names(lambda: qlink.downlink_bwd(x, m, o, gy,
                                                           window))
    res["kernel_route"] = (
        "vec" if any("downlink_bwd_vec_kernel" in n for n in names) else
        "scalar" if any("downlink_bwd_kernel" in n for n in names) else
        "not seen by the profiler")
    report(name, f"N={N} D={D} H={H} W={W} C={C} window={list(window)}", res,
           f" (route {res['kernel_route']}; a copy of x, the same bytes: "
           f"{res['copy_ms']:.4f} ms)")
    return res


def device_kernel_names(fn):
    """Names of the device kernels fn() launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def loss_grads(net, data, targets, weights, batch_dice=True,
               loss_name="dc_ce", loss_kwargs=None):
    """The gradient of the deep-supervision loss (loss_name with
    loss_kwargs) on (data, targets), every parameter's flattened into one
    float32 vector (zeros where unused)."""
    import torch
    from e2enet_tpu_torch.ops.losses import deep_supervision_loss
    loss = deep_supervision_loss(net(data, do_ds=True), targets, weights,
                                 batch_dice=batch_dice, loss_name=loss_name,
                                 loss_kwargs=loss_kwargs)
    g = torch.autograd.grad(loss, list(net.parameters()), allow_unused=True)
    return torch.cat([(torch.zeros_like(p) if x is None else x).float()
                      .flatten() for x, p in zip(g, net.parameters())])


def train_phase(rnd, R, ops, reset_counts, counts, smi):
    """Phase 7: the backward kernels against their plain versions, the
    forward kernels at batch 2, then the row-masked DSFF trainer at the
    bench width. Returns {"launches": per kernel over the trainer's steps,
    "kernels": result entries of the backward kernels}."""
    import torch
    from e2enet_tpu_torch.models.masks import broadcast_mask
    from e2enet_tpu_torch.models.masks import masked_params, masks_density
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, kernel_launches_per_train_step)
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    out = {}
    print("[kernel] fused_shift_conv_block_bwd (#2 and #4) vs plain, bf16; "
          "'library' is cuDNN's bf16 convolution_backward (dgrad + wgrad) "
          "of the prepared operand", flush=True)
    shapes = [
        # the train step's shapes, batch 2: the level-0 lazy node (pending
        # + materialised u), a level-0 block, the level-1 nest node and
        # block
        ("l0_48+u48_to48", 2, 128, 128, 128, [48, 48], [True, False], 48),
        ("l0_48_to48", 2, 128, 128, 128, [48], [True], 48),
        ("l1_96+96+48_to96", 2, 64, 64, 64, [96, 96, 48],
         [True, False, False], 96),
        ("l1_96_to96", 2, 64, 64, 64, [96], [True], 96),
    ]
    main_bwd = {c[0]: block_bwd_case(*c, rnd=rnd, reps=R) for c in shapes}
    errs = [r["max_abs_err"] for r in main_bwd.values()]
    for c in [("ragged_w13", 2, 5, 6, 13, [8, 5], [True, True], 7),
              ("d2_c1", 2, 2, 8, 16, [1], [False], 48),
              ("d1", 2, 1, 8, 32, [16, 8], [True, False], 24),
              ("co112", 1, 3, 4, 32, [16, 24], [False, True], 112),
              ("context0_c1", 2, 16, 32, 32, [1], [False], 48)]:
        errs.append(block_bwd_case(*c, rnd=rnd, reps=0)["max_abs_err"])
    # the wgrad alone (no part wanted: the first block's image input) and
    # one part of two wanted, at the level-0 lazy node's shape
    for want in ([False, False], [False, True]):
        errs.append(block_bwd_case(
            f"l0_48+u48_to48_want{want}", 2, 128, 128, 128, [48, 48],
            [True, False], 48, rnd=rnd, reps=0, want=want)["max_abs_err"])
    first = main_bwd["l0_48+u48_to48"]
    out["fused_shift_conv_block_bwd"] = dict(
        first, max_abs_err=max(errs),
        shapes={k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}
                for k, v in main_bwd.items()})
    print("[kernel] downlink_bwd (#8) vs plain; 'library' is max_pool3d's "
          "backward", flush=True)
    main8 = downlink_bwd_case("l0_to_l1_48", 2, 128, 128, 128, 48, rnd, R)
    errs = [downlink_bwd_case(n, *a, rnd=rnd, reps=0, ties=t)["max_abs_err"]
            for n, a, t in (("ties", (2, 8, 16, 32, 48), True),
                            ("ties_aligned", (2, 16, 32, 64, 48), True),
                            ("c96", (2, 8, 16, 32, 96), False),
                            ("ragged_d7_w26_c8", (2, 7, 6, 26, 8), True),
                            ("c5_scalar", (1, 4, 4, 6, 5), False))]
    out["downlink_bwd"] = dict(main8, max_abs_err=max(
        [main8["max_abs_err"]] + errs))

    # every forward kernel at its main-path shape with batch 2 (the train
    # step's per-sample statistics, affines and offsets)
    with torch.inference_mode():
        for c in [("l0_48+48_to48_n2", 2, 128, 128, 128, [48, 48],
                   [True, False], 48),
                  ("l1_96+96+48_to96_n2", 2, 64, 64, 64, [96, 96, 48],
                   [True, False, False], 96)]:
            fused_case(*c, rnd=rnd, reps=0)
        lazy_case("l0_lazy_n2", 2, 64, 64, 64, [48], [True], 96, 48, 48,
                  rnd, 0)
        strided_case("l0_to_l1_n2", 2, 128, 128, 128, 48, 96, rnd, 0)
        uplink_case("l1_to_l0_n2", 2, 64, 64, 64, 96, 48, rnd, 0)
        downlink_case("l0_to_l1_n2", 2, 128, 128, 128, 48, rnd, 0)
        seghead_case("l0_logits_n2", 2, 128, 128, 128, 48, 16, False, rnd, 0)
        seghead_case("l1_logits_n2", 2, 64, 64, 64, 96, 16, False, rnd, 0)
    print("[kernel] every forward kernel within tolerance at its main-path "
          "shape with batch 2", flush=True)
    torch.cuda.empty_cache()

    # ---- the trainer
    model, state, step_fn, mask_update, weights = tbm.build("cuda")
    per_step = kernel_launches_per_train_step(model)
    want = {k: per_step["forward"].get(k, 0) + per_step["backward"].get(k, 0)
            for k in ops}
    print(f"[train] ShiftUNet++ bench width, batch 2 x 128^3, row masks "
          f"density {masks_density(state.masks, model):.4f}; kernel launches "
          f"per step {per_step}", flush=True)
    batch = tbm.device_batches(np.random.RandomState(3), 1, 2, PATCH,
                               model.num_ds_outputs(), "cuda")
    params = masked_params(model)
    names = list(params)

    def rows_alive(masks):
        return {n: int(m[:, 0].sum()) for n, m in masks.items()}

    log = dict(losses=[], ms=[], launches={k: 0 for k in ops}, updates=0)
    alive_before = [rows_alive(state.masks)]

    def on_step(i, st, metrics, ms, updated):
        got = counts()
        check(got == want, f"step {i + 1}: launches {got} != {want}")
        for k, v in got.items():
            log["launches"][k] += v
        loss = float(metrics["loss"])
        check(np.isfinite(loss) and np.isfinite(float(
            metrics["grad_norm"])), f"step {i + 1}: loss {loss}")
        for n in names:
            dead = (st.masks[n] == 0).float()
            for t in (st.params[n], st.momentum[n]):
                check(bool((t.detach() * broadcast_mask(dead, t) == 0).all()),
                      f"step {i + 1}: {n} has nonzero dead rows")
        if updated:
            log["updates"] += 1
            now = rows_alive(st.masks)
            check(now == alive_before[0], f"step {i + 1}: the update moved "
                  f"the row counts")
        log["losses"].append(loss)
        log["ms"].append(ms)
        print(f"[train] step {i + 1}: loss {loss:.5f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} {ms:.1f} ms"
              f"{' + DSFF update' if updated else ''}", flush=True)
        reset_counts()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tbm.train(model, state, step_fn, mask_update, batch, TRAIN_STEPS,
              TRAIN_STEPS, TRAIN_UPDATE_EVERY, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, ms = log["losses"], log["ms"][1:]
    check(log["updates"] >= 1, "no DSFF update in the run")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    print(f"[train] {TRAIN_STEPS} steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; {float(np.mean(ms)):.1f} ms per step (steps "
          f"2..{TRAIN_STEPS}, min {min(ms):.1f}, max {max(ms):.1f}); peak "
          f"memory allocated {peak:.2f} GiB; density "
          f"{masks_density(state.masks, model):.4f} after "
          f"{log['updates']} updates  [{smi}]", flush=True)
    for k, n in want.items():
        if n:
            check(log["launches"][k] > 0, f"train: {k} never launched")

    # ---- one step's gradients: kernel path, bf16 plain path, float32
    # plain run, on a 2 x 64^3 batch (float32 autograd through the plain
    # ops at 128^3 would not fit the card)
    data, targets = tbm.device_batches(np.random.RandomState(5), 1, 2,
                                       GRAD_PATCH, model.num_ds_outputs(),
                                       "cuda")[0]

    g_k = loss_grads(model, data, targets, weights)
    with blocks.plain_ops():
        g_p = loss_grads(model, data, targets, weights)
        model32 = ShiftUNetPlusPlus(1, tbm.NUM_CLASSES, tbm.POOLS,
                                    compute_dtype=torch.float32,
                                    device="cuda")
        model32.load_state_dict(model.state_dict())
        g_32 = loss_grads(model32, data, targets, weights)
    del model32
    e_k = float((g_k - g_32).norm() / g_32.norm())
    e_p = float((g_p - g_32).norm() / g_32.norm())
    print(f"[train] one step's gradients on 2 x 64^3, against a float32 "
          f"plain run: kernel path rel L2 err {e_k:.4e}, bf16 plain path "
          f"{e_p:.4e} (cos {float(torch.nn.functional.cosine_similarity(g_k, g_32, dim=0)):.6f} vs "
          f"{float(torch.nn.functional.cosine_similarity(g_p, g_32, dim=0)):.6f})",
          flush=True)
    check(e_k <= ERR_RATIO * e_p, "train: kernel-path gradients further from "
          "the float32 run than the bf16 plain path's")
    reset_counts()
    return {"launches": log["launches"], "kernels": out,
            "ms_per_step": float(np.mean(ms)), "peak_gib": peak}


def exp_result(name, shape, err, kernel, plain, library, b_ms, b_by, reps,
               extra=""):
    """Time kernel, plain and library (None: no such call) and report."""
    res = dict(max_abs_err=err, ms=cuda_ms(kernel, reps),
               plain_ms=cuda_ms(plain, max(1, reps // 4)),
               library_ms=None if library is None else cuda_ms(library, reps),
               bound_ms=b_ms, bound_by=b_by)
    lib = "none" if library is None else f"{res['library_ms']:.4f} ms"
    print(f"  {name} {shape}: max abs err {err:.3e}{extra}  kernel "
          f"{res['ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  bound "
          f"{b_ms:.4f} ms by {b_by} ({100 * b_ms / res['ms']:.1f} % of it)  "
          f"library {lib}", flush=True)
    return res


def ring_case(name, N, D, H, W, C, CO, rnd, reps, route):
    """#11: the ring shift + conv on the route the shape must take (checked
    by the route counter; on the TMA route also its first design, the
    control) and the ring shift alone vs plain; the shift's backward (the
    ring kernel, shifts negated) vs the plain shift with the shifts
    negated. With reps, the times of the route taken, the control, cuDNN's
    conv and #1 on the same input, and the route and the control in
    turns."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.experiments import shift_conv as sc
    from e2enet_tpu_torch.ops import fused_block as fb
    from e2enet_tpu_torch.ops.shift import depth_shift_groups, mirror_groups
    x = rnd(N, D, H, W, C).to(torch.bfloat16)
    k = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = rnd(CO, scale=0.1)
    with torch.inference_mode():
        before = sc.fused_shift_conv.routes[route]
        y_k, s_k = sc.fused_shift_conv(x, k, b), sc.depth_shift_ring(x)
        check(sc.fused_shift_conv.routes[route] == before + 1,
              f"{name}: the ring shift + conv did not take the {route} route "
              f"({sc.fused_shift_conv.routes})")
        y_p, s_p = sc.fused_shift_conv_ref(x, k, b), sc.depth_shift_ring_ref(x)
        y_c = (sc.fused_shift_conv(x, k, b, route="cp_async")
               if route == "tma" else y_k)
    torch.cuda.synchronize()
    ok, err = y_err(y_k, y_p, Y_ULPS)
    check(ok, f"{name}: ring shift + conv ({route}) differs by more than "
              f"{Y_ULPS} bf16 ulps")
    ok, err_c = y_err(y_c, y_p, Y_ULPS)
    check(ok, f"{name}: the ring shift + conv's first design differs by more "
              f"than {Y_ULPS} bf16 ulps")
    err = max(err, err_c)
    check(torch.equal(s_k, s_p), f"{name}: ring shift not equal to the plain "
                                 f"shift")
    xg = x.clone().requires_grad_()
    g = rnd(N, D, H, W, C).to(torch.bfloat16)
    sc.depth_shift_ring(xg).backward(g)
    torch.cuda.synchronize()
    check(torch.equal(xg.grad, depth_shift_groups(
        g, mirror_groups(sc.ring_groups(C, 5)))),
        f"{name}: the ring shift's backward differs from the plain one")
    if reps == 0:
        return dict(max_abs_err=err, kernel_route=route), dict(max_abs_err=0.0)
    s2 = s_p.reshape(N * D, H, W, C).permute(0, 3, 1, 2)
    w2 = k.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    shape = f"N={N} D={D} H={H} W={W} C={C} CO={CO}"
    with torch.inference_mode():
        fused = exp_result(
            "fused_shift_conv", shape, err, lambda: sc.fused_shift_conv(x, k, b),
            lambda: sc.fused_shift_conv_ref(x, k, b),
            lambda: F.conv2d(s2, w2, padding=1),
            *bound(nbytes(x, y_k) + 9 * C * CO * 2,
                   2.0 * N * D * H * W * 9 * C * CO, PEAK_BF16), reps)
        shift = exp_result(
            "depth_shift_ring", f"N={N} D={D} H={H} W={W} C={C}", 0.0,
            lambda: sc.depth_shift_ring(x), lambda: sc.depth_shift_ring_ref(x),
            None, *bound(nbytes(x, s_k), 0.0, PEAK_BF16), reps)
        # the question of the ring: against #1, which restages the operand
        # from device memory for every depth, on the same input; the first
        # design (cp.async staging, mma.sync) as the control; the route
        # taken and the control in turns
        runs = {route: lambda: sc.fused_shift_conv(x, k, b),
                "control": lambda: sc.fused_shift_conv(x, k, b,
                                                       route="cp_async")}
        fused["control_ms"] = cuda_ms(runs["control"], reps)
        fused["kernel1_ms"] = cuda_ms(
            lambda: fb.fused_shift_conv_block([x], k, b, [None]), reps)
        fused["turns_ms"] = {r: [] for r in runs}
        for r in list(runs) + list(runs)[::-1]:
            fused["turns_ms"][r].append(cuda_ms(runs[r], reps))
    fused["kernel_route"] = route
    print(f"  the route taken: {route}; the first design (cp.async, "
          f"mma.sync) {fused['control_ms']:.4f} ms; kernel #1 (restaging) "
          f"on the same input {fused['kernel1_ms']:.4f} ms; in turns "
          f"{fused['turns_ms']}", flush=True)
    return fused, shift


def cf_case(name, N, D, H, W, C, CO, rnd, reps, route):
    """#12: the channels-first block, the affine and the statistics each on
    and off, vs plain, on the route the shape must take (checked by the
    route counter: TMA where tensor maps describe x and y); with reps the
    times without and with both."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.experiments import exp_cf_fused as cf
    from e2enet_tpu_torch.ops.shift import depth_shift
    x = rnd(N, D, C, H * W).to(torch.bfloat16)
    k = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = rnd(CO, scale=0.1)
    m, o = rnd(C, scale=0.3, shift=1.0), rnd(C, scale=0.2)
    err = 0.0
    with torch.inference_mode():
        for aff in (False, True):
            for st in (False, True):
                a = (m, o) if aff else (None, None)
                before = cf.cf_fused_shift_conv.routes[route]
                y_k, s_k = cf.cf_fused_shift_conv(x, k, b, H, W, *a, st)
                check(cf.cf_fused_shift_conv.routes[route] == before + 1,
                      f"{name}: the channels-first block did not take the "
                      f"{route} route ({cf.cf_fused_shift_conv.routes})")
                y_p, s_p = cf.cf_fused_shift_conv_ref(x, k, b, H, W, *a, st)
                torch.cuda.synchronize()
                ok, e = y_err(y_k.transpose(2, 3), y_p.transpose(2, 3),
                              Y_ULPS)
                check(ok, f"{name} affine={aff} stats={st}: y differs by "
                          f"more than {Y_ULPS} bf16 ulps")
                if st:
                    rel = close_max(s_k, s_p)
                    check(rel <= EXP_STATS_RTOL, f"{name} affine={aff}: "
                          f"stats rel err {rel}")
                err = max(err, e)
        if reps == 0:
            return dict(max_abs_err=err, kernel_route=route)
        x_cl = x.reshape(N, D, C, H, W).permute(0, 1, 3, 4, 2).contiguous()
        s2 = depth_shift(x_cl, 5).reshape(N * D, H, W, C).permute(0, 3, 1, 2)
        w2 = k.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        res = exp_result(
            "cf_fused_shift_conv", f"N={N} D={D} H={H} W={W} C={C} CO={CO}",
            err, lambda: cf.cf_fused_shift_conv(x, k, b, H, W),
            lambda: cf.cf_fused_shift_conv_ref(x, k, b, H, W),
            lambda: F.conv2d(s2, w2, padding=1),
            *bound(nbytes(x, y_k) + 9 * C * CO * 2,
                   2.0 * N * D * H * W * 9 * C * CO, PEAK_BF16), reps)
        res["affine_stats_ms"] = cuda_ms(lambda: cf.cf_fused_shift_conv(
            x, k, b, H, W, m, o, True), reps)
    res["kernel_route"] = route
    print(f"  cf_fused_shift_conv ({route} route) with the affine and the "
          f"statistics on: {res['affine_stats_ms']:.4f} ms", flush=True)
    return res


def reshape_case(name, H, W, C, dtype, rnd, reps):
    """#12's relayout probe vs plain (equal to the bit)."""
    import torch
    from e2enet_tpu_torch.experiments import exp_cf_fused as cf
    x = rnd(H, W * C).to(dtype)
    with torch.inference_mode():
        y = cf.reshape_hwc(x, C)
        torch.cuda.synchronize()
        check(torch.equal(y, cf.reshape_hwc_ref(x, C)),
              f"{name}: reshape_hwc not equal to the reshape")
        if reps == 0:
            return dict(max_abs_err=0.0)
        # the plain version is itself one PyTorch call, the copy
        return exp_result(
            "reshape_hwc", f"H={H} W={W} C={C} {dtype}", 0.0,
            lambda: cf.reshape_hwc(x, C), lambda: cf.reshape_hwc_ref(x, C),
            lambda: x.reshape(-1, C).clone(),
            *bound(2 * nbytes(x), 0.0, PEAK_BF16), reps)


def pipe_case(name, N, D, H, W, part_c, affine, CO, rnd, reps):
    """#13 vs plain and vs kernel #1 (y within ORDER_ULPS, and equal to the
    bit: at these shapes both run the same wgmma body on the same K
    chunks), and #13 without its overlap, a ring of one stage (y equal to
    the bit); the ring's depth each took."""
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.experiments import exp_pipeline_fwd as pf
    from e2enet_tpu_torch.ops import fused_block as fb
    parts = [rnd(N, D, H, W, c).to(torch.bfloat16) for c in part_c]
    affines = [rnd.affine(N, c) if a else None
               for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = rnd(CO, scale=0.1)
    args = (parts, kernel, bias, affines)
    with torch.inference_mode():
        y_k, s_k = pf.pipelined_fused_block(*args)
        stages = pf.pipelined_fused_block.stages
        y_p, s_p = pf.pipelined_fused_block_ref(*args)
        y_1, s_1 = fb.fused_shift_conv_block(*args)
        torch.cuda.synchronize()
        ok, err = y_err(y_k, y_p, Y_ULPS)
        check(ok, f"{name}: y differs by more than {Y_ULPS} bf16 ulps")
        srel = stats_err(s_k, s_p, y_p)
        check(srel <= STATS_RTOL, f"{name}: stats rel err {srel}")
        check(y_err(y_k, y_1, ORDER_ULPS)[0], f"{name}: y differs from "
                                              f"kernel #1's by more than "
                                              f"{ORDER_ULPS} ulp")
        check(torch.equal(y_k, y_1), f"{name}: y not equal to kernel #1's")
        check(stages >= 2, f"{name}: a ring of {stages} stages")
        y_s, _ = pf.pipelined_fused_block(*args, overlap=False)
        check(pf.pipelined_fused_block.stages == 1,
              f"{name}: the control's ring is not one stage")
        check(torch.equal(y_s, y_k), f"{name}: y without the overlap not "
                                     f"equal to the pipelined kernel's")
        rel1 = close_max(s_k, s_1)
        check(rel1 <= EXP_STATS_RTOL, f"{name}: stats vs #1 rel err {rel1}")
        if reps == 0:
            return dict(max_abs_err=err, stages=stages)
        x2 = torch.cat(parts, -1).reshape(N * D, H, W, C).permute(0, 3, 1, 2)
        w2 = kernel.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        res = exp_result(
            "pipelined_fused_block", f"N={N} D={D} H={H} W={W} "
            f"C={list(part_c)} affine={list(affine)} CO={CO}", err,
            lambda: pf.pipelined_fused_block(*args),
            lambda: pf.pipelined_fused_block_ref(*args),
            lambda: F.conv2d(x2, w2, padding=1),
            *bound(nbytes(*parts, y_k) + 9 * C * CO * 2,
                   2.0 * N * D * H * W * 9 * C * CO, PEAK_BF16), reps,
            f" (y equal to #1's; stats vs #1 rel {rel1:.2e}; a ring of "
            f"{stages} stages)")
        # #1, the pipelined kernel and the same kernel without the overlap
        # (the experiment's control), in turns on the same inputs
        runs = {"kernel1": lambda: fb.fused_shift_conv_block(*args),
                "pipelined": lambda: pf.pipelined_fused_block(*args),
                "serial": lambda: pf.pipelined_fused_block(*args,
                                                           overlap=False)}
        turns = {k: [] for k in runs}
        for k in ("kernel1", "pipelined", "serial", "serial", "pipelined",
                  "kernel1"):
            turns[k].append(cuda_ms(runs[k], reps))
    res["kernel1_ms"] = sum(turns["kernel1"]) / 2
    res["serial_ms"] = sum(turns["serial"]) / 2
    res["turns_ms"] = turns
    res["stages"] = stages
    print(f"  in turns (#1, pipelined, serial, serial, pipelined, #1): "
          f"{turns}; serial / pipelined "
          f"{res['serial_ms'] / (sum(turns['pipelined']) / 2):.3f}x, #1 / "
          f"pipelined {res['kernel1_ms'] / (sum(turns['pipelined']) / 2):.3f}"
          f"x", flush=True)
    return res


def gemm_route(M, N, K, dtype):
    """The route #14 takes by shape for contiguous, aligned operands: wgmma
    fed by TMA where TMA describes them, else mma.sync."""
    import torch
    if dtype == torch.int8:
        return "wgmma" if K % 16 == 0 else "mma_sync"
    return "wgmma" if K % 8 == 0 and N % 8 == 0 else "mma_sync"


def gemm_case(name, M, N, K, dtype, rnd, reps):
    """#14 vs plain on the route its shape takes (checked by the route
    counters) and its mma.sync control: int8 equal to the bit, bf16 within
    GEMM_RTOL. With reps, also the control's time (mma_ms) and, for int8 on
    the wgmma route, the repack of B alone (repack_ms)."""
    import torch
    from e2enet_tpu_torch.experiments import exp_int8_mma as im
    from e2enet_tpu_torch.ops import _native
    if dtype == torch.int8:
        a = torch.randint(-128, 128, (M, K), generator=rnd.gen,
                          device="cuda", dtype=dtype)
        b = torch.randint(-128, 128, (K, N), generator=rnd.gen,
                          device="cuda", dtype=dtype)
    else:
        a, b = rnd(M, K).to(dtype), rnd(K, N).to(dtype)
    route = gemm_route(M, N, K, dtype)
    with torch.inference_mode():
        before = dict(im.mma_gemm.routes)
        c = im.mma_gemm(a, b)
        check(im.mma_gemm.routes[route] == before[route] + 1,
              f"{name}: {dtype} product did not take the {route} route "
              f"({before} -> {im.mma_gemm.routes})")
        c_ctl = im.mma_gemm(a, b, wgmma=False)
        ref = im.mma_gemm_ref(a, b)
        torch.cuda.synchronize()
        err = 0.0
        for tag, out in ((route, c), ("mma_sync control", c_ctl)):
            e = float((out.double() - ref.double()).abs().max())
            if dtype == torch.int8:
                check(torch.equal(out, ref), f"{name} ({tag}): int8 product "
                                             f"not exact (max abs err {e})")
            else:
                rel = close_max(out, ref)
                check(rel <= GEMM_RTOL, f"{name} ({tag}): bf16 product rel "
                                        f"err {rel}")
            err = max(err, e)
        if reps == 0:
            return dict(max_abs_err=err)
        lib = ((lambda: torch._int_mm(a, b)) if dtype == torch.int8
               else (lambda: torch.matmul(a, b)))
        res = exp_result(
            "mma_gemm", f"M={M} N={N} K={K} {dtype} ({route})", err,
            lambda: im.mma_gemm(a, b), lambda: im.mma_gemm_ref(a, b), lib,
            *bound(nbytes(a, b, c), 2.0 * M * N * K,
                   PEAK_INT8 if dtype == torch.int8 else PEAK_BF16), reps)
        res["gemm_route"] = route
        res["mma_ms"] = cuda_ms(lambda: im.mma_gemm(a, b, wgmma=False), reps)
        extra = ""
        if dtype == torch.int8 and route == "wgmma":
            bt = torch.empty((N, K), dtype=dtype, device="cuda")
            res["repack_ms"] = cuda_ms(
                lambda: _native.launch_mma_gemm_repack(b, bt), reps)
            extra = f"; the repack of B alone {res['repack_ms']:.4f} ms"
        print(f"    the mma.sync control {res['mma_ms']:.4f} ms{extra}",
              flush=True)
        return res


def experiments_phase(rnd, R, reset_counts, counts, smi):
    """Phase 8: the experiment kernels against their plain versions, then
    each experiment's main once. Returns {"launches": per kernel over the
    mains, "kernels": result entries}."""
    import torch
    from e2enet_tpu_torch.experiments import (exp_cf_fused, exp_int8_mma,
                                              exp_pipeline_fwd, shift_conv)
    out = {}
    print(f"[experiments] the experiment kernels (#11-#14) vs their plain "
          f"versions  [{smi}]", flush=True)
    print("[kernel] fused_shift_conv / depth_shift_ring (#11) vs plain, on "
          "the route each shape takes (TMA at the main shape) and the first "
          "design; 'library' is cuDNN's bf16 conv of the pre-shifted "
          "operand; the shift has no library call", flush=True)
    fused, shift = ring_case("l0_48_to48", 1, 128, 128, 128, 48, 48, rnd, R,
                             "tma")
    # the first design where the rule refuses the TMA route (C = 1, groups
    # of 5 at C = 24, CO = 56); the TMA route at D = 1 and 2, H and W off
    # its 8 x 16 tile, C = 8 and 40 (K rows past C), CO = 24
    errs = [ring_case(f"ragged_{c}_{co}_d{d}", n, d, h, w, c, co, rnd, 0,
                      route)[0]["max_abs_err"]
            for n, d, h, w, c, co, route in (
                (2, 3, 6, 13, 1, 8, "cp_async"), (2, 3, 6, 13, 8, 8, "tma"),
                (2, 3, 6, 13, 24, 40, "cp_async"),
                (1, 3, 6, 13, 48, 56, "cp_async"),
                (2, 1, 9, 20, 48, 48, "tma"), (1, 2, 13, 37, 40, 24, "tma"))]
    out["fused_shift_conv"] = dict(fused, max_abs_err=max(
        [fused["max_abs_err"]] + errs))
    out["depth_shift_ring"] = shift
    print("[kernel] cf_fused_shift_conv (#12) vs plain, affine and stats "
          "each on and off, on the route each shape takes (TMA at the main "
          "shape); 'library' is cuDNN's bf16 conv of the pre-shifted "
          "channels-last operand", flush=True)
    main12 = cf_case("l0_48_to48", 1, 128, 128, 128, 48, 48, rnd, R, "tma")
    errs = [cf_case(f"ragged_{c}", 2, 3, 6, 13, c, co, rnd, 0, "ldg")[
        "max_abs_err"] for c, co in ((1, 8), (8, 8), (24, 40))]
    # the TMA route at ragged tiles: two column tiles of 64, the last of
    # 8; rows not a multiple of the tile's; N = 2; C = 1 and 24
    errs += [cf_case(f"tma_{c}", 2, 3, 7, 72, c, co, rnd, 0, "tma")[
        "max_abs_err"] for c, co in ((1, 8), (24, 40), (48, 48))]
    out["cf_fused_shift_conv"] = dict(main12, max_abs_err=max(
        [main12["max_abs_err"]] + errs))
    print("[kernel] reshape_hwc (#12, E1) vs plain; 'library' is the copy "
          "x.reshape(-1, C).clone()", flush=True)
    reshape_case("e1_probe", 8, 16, 48, torch.float32, rnd, 0)
    reshape_case("ragged", 5, 13, 3, torch.bfloat16, rnd, 0)
    out["reshape_hwc"] = reshape_case("l0_volume", 128 * 128, 128, 48,
                                      torch.bfloat16, rnd, R)
    print("[kernel] pipelined_fused_block (#13) vs plain and vs kernel #1; "
          "'library' is cuDNN's bf16 conv of the prepared operand", flush=True)
    main13 = pipe_case("l0_48+48_to48", 1, 128, 128, 128, [48, 48],
                       [True, True], 48, rnd, R)
    errs = [pipe_case(*c, rnd=rnd, reps=0)["max_abs_err"] for c in (
        ("ragged_w13_c8+24", 2, 3, 6, 13, [8, 24], [True, False], 16),
        ("d3_c1", 2, 3, 8, 16, [1], [False], 48),
        ("c24_co112", 2, 3, 4, 32, [24], [True], 112))]
    out["pipelined_fused_block"] = dict(main13, max_abs_err=max(
        [main13["max_abs_err"]] + errs))
    print("[kernel] mma_gemm (#14) vs plain, on the route its shape takes "
          "and on the mma.sync control; 'library' is torch.matmul (bf16) / "
          "torch._int_mm (int8); the int8 wgmma route's time includes the "
          "repack of B", flush=True)
    r14 = {dt: gemm_case("4096^3", 4096, 4096, 4096, dt, rnd, R)
           for dt in (torch.bfloat16, torch.int8)}
    for dt in (torch.bfloat16, torch.int8):
        check(r14[dt]["gemm_route"] == "wgmma", f"4096^3 {dt}: not on "
                                                 f"the wgmma route")
        errs = [gemm_case(f"ragged_{m}x{n}x{k}", m, n, k, dt, rnd, 0)[
            "max_abs_err"] for m, n, k in ((200, 136, 272), (33, 50, 100),
                                           (1000, 999, 77), (512, 1024, 768),
                                           (300, 264, 208))]
        r14[dt]["max_abs_err"] = max([r14[dt]["max_abs_err"]] + errs)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "gemm_route", "mma_ms", "repack_ms")
    out["mma_gemm"] = dict(r14[torch.bfloat16],
                           int8={k: r14[torch.int8][k] for k in keys
                                 if k in r14[torch.int8]})
    torch.cuda.empty_cache()

    # ---- the experiments' entry points, few repetitions each
    print("[experiments] each experiment's main, --reps 2", flush=True)
    reset_counts()
    routes = exp_int8_mma.mma_gemm.routes
    routes.update(wgmma=0, mma_sync=0)
    shift_conv.main(["--reps", "2"])
    exp_cf_fused.main(["--reps", "2"])
    exp_cf_fused.main(["--v2", "--reps", "2"])
    exp_pipeline_fwd.main(["--reps", "2"])
    exp_int8_mma.main(["--reps", "2"])
    got = counts()
    reset_counts()
    for name in out:
        check(got[name] > 0, f"experiments: {name} never launched by the "
                             f"mains")
    check(routes == {"wgmma": got["mma_gemm"], "mma_sync": 0},
          f"experiments: the 4096^3 products left the wgmma route {routes}")
    print(f"[experiments] launches over the mains "
          f"{ {k: got[k] for k in out} }", flush=True)
    torch.cuda.empty_cache()
    return {"launches": got, "kernels": out}


HOST_READINGS = 21


# the [predict] phase: a model folder at the bench geometry, two cases
PRED_TASK = "Task500_ChipSmoke"
PRED_INTENSITY = {0: {"mean": 40.0, "sd": 120.0, "percentile_00_5": -500.0,
                      "percentile_99_5": 600.0}}
# (z, y, x) arrays and ITK (x, y, z) spacings: case 0 is the bench's volume
# at the plan's spacing (no resampling); case 1 resamples to (128, 115,
# 192), under a patch on y, so padding and both resamplings run
PRED_CASES = {"case_000": ((192, 192, 192), (1.0, 1.0, 1.0)),
              "case_001": ((160, 144, 96), (2.0, 0.8, 0.8))}
PRED_GEOM = dict(origin=(-120.5, 33.0, 410.25),
                 direction=(1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 1.0))
PRED_DEVICE = "cuda"


def predict_plans(base_num_features):
    """The bench plan of one CT modality at 1 mm: one stage of 128^3
    patches, batch 2, five (2, 2, 2) pools, 16 classes."""
    from e2enet_tpu_torch.plans import Plans, StagePlan
    stage = StagePlan(
        batch_size=2, num_pool_per_axis=[5, 5, 5], patch_size=list(PATCH),
        median_patient_size_in_voxels=list(VOLUME),
        current_spacing=[1.0, 1.0, 1.0], original_spacing=[1.0, 1.0, 1.0],
        do_dummy_2D_data_aug=False, pool_op_kernel_sizes=[[2, 2, 2]] * 5,
        conv_kernel_sizes=[[1, 3, 3]] * 6)
    return Plans(
        num_stages=1, num_modalities=1, modalities={0: "CT"},
        normalization_schemes={0: "CT"}, dataset_properties={},
        list_of_npz_files=[], original_spacings=[[1.0, 1.0, 1.0]],
        original_sizes=[list(VOLUME)], preprocessed_data_folder=None,
        num_classes=NUM_CLASSES - 1, all_classes=list(range(1, NUM_CLASSES)),
        base_num_features=base_num_features, use_mask_for_norm={0: False},
        keep_only_largest_region=None, min_region_size_per_class=None,
        min_size_per_class=None, transpose_forward=[0, 1, 2],
        transpose_backward=[0, 1, 2], data_identifier="nnUNetData_plans_v2.1",
        plans_per_stage={0: stage}, intensity_properties=PRED_INTENSITY)


def write_predict_inputs(base, model, cases=None):
    """The model folder (predict_plans, fold 0 written by the port's
    save_checkpoint from `model`'s weights and the trained masks) and the
    input folder of `cases` (default PRED_CASES); returns (results dir,
    input dir, model folder)."""
    import os
    from e2enet_tpu_torch.io.nifti import NiftiImage, write_nifti
    from e2enet_tpu_torch.models import masks as masks_mod
    from e2enet_tpu_torch.models.weights import to_jax_params
    from e2enet_tpu_torch.training.checkpoint import save_checkpoint
    plans = predict_plans(model.enc[0])
    results = os.path.join(base, "results")
    folder = os.path.join(results, "nnUNet", "3d_fullres", PRED_TASK,
                          "TPUTrainer__nnUNetPlansv2.1")
    os.makedirs(os.path.join(folder, "fold_0"))
    with np.load(masks_mod.BENCH_MASKS) as z:
        masks = {k: z[k] for k in z.files}
    save_checkpoint(
        os.path.join(folder, "fold_0",
                     "shiftConvPP_model_final_checkpoint.model"),
        to_jax_params(model.state_dict()), 1000, masks=masks,
        sidecar={"init": {"fold": 0, "stage": 0, "tconv": "shiftConvPP",
                          "base_num_features": model.enc[0],
                          "cascade": False},
                 "name": "TPUTrainer", "class": "TPUTrainer",
                 "plans": plans.to_dict()})
    inputs = os.path.join(base, "input")
    os.makedirs(inputs)
    for i, (name, (shape, spacing)) in enumerate(
            (cases or PRED_CASES).items()):
        rng = np.random.RandomState(10 + i)
        vol = 40.0 + 120.0 * rng.randn(*shape).astype(np.float32)
        write_nifti(os.path.join(inputs, f"{name}_0000.nii.gz"),
                    NiftiImage(vol, spacing, **PRED_GEOM))
    return results, inputs, folder


# the [trainer] phase: a raw task that the port's plan CLI plans at the
# bench geometry (write_train_task, the preprocessed task the CPU tests
# train on, keeps the same cases)
TRAIN_TASK = "Task501_ChipSmokeTrain"
TRAIN_CASES = {"case_000": (160, 160, 160), "case_001": (168, 152, 160),
               "case_002": (152, 160, 168), "case_003": (160, 168, 152),
               "case_004": (160, 160, 160), "case_005": (164, 156, 160)}
TRAIN_VAL = ("case_004", "case_005")
# identity CT normalisation: the raw intensities are the preprocessed data
TRAIN_INTENSITY = {0: {"mean": 0.0, "sd": 1.0, "percentile_00_5": -1e4,
                       "percentile_99_5": 1e4}}


def synthetic_case(rng, shape, num_classes):
    """A noisy body and one random ellipsoid per foreground class at a
    class-specific intensity (as training/train_bench_masks.make_batch
    draws them). Returns (volume (z, y, x) float32, labels uint8)."""
    D, H, W = shape
    vol = rng.randn(D, H, W).astype(np.float32) * 0.3
    seg = np.zeros(shape, np.uint8)
    zz, yy, xx = np.ogrid[:D, :H, :W]
    for cls in range(1, num_classes):
        c = rng.rand(3) * np.array(shape)
        r = 4 + rng.rand(3) * np.array(shape) * 0.12
        m = (((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
             + ((xx - c[2]) / r[2]) ** 2) < 1
        vol[m] = (0.15 * cls - 1.2
                  + 0.4 * rng.randn(int(m.sum())).astype(np.float32))
        seg[m] = cls
    return vol, seg


def write_train_task(base, task, cases, patch, pools, num_classes,
                     batch_size=2, val=None, seed=0):
    """A preprocessed task in the JAX package's on-disk format, from numpy
    and the port's plans.py: under `base`, preprocessed/<task>/ with a
    one-stage plans file (one CT modality, identity normalisation, 1 mm,
    `patch`, `pools`), the stage folder (<case>.npz, data and labels
    stacked, and <case>.pkl, the preprocessor's properties with class
    locations), gt_segmentations/<case>.nii.gz and, when `val` names the
    validation cases, splits_final.pkl with fold 0 (otherwise the trainer
    makes the seeded 5-fold split); raw/<case>_0000.nii.gz, the input a
    predictor reads; results/. cases: {name: (z, y, x) shape}. Returns
    {"preprocessed", "results", "raw", "task"} paths."""
    import os
    import pickle
    from e2enet_tpu_torch.io.nifti import NiftiImage, write_nifti
    from e2enet_tpu_torch.plans import Plans, StagePlan
    rng = np.random.RandomState(seed)
    pre = os.path.join(base, "preprocessed", task)
    stage_dir = os.path.join(pre, "nnUNetData_plans_v2.1_stage0")
    gt = os.path.join(pre, "gt_segmentations")
    raw = os.path.join(base, "raw")
    results = os.path.join(base, "results")
    for d in (stage_dir, gt, raw, results):
        os.makedirs(d, exist_ok=True)
    n_pool = len(pools)
    median = [int(np.median([s[i] for s in cases.values()]))
              for i in range(3)]
    stage = StagePlan(
        batch_size=batch_size, num_pool_per_axis=[n_pool] * 3,
        patch_size=list(patch), median_patient_size_in_voxels=median,
        current_spacing=[1.0, 1.0, 1.0], original_spacing=[1.0, 1.0, 1.0],
        do_dummy_2D_data_aug=False,
        pool_op_kernel_sizes=[list(p) for p in pools],
        conv_kernel_sizes=[[1, 3, 3]] * (n_pool + 1))
    plans = Plans(
        num_stages=1, num_modalities=1, modalities={0: "CT"},
        normalization_schemes={0: "CT"}, dataset_properties={},
        list_of_npz_files=[], original_spacings=[[1.0, 1.0, 1.0]] * len(
            cases), original_sizes=[list(s) for s in cases.values()],
        preprocessed_data_folder=pre, num_classes=num_classes - 1,
        all_classes=list(range(1, num_classes)), base_num_features=48,
        use_mask_for_norm={0: False}, keep_only_largest_region=None,
        min_region_size_per_class=None, min_size_per_class=None,
        transpose_forward=[0, 1, 2], transpose_backward=[0, 1, 2],
        data_identifier="nnUNetData_plans_v2.1", plans_per_stage={0: stage},
        intensity_properties=TRAIN_INTENSITY)
    plans.save(os.path.join(pre, "nnUNetPlansv2.1_plans_3D.json"))
    geom = dict(origin=(0.0, 0.0, 0.0),
                direction=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0))
    for name, shape in cases.items():
        vol, seg = synthetic_case(rng, shape, num_classes)
        np.savez(os.path.join(stage_dir, f"{name}.npz"),
                 data=np.stack([vol, seg.astype(np.float32)]))
        locs_rng = np.random.RandomState(1234)
        locs = {}
        for c in range(1, num_classes):
            where = np.argwhere(seg == c)
            n = min(10000, len(where))
            locs[c] = (where[locs_rng.choice(len(where), n, replace=False)]
                       if n else [])
        raw_file = os.path.join(raw, f"{name}_0000.nii.gz")
        props = {
            "original_size_of_raw_data": np.array(shape),
            "original_spacing": np.array([1.0, 1.0, 1.0]),
            "list_of_data_files": [raw_file], "seg_file": None,
            "itk_origin": geom["origin"], "itk_spacing": (1.0, 1.0, 1.0),
            "itk_direction": geom["direction"],
            "crop_bbox": [[0, s] for s in shape],
            "classes": np.unique(seg).astype(np.float32),
            "size_after_cropping": tuple(shape),
            "size_after_resampling": tuple(shape),
            "spacing_after_resampling": np.array([1.0, 1.0, 1.0]),
            "class_locations": locs}
        with open(os.path.join(stage_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(props, f)
        write_nifti(raw_file, NiftiImage(vol, (1.0, 1.0, 1.0), **geom))
        write_nifti(os.path.join(gt, f"{name}.nii.gz"),
                    NiftiImage(seg, (1.0, 1.0, 1.0), **geom))
    if val is not None:
        write_split(pre, cases, val)
    return {"preprocessed": os.path.join(base, "preprocessed"),
            "results": results, "raw": raw, "task": pre}


def write_split(pre, cases, val):
    """splits_final.pkl in the preprocessed task folder `pre`: fold 0
    validates on the cases named in `val` and trains on the rest."""
    import os
    import pickle
    from collections import OrderedDict
    keys = np.sort(list(cases))
    split = OrderedDict(train=keys[~np.isin(keys, val)],
                        val=keys[np.isin(keys, val)])
    with open(os.path.join(pre, "splits_final.pkl"), "wb") as f:
        pickle.dump([split], f)


def write_raw_task(base, task, cases, num_classes, seed=0,
                   modalities=("CT",)):
    """A raw task in the layout the plan CLI reads, the same seeded
    synthetic_case volumes write_train_task draws: under `base`,
    nnUNet_raw_data/<task>/ with imagesTr/<case>_<m:04d>.nii.gz (one file
    per modality, 1 mm), labelsTr/<case>.nii.gz and dataset.json (the
    port's generate_dataset_json; labels 0 to num_classes - 1). cases:
    {name: (z, y, x) shape}. The first modality is synthetic_case's
    volume; each further one (e.g. the four MR modalities of a BraTS-like
    task: modalities=("t1", "t1ce", "t2", "flair")) the same labels
    through its own seeded intensity per label, offset and noise, drawn
    after the case, so that a one-modality task is unchanged. Returns the
    task folder."""
    import os
    from e2enet_tpu_torch.dataset_conversion.utils import \
        generate_dataset_json
    from e2enet_tpu_torch.io.nifti import NiftiImage, write_nifti
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.RandomState(seed)
    folder = os.path.join(base, "nnUNet_raw_data", task)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    # the volumes drawn in order, then written on threads (gzip's deflate
    # releases the GIL)
    files = []
    for name, shape in cases.items():
        vol, seg = synthetic_case(rng, shape, num_classes)
        vols = [vol]
        for _ in modalities[1:]:
            level = rng.randn(num_classes).astype(np.float32)
            vols.append(level[seg] + 0.5 * vol
                        + 0.3 * rng.randn(*shape).astype(np.float32))
        files += [(os.path.join(folder, "imagesTr", f"{name}_{m:04d}.nii.gz"),
                   v) for m, v in enumerate(vols)]
        files.append((os.path.join(folder, "labelsTr", f"{name}.nii.gz"),
                      seg))
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(write_nifti, path, NiftiImage(a, (1.0,) * 3))
                  for path, a in files]:
            f.result()
    generate_dataset_json(
        os.path.join(folder, "dataset.json"),
        os.path.join(folder, "imagesTr"), None, tuple(modalities),
        {c: "background" if c == 0 else f"class_{c}"
         for c in range(num_classes)}, task.split("_", 1)[1])
    return folder


# the plan CLI's steps that plan_child times: (name, module, class or None
# for a function, attribute)
PLAN_STEPS = (
    ("integrity", "e2enet_tpu_torch.planning.sanity", None,
     "verify_dataset_integrity"),
    ("cropping", "e2enet_tpu_torch.preprocessing.cropping", "ImageCropper",
     "run_cropping"),
    ("analysis", "e2enet_tpu_torch.planning.analyzer", "DatasetAnalyzer",
     "analyze_dataset"),
    ("planning", "e2enet_tpu_torch.planning.planner",
     "ExperimentPlanner3D_v21", "plan_experiment"),
    ("preprocessing", "e2enet_tpu_torch.planning.planner",
     "ExperimentPlanner3D_v21", "run_preprocessing"))


def plan_child(argv, out):
    """The plan CLI's main(argv) with a spy on each of PLAN_STEPS; writes
    {step: seconds, "main": seconds} to `out` as JSON. Run in a spawned
    process (it takes the environment's data folders)."""
    import importlib
    seconds = {}
    for step, module, cls, attr in PLAN_STEPS:
        owner = importlib.import_module(module)
        owner = owner if cls is None else getattr(owner, cls)
        real = getattr(owner, attr)

        def spy(*a, _real=real, _step=step, **k):
            t0 = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                seconds[_step] = (seconds.get(_step, 0.0)
                                  + time.perf_counter() - t0)
        setattr(owner, attr, spy)
    from e2enet_tpu_torch.cli import plan_and_preprocess
    t0 = time.perf_counter()
    plan_and_preprocess.main(argv)
    seconds["main"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(seconds, f)



def plan_train_task(base, smi):
    """[trainer]'s task: TRAIN_CASES written as a raw task (write_raw_task
    under `base`/raw), then planned and preprocessed by the port's CLI
    twice, each in a fresh process: `python -m
    e2enet_tpu_torch.cli.plan_and_preprocess -t 501
    --verify_dataset_integrity` (its exit code and wall seconds; the task
    the phase trains on), then plan_child in a spawned process into
    folders of its own (the seconds of each step). Checks that both runs
    wrote the same plans and stage files, and that the plan is the one the
    phase trains: one stage, PATCH, 5 x (2, 2, 2) pools, batch 2, one CT
    modality normalised by the analyser's statistics. Writes
    splits_final.pkl (TRAIN_VAL as fold 0). Returns {"preprocessed",
    "results", "images", "raw"} paths."""
    import multiprocessing
    import os
    import shutil
    from pathlib import Path
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.utils.files import load_pickle
    t0 = time.perf_counter()
    task_dir = write_raw_task(os.path.join(base, "raw"), TRAIN_TASK,
                              TRAIN_CASES, NUM_CLASSES)
    written = time.perf_counter() - t0
    argv = ["-t", str(int(TRAIN_TASK[4:7])), "--verify_dataset_integrity"]
    env = dict(os.environ, nnUNet_raw_data_base=os.path.join(base, "raw"),
               nnUNet_preprocessed=os.path.join(base, "preprocessed"))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "e2enet_tpu_torch.cli.plan_and_preprocess"]
        + argv, cwd=Path(__file__).resolve().parent, env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"[trainer] the plan CLI exited "
          f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")

    # the same CLI's main in a spawned child with spies on its steps, into
    # folders of its own (the raw task linked in)
    timed = os.path.join(base, "timed")
    os.makedirs(os.path.join(timed, "raw", "nnUNet_raw_data"))
    os.symlink(task_dir, os.path.join(timed, "raw", "nnUNet_raw_data",
                                      TRAIN_TASK))
    out = os.path.join(timed, "seconds.json")
    saved = {k: os.environ.get(k) for k in ("nnUNet_raw_data_base",
                                            "nnUNet_preprocessed")}
    os.environ.update(nnUNet_raw_data_base=os.path.join(timed, "raw"),
                      nnUNet_preprocessed=os.path.join(timed,
                                                       "preprocessed"))
    try:
        child = multiprocessing.get_context("spawn").Process(
            target=plan_child, args=(argv, out))
        child.start()
        child.join(900)
        if child.is_alive():
            child.kill()
            child.join()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(child.exitcode == 0, f"[trainer] the timed plan run exited "
          f"{child.exitcode}")
    with open(out) as f:
        seconds = json.load(f)

    pre = os.path.join(base, "preprocessed", TRAIN_TASK)
    pre_t = os.path.join(timed, "preprocessed", TRAIN_TASK)
    name = "nnUNetPlansv2.1_plans_3D.json"
    with open(os.path.join(pre, name)) as f, \
            open(os.path.join(pre_t, name)) as g:
        check(f.read().replace(base, "<base>")
              == g.read().replace(timed, "<base>"),
              "[trainer] the two plan runs wrote different plans")
    stage = "nnUNetData_plans_v2.1_stage0"
    for case in TRAIN_CASES:
        a, b = (np.load(os.path.join(d, stage, f"{case}.npz"))["data"]
                for d in (pre, pre_t))
        la, lb = (load_pickle(os.path.join(d, stage, f"{case}.pkl"))[
            "class_locations"] for d in (pre, pre_t))
        check(a.dtype == b.dtype and np.array_equal(a, b) and list(la)
              == list(lb) and all(np.array_equal(la[c], lb[c]) for c in la),
              f"[trainer] the two plan runs wrote different stage files "
              f"for {case}")
    shutil.rmtree(timed)

    plans = Plans.load(os.path.join(pre, name))
    st = plans.plans_per_stage[0]
    got = dict(stages=plans.num_stages, patch=st.patch_size,
               pools=st.pool_op_kernel_sizes, batch=st.batch_size,
               schemes=plans.normalization_schemes,
               mask=plans.use_mask_for_norm)
    want = dict(stages=1, patch=list(PATCH), pools=[[2, 2, 2]] * 5,
                batch=2, schemes={0: "CT"}, mask={0: False})
    check(got == want, f"[trainer] the port's plan CLI planned {got}, not "
          f"the plan this phase trains, {want}: the cropped cases' medians "
          f"changed the plan")
    stats = load_pickle(os.path.join(base, "raw", "nnUNet_cropped_data",
                                     TRAIN_TASK, "intensityproperties.pkl"))[0]
    keys = ("mean", "sd", "percentile_00_5", "percentile_99_5")
    norm = {k: plans.intensity_properties[0][k] for k in keys}
    check(norm == {k: float(stats[k]) for k in keys} and norm["sd"] > 0
          and norm["percentile_00_5"] < norm["percentile_99_5"],
          f"[trainer] the plan's CT normalisation {norm} is not the "
          f"analyser's")
    write_split(pre, TRAIN_CASES, TRAIN_VAL)
    os.makedirs(os.path.join(base, "results"))
    steps = ", ".join(f"{k} {seconds[k]:.2f}" for k, *_ in PLAN_STEPS)
    print(f"[trainer] raw task {TRAIN_TASK}: {len(TRAIN_CASES)} cases "
          f"{sorted(set(TRAIN_CASES.values()))} written in {written:.1f} s; "
          f"python -m e2enet_tpu_torch.cli.plan_and_preprocess "
          f"{' '.join(argv)}: exit 0, {wall:.2f} s wall; its main in a "
          f"spawned child (s): {steps}, main {seconds['main']:.2f}; the two "
          f"runs' plans and stage files equal; plan: {got}, CT "
          f"normalisation {norm}  [{smi}]", flush=True)
    return {"preprocessed": os.path.join(base, "preprocessed"),
            "results": os.path.join(base, "results"),
            "images": os.path.join(task_dir, "imagesTr"),
            "raw": os.path.join(base, "raw")}

def predict_phase(make_model, reset_counts, counts, smi):
    """[predict] the users' entry point, cli/predict.main, twice on the
    same model folder and input folder: (A) --all_in_gpu True -z (the fast
    mode on the sparse plan) and (B) the exact mode with --mode fastest.
    Per case: the output's geometry and labels, the kernel launches of its
    predict_case (reset just before, read just after) against tiles x
    passes x kernel_launches_per_forward, and the seconds in preprocessing
    (the background thread), in predict_case inside the folder run, in
    predict_case alone on the same data, and in export. In run A, case 1's
    npz probabilities against predict_case's through the plain path and a
    float32 plain run, exported alike (the rule of the patch checks).
    Returns the launches over run A."""
    import copy
    import functools
    import os
    import tempfile
    import torch
    from e2enet_tpu_torch.cli import predict as cli
    from e2enet_tpu_torch.inference import predictor
    from e2enet_tpu_torch.inference.export import \
        save_segmentation_nifti_from_softmax
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_forward
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, pad_volume_to_patch)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_predict_")
    base = tmp.name
    model = make_model()
    per_fwd = kernel_launches_per_forward(model)
    results, inputs, folder = write_predict_inputs(base, model)
    del model
    os.environ["RESULTS_FOLDER"] = results
    print(f"[predict] model folder {folder}: fold_0 written by the port's "
          f"save_checkpoint (bench width, seed 0, trained masks); cases "
          f"{ {k: v for k, v in PRED_CASES.items()} } ((z, y, x), spacing "
          f"(x, y, z) mm)", flush=True)

    real_case, real_pff = predictor.predict_case, cli.predict_from_folder
    per_case = []

    def spy(bundle, data, *a, **k):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_case(bundle, data, *a, **k)
        torch.cuda.synchronize()
        padded, _ = pad_volume_to_patch(data, bundle.patch_size)
        steps = compute_steps_for_sliding_window(
            bundle.patch_size, padded.shape[1:], 0.5)
        per_case.append({"launches": counts(),
                         "tiles": int(np.prod([len(s) for s in steps])),
                         "passes": TTA if k.get("do_tta", True) else 1,
                         "shape": tuple(data.shape[1:]),
                         "s": time.perf_counter() - t0})
        return out

    def run(tag, args):
        per_case.clear()
        timings = []
        predictor.predict_case = spy
        cli.predict_from_folder = functools.partial(real_pff,
                                                    timings=timings)
        try:
            out = os.path.join(base, f"out_{tag}")
            t0 = time.perf_counter()
            cli.main(["-i", inputs, "-o", out, "-t", PRED_TASK] + args)
            wall = time.perf_counter() - t0
        finally:
            predictor.predict_case = real_case
            cli.predict_from_folder = real_pff
        check(len(per_case) == len(timings) == len(PRED_CASES),
              f"[predict {tag}] {len(per_case)} cases predicted")
        total = {}
        for (name, (shape, spacing)), c, t in zip(PRED_CASES.items(),
                                                  per_case, timings):
            img = read_nifti(os.path.join(out, f"{name}.nii.gz"))
            check(img.array.shape == shape, f"[predict {tag}] {name}: "
                  f"shape {img.array.shape}")
            check(np.allclose(img.spacing, spacing)
                  and np.allclose(img.origin, PRED_GEOM["origin"])
                  and np.allclose(img.direction, PRED_GEOM["direction"]),
                  f"[predict {tag}] {name}: geometry {img.geometry}")
            labels = np.unique(img.array)
            check(int(labels.min()) >= 0
                  and int(labels.max()) < NUM_CLASSES,
                  f"[predict {tag}] {name}: labels {labels}")
            want = {n: c["tiles"] * c["passes"] * v
                    for n, v in per_fwd.items()}
            got = {n: c["launches"][n] for n in per_fwd}
            check(got == want, f"[predict {tag}] {name}: launches {got} != "
                  f"{want}")
            check(all(c["launches"][n] == 0 for n in c["launches"]
                      if n not in per_fwd), f"[predict {tag}] {name}: a "
                  f"kernel off the path launched")
            for n, v in c["launches"].items():
                total[n] = total.get(n, 0) + v
            print(f"[predict {tag}] {name}: network shape {c['shape']}, "
                  f"{c['tiles']} tiles x {c['passes']} passes, launches "
                  f"{got}; labels {labels.tolist()[:4]}...{int(labels.max())}"
                  f"; s: preprocessing {t['preprocess_s']:.3f} (thread), "
                  f"predict_case {t['predict_s']:.3f}, export "
                  f"{t['export_s']:.3f}", flush=True)
        print(f"[predict {tag}] cli.main wall {wall:.2f} s (model load, "
              f"both cases)  [{smi}]", flush=True)
        return out, timings, total

    with torch.inference_mode():
        out_a, times_a, total_a = run("A", ["--all_in_gpu", "True", "-z",
                                            "--device", PRED_DEVICE])
        run("B", ["--mode", "fastest", "--device", PRED_DEVICE])
        for name in PRED_CASES:
            z = np.load(os.path.join(out_a, f"{name}.npz"))["softmax"]
            check(z.dtype == np.float16 and bool(np.isfinite(z).all()),
                  f"[predict A] {name}: npz {z.dtype}, finite "
                  f"{bool(np.isfinite(z).all())}")
        # predict_case alone on each case's data, beside its time inside
        # the folder run (the background thread's share of the host)
        bundle = predictor.ModelBundle(folder, None, "shiftConvPP",
                                       device=PRED_DEVICE)
        check(bundle.sparse_plan is not None, "the bundle runs dense")
        prep = bundle.make_preprocessor()
        cases = {}
        for name, ta in zip(PRED_CASES, times_a):
            f = [os.path.join(inputs, f"{name}_0000.nii.gz")]
            data, _s, props = prep.preprocess_test_case(
                f, bundle.stage_plan.current_spacing)
            cases[name] = (data, props)
            alone = []
            for _ in range(2):          # this bundle's first call, then warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                real_case(bundle, data, all_in_gpu=True)
                torch.cuda.synchronize()
                alone.append(time.perf_counter() - t0)
            print(f"[predict A] {name}: predict_case {ta['predict_s']:.3f} s "
                  f"in the folder run; alone on the same data "
                  f"{alone[0]:.3f} s (first call) and {alone[1]:.3f} s "
                  f"(preprocessing {ta['preprocess_s']:.3f} s on the "
                  f"thread, export {ta['export_s']:.3f} s)  [{smi}]",
                  flush=True)
        # case 1: the kernel path's npz against the plain path's and a
        # float32 plain run's, through the same export
        data, props = cases["case_001"]
        bundle32 = predictor.ModelBundle(folder, None, "shiftConvPP",
                                         compute_dtype=torch.float32,
                                         device=PRED_DEVICE)
        with blocks.plain_ops():
            refs = {"plain": real_case(bundle, data, all_in_gpu=True),
                    "float32": real_case(bundle32, data)}
        del bundle32
        npz = {"kernel": np.load(os.path.join(out_a, "case_001.npz"))[
            "softmax"].astype(np.float32)}
        for tag, p in refs.items():
            f = os.path.join(base, f"ref_{tag}")
            save_segmentation_nifti_from_softmax(
                p, f + ".nii.gz", copy.deepcopy(props), 1, None, None, None,
                f + ".npz")
            npz[tag] = np.load(f + ".npz")["softmax"].astype(np.float32)
        errs = {}
        for tag in ("kernel", "plain"):
            e = np.abs(npz[tag] - npz["float32"])
            agree = float((npz[tag].argmax(0) == npz["float32"].argmax(0))
                          .mean())
            errs[tag] = (float(e.mean()), agree)
            print(f"[predict A] case_001 npz, {tag} path vs float32 plain "
                  f"run: max |dp| {float(e.max()):.4e}, mean "
                  f"{float(e.mean()):.4e}, argmax agreement {agree:.6f}",
                  flush=True)
        check(errs["kernel"][0] <= ERR_RATIO * errs["plain"][0],
              "[predict A] the kernel path's probabilities further from the "
              "float32 run than the plain path's")
        check(errs["kernel"][1] >= errs["plain"][1] - AGREE_SLACK,
              "[predict A] the kernel path's argmax agreement below the "
              "plain path's")
    del bundle
    tmp.cleanup()
    torch.cuda.empty_cache()
    return total_a


class _TimedGen:
    """A batch generator whose next() adds the seconds it blocked to
    `waits`."""

    def __init__(self, gen, waits):
        self.gen, self.waits = gen, waits

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.gen)
        self.waits.append(time.perf_counter() - t0)
        return batch

    def stop(self):
        self.gen.stop()


def validation_text(tr, run):
    """A run's validation per case and the fold's whole validation, or that
    it was left out (trainer_spies' validate_runs)."""
    if run["validate_s"] is None:
        return "its validation left out"
    return ("validation per case (s): " + ", ".join(
        f"{t['case']} predict {t['predict_s']:.2f} export "
        f"{t['export_s']:.2f}" for t in tr.validation_timings)
        + f"; the fold's validation {run['validate_s']:.1f} s (scoring and "
        f"postprocessing included)")


def trainer_spies(tag, ops, counts, runs, validate_runs=None):
    """(initialize, load_checkpoint_file) replacements for Trainer that
    record each run into `runs`: its train steps' launches (checked equal
    to kernel_launches_per_train_step), losses and times by CUDA events,
    the host's wait in next(tr_gen), each mask update (every kernel's
    alive count held, params and momentum zero where the masks are zero),
    the epochs' and the validation's seconds, the state a checkpoint load
    gives. Each run saves 'latest' after every epoch, for -c. With
    validate_runs, only the runs of those indices (0 the first) validate;
    another run's validate() returns at once (validate_s None): a fold's
    validation is most of a phase's seconds, and another run or phase
    validates on the same path."""
    import torch
    from e2enet_tpu_torch.models.masks import broadcast_mask
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_train_step
    from e2enet_tpu_torch.training.trainer import Trainer
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file

    def d_counts(before):
        return {k: v - before[k] for k, v in counts().items()}

    def init_spy(self, training=True):
        real_init(self, training)
        self.save_every = 1   # 'latest' after each epoch, for -c
        run = {"events": [], "losses": [], "waits": [], "updates": 0,
               "epochs": [], "trainer": self, "loaded": None}
        runs.append(run)
        index = len(runs) - 1
        per_step = kernel_launches_per_train_step(
            self.network, do_ds=self.ds_mode != "none")
        want = {k: per_step["forward"].get(k, 0)
                + per_step["backward"].get(k, 0) for k in ops}
        run["want"] = want
        step_fn = self.train_step
        update_fn = getattr(self, "mask_update", None)
        lr_fn, ma_fn = self.maybe_update_lr, self.update_eval_criterion_MA
        validate_fn = self.validate

        def step(state, data, targets, lr):
            before = counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step_fn(state, data, targets, lr)
            ev[1].record()
            got = d_counts(before)
            check(got == want, f"[{tag}] step {state.step}: launches "
                  f"{got} != {want}")
            run["events"].append(ev)
            run["losses"].append(out[1]["loss"])
            return out

        def update(state, death_rate, grads=None):
            alive = {n: float(m.sum()) for n, m in state.masks.items()}
            out = update_fn(state, death_rate, grads)
            for n, m in out.masks.items():
                check(float(m.sum()) == alive[n], f"[{tag}] step "
                      f"{out.step}: {n} alive {float(m.sum())} != "
                      f"{alive[n]}")
                dead = broadcast_mask(1.0 - m, out.params[n])
                for t in (out.params[n].detach(), out.momentum[n]):
                    check(bool((t * dead == 0).all()), f"[{tag}] step "
                          f"{out.step}: {n} nonzero where its mask is 0")
            run["updates"] += 1
            return out

        def epoch_start(epoch=None):
            run["epochs"].append([time.perf_counter(), None])
            return lr_fn(epoch)

        def epoch_end():
            run["epochs"][-1][1] = time.perf_counter()
            return ma_fn()

        def validate(*a, **k):
            if validate_runs is not None and index not in validate_runs:
                run["validate_s"] = None
                return None
            t0 = time.perf_counter()
            out = validate_fn(*a, **k)
            run["validate_s"] = time.perf_counter() - t0
            return out
        self.train_step = step
        if update_fn is not None:
            self.mask_update = update
        self.maybe_update_lr, self.update_eval_criterion_MA = \
            epoch_start, epoch_end
        self.validate = validate
        if training:
            self.tr_gen = _TimedGen(self.tr_gen, run["waits"])

    def load_spy(self, which, train=True):
        real_load(self, which, train)
        st = self.state
        runs[-1]["loaded"] = (which, self.epoch, st.step, {
            "params": {n: p.detach().cpu() for n, p in st.params.items()},
            "momentum": {n: m.cpu() for n, m in st.momentum.items()},
            "masks": {n: m.cpu() for n, m in st.masks.items()}})

    return init_spy, load_spy


def trainer_phase(ops, reset_counts, counts, smi, then=None):
    """[trainer] the users' training path at the bench width: a seeded
    raw task that the port's plan CLI plans and preprocesses in a fresh
    process (plan_train_task: TRAIN_CASES, 16 classes; the plan asserted
    to be one stage of 128^3 patches, batch 2, 5 pools), cli/train.main
    on the card at bf16 with
    kernel-granular DSFF (density 0.2, an update every 4 steps), 2 epochs
    of 6 batches (2 validation batches each), then -c to a third epoch
    from 'latest', which ends in the fold's validation (the first run's
    validation is left to it); then
    cli/predict.main with the trained fold on one validation case. Spies
    on each Trainer: the launches of every train step (equal to
    kernel_launches_per_train_step), its time by CUDA events, the host's
    wait in next(tr_gen), each mask update (params and momentum zero where
    the masks are zero, every kernel's alive count held), the state -c
    loads against the 'latest' file, the epochs' seconds. Returns the
    launches over the whole phase; then(paths, medians, info) runs on the
    planned task before its folder is removed, with each run's median ms
    per step after the first and info: {"want": the launches per step,
    "waits": each run's mean wait per batch after the first}."""
    import os
    import tempfile
    import torch
    from e2enet_tpu_torch import native
    from e2enet_tpu_torch.cli import predict as pcli
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.weights import from_jax_params
    from e2enet_tpu_torch.training import checkpoint as ckpt
    from e2enet_tpu_torch.training.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
    paths = plan_train_task(tmp.name, smi)
    route = native.route()
    print(f"[trainer] validation {TRAIN_VAL}; augmentation warp route: "
          f"{route} ({native.library_path().name})", flush=True)
    check(route == "native", "[trainer] the C++ warp did not build")
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"]

    runs = []
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    # the first run's validation is left to the -c run (the same fold)
    init_spy, load_spy = trainer_spies("trainer", ops, counts, runs,
                                       validate_runs={1})

    args = ["--task", TRAIN_TASK, "--fold", "0", "--batches", "6",
            "--val_batches", "2", "--sparse", "True", "--density", "0.2",
            "--update_frequency", "4"]
    Trainer.initialize, Trainer.load_checkpoint_file = init_spy, load_spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    try:
        for extra in (["--epochs", "2"], ["--epochs", "3", "-c"]):
            if extra[-1] == "-c":
                fold = runs[-1]["trainer"].output_folder
                latest = ckpt.load_checkpoint(os.path.join(
                    fold, "shiftConvPP_model_latest.model"))
            t0 = time.perf_counter()
            tcli.main(args + extra)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(runs) == 2, f"[trainer] {len(runs)} trainers")

    # -c: the state loaded equals the 'latest' file to the bit
    which, epoch, step, loaded = runs[1]["loaded"]
    state, l_epoch, _ = latest
    check(which == "latest" and epoch == l_epoch == 2 and step == 12
          == state["step"], f"[trainer] -c loaded {which} at epoch {epoch}, "
          f"step {step}")
    for what in ("params", "momentum"):
        want_t = from_jax_params(state[what])
        for n, t in loaded[what].items():
            check(torch.equal(t, want_t[n]), f"[trainer] -c: {what} {n} "
                  f"differs from the 'latest' file")
    for n, m in loaded["masks"].items():
        check(np.array_equal(m.numpy(), state["masks"][n.replace(".", "|")]),
              f"[trainer] -c: mask {n} differs from the 'latest' file")

    second = runs[1]["trainer"]
    medians = []
    for i, run in enumerate(runs):
        tr = run["trainer"]
        losses = [float(v) for v in run["losses"]]
        ms = [a.elapsed_time(b) for a, b in run["events"]]
        check(all(np.isfinite(losses)) and all(
            np.isfinite(tr.all_tr_losses + tr.all_val_losses)),
            f"[trainer] run {i + 1}: a loss is not finite")
        check(run["updates"] == len(losses) // 4, f"[trainer] run {i + 1}: "
              f"{run['updates']} mask updates in {len(losses)} steps")
        waits, epochs = run["waits"], [b - a for a, b in run["epochs"]]
        medians.append(float(np.median(ms[1:])))
        print(f"[trainer] run {i + 1}: {len(losses)} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; epoch train / "
              f"validation loss {tr.all_tr_losses} / {tr.all_val_losses}; "
              f"online Dice {tr.all_val_eval_metrics}; {run['updates']} "
              f"mask updates", flush=True)
        print(f"[trainer] run {i + 1}: ms per step (CUDA events) "
              f"{' '.join(f'{v:.1f}' for v in ms)}; steps after the first: "
              f"mean {float(np.mean(ms[1:])):.1f}, median "
              f"{float(np.median(ms[1:])):.1f}; host wait per batch in "
              f"next(tr_gen) (s) {' '.join(f'{v:.3f}' for v in waits)}, "
              f"after the first: mean {float(np.mean(waits[1:])):.3f}; s per "
              f"epoch {' '.join(f'{v:.2f}' for v in epochs)}; "
              f"{validation_text(tr, run)}; cli.main {walls[i]:.1f} s  "
              f"[{smi}]", flush=True)
    check(second.epoch == 3 and second.all_tr_losses[0]
          > second.all_tr_losses[-1], f"[trainer] epoch train losses "
          f"{second.all_tr_losses}: the first not above the last")
    fold = second.output_folder
    summary = json.load(open(os.path.join(fold, "validation_raw",
                                          "summary.json")))
    dice = {int(k): v["Dice"] for k, v in summary["results"]["mean"].items()}
    check(all(np.isfinite(dice.get(c, np.nan))
              for c in range(1, NUM_CLASSES)), f"[trainer] summary Dice "
          f"{dice}")
    check(os.path.isfile(os.path.join(fold, "postprocessing.json")),
          "[trainer] no postprocessing.json")
    print(f"[trainer] validation_raw/summary.json mean Dice per label "
          f"{ {k: round(v, 4) for k, v in dice.items()} }; "
          f"postprocessing.json "
          f"{json.load(open(os.path.join(fold, 'postprocessing.json')))['for_which_classes']}; "
          f"peak memory allocated {peak:.2f} GiB", flush=True)
    info = {"want": runs[0]["want"],
            "waits": [float(np.mean(r["waits"][1:])) for r in runs]}
    del runs, second
    torch.cuda.empty_cache()

    # the port's predict CLI with the trained fold, one validation case
    inp = os.path.join(tmp.name, "predict_in")
    os.makedirs(inp)
    case = TRAIN_VAL[0]
    os.symlink(os.path.join(paths["images"], f"{case}_0000.nii.gz"),
               os.path.join(inp, f"{case}_0000.nii.gz"))
    out = os.path.join(tmp.name, "predict_out")
    t0 = time.perf_counter()
    pcli.main(["-i", inp, "-o", out, "-t", TRAIN_TASK, "-f", "0"])
    seg = read_nifti(os.path.join(out, f"{case}.nii.gz")).array
    labels = np.unique(seg)
    check(seg.shape == TRAIN_CASES[case] and int(labels.min()) >= 0
          and int(labels.max()) < NUM_CLASSES, f"[trainer] predict: shape "
          f"{seg.shape}, labels {labels}")
    print(f"[trainer] cli.predict with the trained fold on {case}: shape "
          f"{seg.shape}, labels {labels.tolist()}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check("jax" not in sys.modules, "[trainer] jax was imported")
    total = counts()
    if then is not None:
        then(paths, medians, info)
    tmp.cleanup()
    return total


# the [options] phase: the trainer's optimizers, losses and gradient
# growth at the bench width
OPTION_STEPS = 8
OPTION_UPDATE_EVERY = 4
OPTIMIZERS = ("sgd", "ranger", "adam")


def _opt_buffers(momentum):
    """{field: {name: tensor}} of an optimizer state: SGD's momentum, or
    every dict field of a RangerState / AdamState."""
    if isinstance(momentum, dict):
        return {"momentum": momentum}
    return {f: v for f, v in zip(momentum._fields, momentum)
            if isinstance(v, dict)}


def options_phase(ops, counts, smi, paths):
    """[options] the trainer's options on the card at the bench width
    (training/train_bench_masks.build: 48 base features, 16 classes, bf16,
    row masks at density 0.2, seed 0; the train phase's synthetic batch of
    2 x 128^3): SGD, Ranger and Adam 8 steps each with a gradient-growth
    mask update (make_grad_step on the step's batch) after steps 4 and 8
    (Ranger's Lookahead fires at step 6); per step the launches equal
    kernel_launches_per_train_step, a finite loss, dead rows zero in the
    parameters and in every buffer of the optimizer's state; per update
    the gradient step's launches the same count and the row counts held;
    the loss falling; ms per step (CUDA events), ms per update and the peak
    memory per optimizer. Then one step of each loss of LOSS_REGISTRY (the
    region losses on one-hot targets made from the labels): a finite loss
    and gradient norm, launches as counted. Then make_grad_step on 2 x
    64^3 against the bf16 plain path and a float32 plain run (ERR_RATIO),
    and its ms per call at 2 x 128^3. Then cli/train.main for one epoch on
    [trainer]'s planned task (`paths`) with -tr
    nnUNetTrainerV2_Ranger_lr3en4 --sparse True --growth gradient
    --granularity kernel, 4 batches, an update every 2 steps (its fold's
    validation, which [trainer] checks, left out): finite losses, launches
    per step and per gradient step, the kernels' alive counts held, the
    'latest' checkpoint's Ranger state loading back equal to the bit.
    Prints the phase's seconds."""
    import os
    import torch
    import torch.nn.functional as F
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.models.masks import broadcast_mask
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, kernel_launches_per_train_step)
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.losses import LOSS_REGISTRY
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.training.train_state import (make_grad_step,
                                                       make_train_step)
    from e2enet_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()

    def d_counts(before):
        return {k: v - before[k] for k, v in counts().items()}

    def rows_alive(masks):
        return {n: int(m[:, 0].sum()) for n, m in masks.items()}

    def assert_dead_zero(tag, st):
        bufs = _opt_buffers(st.momentum)
        for n, m in st.masks.items():
            dead = (m == 0).float()
            for what, t in [("param", st.params[n].detach())] + [
                    (f, b[n]) for f, b in bufs.items()]:
                check(bool((t * broadcast_mask(dead, t) == 0).all()),
                      f"{tag}: {n} {what} nonzero where its mask is 0")

    batch = want = None
    for opt in OPTIMIZERS:
        model, state, step_fn, update, weights = tbm.build(
            "cuda", optimizer=opt, growth="gradient")
        if want is None:
            per = kernel_launches_per_train_step(model)
            want = {k: per["forward"].get(k, 0) + per["backward"].get(k, 0)
                    for k in ops}
            batch = tbm.device_batches(np.random.RandomState(3), 1, 2,
                                       PATCH, model.num_ds_outputs(), "cuda")
        rows0 = rows_alive(state.masks)
        log = dict(losses=[], ms=[], update_ms=[])

        def step(st, data, targets, lr, opt=opt):
            before = counts()
            res = step_fn(st, data, targets, lr)
            got = d_counts(before)
            check(got == want, f"[options] {opt} step {st.step}: launches "
                  f"{got} != {want}")
            return res

        def mask_update(st, death_rate, data, targets, opt=opt, log=log):
            before = counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            st = update(st, death_rate, data, targets)
            ev[1].record()
            ev[1].synchronize()
            log["update_ms"].append(ev[0].elapsed_time(ev[1]))
            got = d_counts(before)
            check(got == want, f"[options] {opt} update at step {st.step}: "
                  f"the gradient step's launches {got} != {want}")
            check(rows_alive(st.masks) == rows0, f"[options] {opt} update "
                  f"at step {st.step} moved the row counts")
            return st

        def on_step(i, st, metrics, ms, updated, opt=opt, log=log):
            loss = float(metrics["loss"])
            check(np.isfinite(loss) and np.isfinite(float(
                metrics["grad_norm"])), f"[options] {opt} step {i + 1}: "
                f"loss {loss}")
            assert_dead_zero(f"[options] {opt} step {i + 1}", st)
            log["losses"].append(loss)
            log["ms"].append(ms)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tbm.train(model, state, step, mask_update, batch, OPTION_STEPS,
                  OPTION_STEPS, OPTION_UPDATE_EVERY, on_step=on_step)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses, ms = log["losses"], log["ms"][1:]
        check(len(log["update_ms"]) == OPTION_STEPS // OPTION_UPDATE_EVERY,
              f"[options] {opt}: {len(log['update_ms'])} mask updates")
        check(losses[-1] < losses[0], f"[options] {opt}: the loss did not "
              f"fall: {losses}")
        if opt != "sgd":
            check(state.momentum.step == OPTION_STEPS, f"[options] {opt}: "
                  f"optimizer step {state.momentum.step}")
        print(f"[options] {opt}: {OPTION_STEPS} steps, loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}; ms per step (CUDA "
              f"events) {' '.join(f'{v:.1f}' for v in log['ms'])}, steps "
              f"2..{OPTION_STEPS} mean {np.mean(ms):.1f}; gradient-growth "
              f"updates (gradient step included) "
              f"{' '.join(f'{v:.1f}' for v in log['update_ms'])} ms; peak "
              f"memory allocated {peak:.2f} GiB  [{smi}]", flush=True)
        if opt == "sgd":
            keep = model, state, weights
        del model, state, step_fn, update
        torch.cuda.empty_cache()

    # ---- one step of each loss
    model, state, weights = keep
    data, targets = batch[0]
    onehot = tuple(F.one_hot(t, NUM_CLASSES).float() for t in targets)
    for name in LOSS_REGISTRY:
        region = name in ("dc_bce", "dice_regions")
        fn = make_train_step(model, weights, loss_name=name)
        before = counts()
        state, m = fn(state, data, onehot if region else targets, 1e-3)
        got = d_counts(before)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        check(got == want, f"[options] loss {name}: launches {got}")
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"[options] loss {name}: loss {loss}, gradient norm {gnorm}")
        kind = " (one-hot region targets)" if region else ""
        print(f"[options] loss {name}{kind}: one step, loss {loss:.5f}, "
              f"gradient norm {gnorm:.4f}", flush=True)
    del onehot

    # ---- make_grad_step: kernels against the bf16 plain path and float32
    grad_step = make_grad_step(model, weights)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    grad_step(data, targets)
    ev[0].record()
    for _ in range(3):
        grad_step(data, targets)
    ev[1].record()
    ev[1].synchronize()
    grad_ms = ev[0].elapsed_time(ev[1]) / 3
    small, small_t = tbm.device_batches(np.random.RandomState(5), 1, 2,
                                        GRAD_PATCH, model.num_ds_outputs(),
                                        "cuda")[0]
    names = [n for n, _ in model.named_parameters()]

    def flat(g):
        return torch.cat([g[n].float().flatten() for n in names])
    before = counts()
    g_k = flat(grad_step(small, small_t))
    check(d_counts(before) == want, "[options] make_grad_step: launches "
          f"{d_counts(before)} != {want}")
    with blocks.plain_ops():
        g_p = flat(grad_step(small, small_t))
        model32 = ShiftUNetPlusPlus(1, tbm.NUM_CLASSES, tbm.POOLS,
                                    compute_dtype=torch.float32,
                                    device="cuda")
        model32.load_state_dict(model.state_dict())
        g_32 = flat(make_grad_step(model32, weights)(small, small_t))
    del model32
    e_k = float((g_k - g_32).norm() / g_32.norm())
    e_p = float((g_p - g_32).norm() / g_32.norm())
    print(f"[options] make_grad_step on 2 x 64^3 against a float32 plain "
          f"run: kernel path rel L2 err {e_k:.4e}, bf16 plain path "
          f"{e_p:.4e}; {grad_ms:.1f} ms per call at 2 x 128^3 (CUDA "
          f"events, mean of 3)", flush=True)
    check(e_k <= ERR_RATIO * e_p, "[options] make_grad_step: kernel-path "
          "gradients further from the float32 run than the bf16 plain "
          "path's")
    del model, state, keep, batch, g_k, g_p, g_32
    torch.cuda.empty_cache()

    # ---- the train CLI with a Ranger preset and gradient growth
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"] + "_options"
    run = {"losses": [], "grad_steps": 0, "updates": 0}
    real_init, real_validate = Trainer.initialize, Trainer.validate

    def init_spy(self, training=True):
        real_init(self, training)
        self.save_every = 1            # 'latest' at the epoch's end
        step_fn, grad_fn = self.train_step, self._dsff_grad_step
        update_fn = self.mask_update

        def step(st, data, targets, lr, *extras):
            before = counts()
            res = step_fn(st, data, targets, lr, *extras)
            check(d_counts(before) == want, f"[options] cli step "
                  f"{st.step}: launches {d_counts(before)}")
            run["losses"].append(res[1]["loss"])
            return res

        def grad(data, targets):
            before = counts()
            g = grad_fn(data, targets)
            check(d_counts(before) == want, f"[options] cli gradient "
                  f"step: launches {d_counts(before)}")
            run["grad_steps"] += 1
            return g

        def update(st, death_rate, grads=None):
            alive = {n: float(m.sum()) for n, m in st.masks.items()}
            st = update_fn(st, death_rate, grads)
            for n, m in st.masks.items():
                check(float(m.sum()) == alive[n], f"[options] cli update: "
                      f"{n} alive {float(m.sum())} != {alive[n]}")
            assert_dead_zero("[options] cli update", st)
            run["updates"] += 1
            return st
        self.train_step, self._dsff_grad_step = step, grad
        self.mask_update = update

    Trainer.initialize = init_spy
    Trainer.validate = lambda self, *a, **k: None
    t0 = time.perf_counter()
    try:
        tr = tcli.main(["--task", TRAIN_TASK, "--fold", "0", "--epochs",
                        "1", "--batches", "4", "--val_batches", "1",
                        "-tr", "nnUNetTrainerV2_Ranger_lr3en4", "--sparse",
                        "True", "--growth", "gradient", "--granularity",
                        "kernel", "--density", "0.2", "--update_frequency",
                        "2"])
    finally:
        Trainer.initialize, Trainer.validate = real_init, real_validate
    wall = time.perf_counter() - t0
    losses = [float(v) for v in run["losses"]]
    check(len(losses) == 4 and all(np.isfinite(losses + tr.all_tr_losses
                                               + tr.all_val_losses)),
          f"[options] cli: losses {losses}")
    check(run["grad_steps"] == run["updates"] == 2, f"[options] cli: "
          f"{run['grad_steps']} gradient steps, {run['updates']} updates")
    st = tr.state
    check(type(st.momentum).__name__ == "RangerState" and tr.optimizer
          == "ranger" and tr.initial_lr == 3e-4, "[options] cli: not Ranger")
    snap = {"params": {n: p.detach().cpu().clone()
                       for n, p in st.params.items()},
            "masks": {n: m.cpu().clone() for n, m in st.masks.items()},
            **{f: {n: t.cpu().clone() for n, t in b.items()}
               for f, b in _opt_buffers(st.momentum).items()}}
    step, opt_step = st.step, st.momentum.step
    tr.load_checkpoint_file("latest")
    st = tr.state
    check(st.step == step and st.momentum.step == opt_step == 4,
          f"[options] cli: 'latest' at step {st.step}, Ranger step "
          f"{st.momentum.step}")
    loaded = {"params": {n: p.detach().cpu() for n, p in st.params.items()},
              "masks": {n: m.cpu() for n, m in st.masks.items()},
              **{f: {n: t.cpu() for n, t in b.items()}
                 for f, b in _opt_buffers(st.momentum).items()}}
    for what, tensors in snap.items():
        for n, t in tensors.items():
            check(torch.equal(loaded[what][n], t), f"[options] cli: "
                  f"'latest' {what} {n} differs from the trained state")
    print(f"[options] cli.train -tr nnUNetTrainerV2_Ranger_lr3en4 --growth "
          f"gradient --granularity kernel: 4 steps, losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}, {run['updates']} "
          f"gradient-growth updates, alive counts held; 'latest' loads back "
          f"equal to the bit (params, masks, "
          f"{', '.join(k for k in snap if k not in ('params', 'masks'))}); "
          f"{wall:.1f} s", flush=True)
    del tr, st, snap, loaded
    torch.cuda.empty_cache()
    print(f"[options] the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# the [dsff] phase: every DSFF engine of the trainer at the bench width
DSFF_STEPS = 8
DSFF_UPDATE_AT = (4, 8)
DSFF_DENSITY = 0.3
DSFF_FINAL_DENSITY = 0.2
# the death rate's cosine as over a run of 16 steps, the global schedule's
# ramp as over epochs 0-4 of 8 steps each: both updates prune by a rate
# above 0.25 and the first grows by a ratio below 1
DSFF_T_MAX = 16
DSFF_ITERS_PER_EPOCH = 8
DSFF_FINAL_PRUNE_EPOCH = 4
GMP_EPOCHS = (1, 2, 3)            # of a ramp over epochs 0-4
GRASP_PATCH = (64, 64, 64)
# a global threshold, a lottery ticket, snip or GraSP keep every entry tied
# at their threshold: the densities are held to the target within this,
# plus the ties
DSFF_DENSITY_ATOL = 1e-3


def dsff_phase(ops, counts, smi, paths):
    """[dsff] every DSFF engine of the trainer on the card at the bench
    width (48 base features, 16 classes, bf16, SGD, seed 0; the train
    phase's synthetic batch of 2 x 128^3):
    - the local element prune: uniform_ori at DSFF_DENSITY, 8 steps, a
      mask update after step 4 (random growth) and after step 8 (gradient
      growth, make_grad_step on the step's batch); per step launches equal
      to kernel_launches_per_train_step, a finite loss, dead elements zero
      in the parameters and the momentum; per update every kernel's alive
      count held; ms per step beside 4 steps of the same model with row
      masks at 0.2 (the train phase's);
    - the global prune: ERK at DSFF_DENSITY, gradient growth, updates after
      steps 4 and 8 with the regrow ratio of grow_schedule_ratio: the
      pruned count that of the global threshold recomputed on the host,
      the grown count within 5 sigma of the Bernoulli budget;
    - GMP from dense: gmp_prune_masks at GMP_EPOCHS of a ramp over epochs
      0-4, each kernel's pruned count int(rate * size) plus the ties at
      its threshold;
    - the lottery ticket and snip (from make_grad_step's gradients), and
      GraSP on 1 x 64^3 (the plain path: no kernel launches), each density
      within DSFF_DENSITY_ATOL of the target plus the ties; GraSP's
      seconds and peak memory;
    - cli/train.main on [trainer]'s task (`paths`) with --sparse_init ERK
      --prune_mode global --growth gradient --update_frequency 2 for one
      epoch of 4 batches, then -c for a second (the validations left out):
      launches per step and per gradient step, each logged regrow_ratio
      equal to grow_schedule_ratio recomputed on the host, the 'latest'
      element masks and fired masks in the flax layout loading back equal
      to the bit; then --sparse_init GMP --init-prune-epoch 0
      --final-prune-epoch 2 for 2 epochs (a GMP line after each, the
      density falling); then cli/predict.main on one case with the global
      run's fold: dense masked (no plan), launches tiles x passes x the
      per-forward counts, labels in [0, 16).
    Prints ms per step, ms per mask update per mode, the peak memory and
    the phase's seconds."""
    import os
    import re
    import tempfile
    import torch
    from e2enet_tpu_torch.cli import predict as pcli
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.inference import predictor
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.masks import (masked_params, masks_density,
                                               masks_for_model)
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, ds_loss_weights, kernel_launches_per_forward,
        kernel_launches_per_train_step)
    from e2enet_tpu_torch.ops.losses import dc_and_ce_loss
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, pad_volume_to_patch)
    from e2enet_tpu_torch.training import checkpoint as ckpt
    from e2enet_tpu_torch.training import dsff
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.training.train_state import (
        apply_new_masks, create_train_state, make_grad_step,
        make_mask_update_step, make_train_step)
    from e2enet_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    dev = "cuda"

    def d_counts(before):
        return {k: v - before[k] for k, v in counts().items()}

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1])

    def alive(masks):
        return {n: int(m.sum()) for n, m in masks.items()}

    def assert_dead_zero(tag, st):
        for n, m in st.masks.items():
            for what, t in (("param", st.params[n].detach()),
                            ("momentum", st.momentum[n])):
                check(bool((t * (m == 0) == 0).all()),
                      f"{tag}: {n} {what} nonzero where its mask is 0")

    model = ShiftUNetPlusPlus(1, NUM_CLASSES, tbm.POOLS,
                              compute_dtype=torch.bfloat16, device=dev)
    weights = ds_loss_weights(len(tbm.POOLS), model.num_ds_outputs())
    per = kernel_launches_per_train_step(model)
    want = {k: per["forward"].get(k, 0) + per["backward"].get(k, 0)
            for k in ops}
    batch = tbm.device_batches(np.random.RandomState(3), 1, 2, PATCH,
                               model.num_ds_outputs(), dev)
    data, targets = batch[0]
    step_fn = make_train_step(model, weights)
    grad_step = make_grad_step(model, weights)
    names = sorted(masked_params(model))
    n_elems = sum(masked_params(model)[n].numel() for n in names)
    print(f"[dsff] ShiftUNet++ bench width, batch 2 x 128^3, bf16, SGD; "
          f"{len(names)} masked kernels, {n_elems} elements", flush=True)
    update_ms = {}

    def fresh(masks_fn):
        model.reset_parameters(seed=tbm.SEED)
        return create_train_state(model, masks_fn(), seed=tbm.SEED)

    def run_steps(tag, st, n, on_update=None):
        ms, losses = [], []
        for i in range(n):
            before = counts()
            (st, metrics), t = timed(lambda: step_fn(st, data, targets,
                                                     tbm.INITIAL_LR))
            got = d_counts(before)
            check(got == want, f"{tag} step {i + 1}: launches {got} != "
                  f"{want}")
            loss = float(metrics["loss"])
            check(np.isfinite(loss), f"{tag} step {i + 1}: loss {loss}")
            if st.masks is not None and st.masks[names[0]].dim() > 2:
                assert_dead_zero(f"{tag} step {i + 1}", st)
            ms.append(t)
            losses.append(loss)
            if on_update is not None and i + 1 in DSFF_UPDATE_AT:
                st = on_update(i + 1, st)
        return st, ms, losses

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the row-mask step of the train phase, for comparison
    st = fresh(lambda: dsff.init_masks_row(
        model, 0.2, torch.Generator().manual_seed(tbm.SEED + 1),
        density_48_override=0.2))
    _, row_ms, _ = run_steps("[dsff] row masks", st, 4)
    del st

    # ---- the local element prune: random, then gradient growth
    gen = torch.Generator().manual_seed(tbm.SEED + 1)
    st = fresh(lambda: dsff.init_masks_element(model, DSFF_DENSITY, gen,
                                               "uniform_ori"))
    d0 = masks_density(st.masks, model)
    updates = {"random": make_mask_update_step(model, "random", "local",
                                               "element"),
               "gradient": make_mask_update_step(model, "gradient",
                                                 "local", "element")}

    def local_update(step, st):
        growth = "random" if step == DSFF_UPDATE_AT[0] else "gradient"
        before_alive = alive(st.masks)
        dr = dsff.cosine_death_rate(step, 0.5, DSFF_T_MAX)
        before = counts()

        def go():
            grads = grad_step(data, targets) if growth == "gradient" \
                else None
            return updates[growth](st, dr, grads)
        st2, t = timed(go)
        got = d_counts(before)
        check(got == (want if growth == "gradient" else
                      {k: 0 for k in want}), f"[dsff] local {growth} "
              f"update: launches {got}")
        check(alive(st2.masks) == before_alive, f"[dsff] local {growth} "
              f"update at step {step} moved an alive count")
        assert_dead_zero(f"[dsff] local {growth} update", st2)
        update_ms[f"local element {growth}"] = t
        return st2
    st, el_ms, el_losses = run_steps("[dsff] uniform_ori", st, DSFF_STEPS,
                                     local_update)
    check(el_losses[-1] < el_losses[0], f"[dsff] uniform_ori: the loss did "
          f"not fall: {el_losses}")
    print(f"[dsff] local element prune, uniform_ori at {DSFF_DENSITY} "
          f"(density {d0:.4f} -> {masks_density(st.masks, model):.4f}): "
          f"loss {el_losses[0]:.5f} -> {el_losses[-1]:.5f}; ms per step "
          f"(CUDA events) {' '.join(f'{v:.1f}' for v in el_ms)}, steps "
          f"2..{DSFF_STEPS} mean {np.mean(el_ms[1:]):.1f}; the same model "
          f"with row masks at 0.2: {' '.join(f'{v:.1f}' for v in row_ms)}, "
          f"steps 2..4 mean {np.mean(row_ms[1:]):.1f}", flush=True)
    del st

    # ---- the global prune, ERK, its grow schedule
    gen = torch.Generator().manual_seed(tbm.SEED + 1)
    st = fresh(lambda: dsff.init_masks_element(model, DSFF_DENSITY, gen,
                                               "ERK"))
    g_update = make_mask_update_step(model, "gradient", "global", "element")
    ratio = [1.01]

    def global_update(step, st):
        m0 = {n: m.clone() for n, m in st.masks.items()}
        tw = float(n_elems)
        tn = float(sum(int(m.sum()) for m in m0.values()))
        dr = dsff.cosine_death_rate(step, 0.5, DSFF_T_MAX)
        ratio[0] = dsff.grow_schedule_ratio(
            step, DSFF_UPDATE_AT[0], DSFF_ITERS_PER_EPOCH, DSFF_DENSITY,
            DSFF_FINAL_DENSITY, dr, tw, tn, tn / tw, ratio[0], 0,
            DSFF_FINAL_PRUNE_EPOCH)
        # the host's global threshold over every |w|
        absw = torch.cat([st.params[n].detach().float().abs().cpu()
                          .reshape(-1) for n in names])
        keep = int(np.float32(tn) * (np.float32(1) - np.float32(dr)))
        thr = torch.sort(absw, descending=True).values[keep - 1]
        kept = int((absw >= thr).sum())
        st2, t = timed(lambda: g_update(st, dr, grad_step(data, targets),
                                        ratio[0]))
        pruned = int(tn) - sum(int((st2.masks[n] * m0[n]).sum())
                               for n in names)
        grown = sum(int((st2.masks[n] * (1 - m0[n])).sum()) for n in names)
        n_dead = tw - tn
        budget = ratio[0] * tn * dr
        p = budget / n_dead
        sigma = float(np.sqrt(n_dead * p * (1 - p)))
        check(pruned == int(tn) - kept, f"[dsff] global update at step "
              f"{step}: pruned {pruned}, the host's threshold "
              f"{int(tn) - kept}")
        check(abs(grown - budget) <= 5 * sigma, f"[dsff] global update at "
              f"step {step}: grew {grown}, budget {budget:.1f} +- "
              f"{sigma:.1f}")
        assert_dead_zero(f"[dsff] global update at step {step}", st2)
        update_ms["global"] = t
        print(f"[dsff] global update at step {step}: death rate {dr:.4f}, "
              f"regrow_ratio {ratio[0]:.4f}, alive {int(tn)}: pruned "
              f"{pruned} (the host's threshold {thr.item():.6g}), grew "
              f"{grown} (budget {budget:.1f} +- {sigma:.1f}); density "
              f"{masks_density(st2.masks, model):.4f}; {t:.1f} ms "
              f"(gradient step included)", flush=True)
        return st2
    st, gl_ms, gl_losses = run_steps("[dsff] ERK global", st, DSFF_STEPS,
                                     global_update)
    print(f"[dsff] global prune, ERK at {DSFF_DENSITY}: loss "
          f"{gl_losses[0]:.5f} -> {gl_losses[-1]:.5f}; ms per step "
          f"{' '.join(f'{v:.1f}' for v in gl_ms)}", flush=True)
    del st

    # ---- GMP from dense
    st = fresh(lambda: dsff.init_masks_gmp(model))
    gmp = []
    for epoch in GMP_EPOCHS:
        lo, hi = 0, 4
        decay = (1.0 - (epoch - lo) / (hi - lo + 1)) ** 3
        rate = (1.0 - DSFF_DENSITY) - (1.0 - DSFF_DENSITY) * decay
        new, t = timed(lambda: dsff.gmp_prune_masks(
            model, st.masks, epoch, DSFF_DENSITY, lo, hi))
        for n in names:
            a = st.params[n].detach().float().abs()
            p_n = int(rate * a.numel())
            check(p_n > 0, f"[dsff] GMP epoch {epoch}: {n} prunes nothing")
            thr = torch.sort(a.reshape(-1)).values[p_n - 1]
            zeros = int((new[n] == 0).sum())
            ties = int((a == thr).sum())
            check(p_n <= zeros <= p_n + ties - 1, f"[dsff] GMP epoch "
                  f"{epoch}: {n} pruned {zeros}, int(rate * size) {p_n}, "
                  f"{ties} tied")
        st = apply_new_masks(st, new)
        assert_dead_zero(f"[dsff] GMP epoch {epoch}", st)
        gmp.append((epoch, rate, masks_density(st.masks, model), t))
    update_ms["GMP prune"] = gmp[-1][3]
    print(f"[dsff] GMP from dense, ramp over epochs 0-4: " + "; ".join(
        f"epoch {e} rate {r:.4f} density {d:.4f} ({t:.1f} ms)"
        for e, r, d, t in gmp), flush=True)

    def ties_share(masks, scores):
        """The share of entries tied at the smallest kept score."""
        thr = min(float(s[m > 0].min()) for s, m in
                  ((scores[n], masks[n]) for n in names) if m.any())
        return sum(int((scores[n] == thr).sum()) for n in names) / n_elems

    # ---- the lottery ticket and snip
    model.reset_parameters(seed=tbm.SEED)
    params = masked_params(model)
    lt = dsff.init_masks_lottery(model, DSFF_DENSITY)
    d_lt = masks_density(lt, model)
    share = ties_share(lt, {n: params[n].detach().float().abs()
                            for n in names})
    check(0 <= d_lt - DSFF_DENSITY <= DSFF_DENSITY_ATOL + share,
          f"[dsff] lottery ticket density {d_lt}")
    before = counts()
    grads = grad_step(data, targets)
    check(d_counts(before) == want, "[dsff] snip: the gradient step's "
          f"launches {d_counts(before)}")
    sn = dsff.init_masks_element(model, DSFF_DENSITY, mode="snip",
                                 grads=grads)
    d_sn = masks_density(sn, model)
    share_sn = ties_share(sn, {n: (params[n].detach().float()
                                   * grads[n].float()).abs() for n in names})
    check(0 <= d_sn - DSFF_DENSITY <= DSFF_DENSITY_ATOL + share_sn,
          f"[dsff] snip density {d_sn}")
    del grads, lt, sn
    print(f"[dsff] lottery ticket density {d_lt:.6f} (ties {share:.2e}); "
          f"snip from make_grad_step's gradients {d_sn:.6f} (ties "
          f"{share_sn:.2e})", flush=True)

    steps_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # ---- GraSP on the plain path
    small, small_t = tbm.device_batches(np.random.RandomState(5), 1, 1,
                                        GRASP_PATCH, model.num_ds_outputs(),
                                        dev)[0]

    def grasp_loss(m, d, t):
        return dc_and_ce_loss(m(d, do_ds=False), t[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    t0 = time.perf_counter()
    scores = dsff.grasp_scores(grasp_loss, model, small, small_t)
    gr = dsff.init_masks_grasp(grasp_loss, model, DSFF_DENSITY, small,
                               small_t)
    torch.cuda.synchronize()
    grasp_s = time.perf_counter() - t0
    grasp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(v == 0 for v in d_counts(before).values()), "[dsff] GraSP "
          f"launched kernels {d_counts(before)}: not the plain path")
    d_gr = masks_density(gr, model)
    kept = {n: scores[n][gr[n] > 0] for n in names}
    thr = max(float(k.max()) for k in kept.values() if k.numel())
    share_gr = sum(int((scores[n] == thr).sum()) for n in names) / n_elems
    check(abs(d_gr - DSFF_DENSITY) <= DSFF_DENSITY_ATOL + share_gr,
          f"[dsff] GraSP density {d_gr}")
    print(f"[dsff] GraSP on 1 x 64^3 (the plain path, no kernel launched; "
          f"scores and masks, two passes): density {d_gr:.6f} (ties "
          f"{share_gr:.2e}); {grasp_s:.1f} s; peak memory allocated "
          f"{grasp_peak:.2f} GiB", flush=True)
    del scores, gr, small, small_t, model, batch, data, targets
    torch.cuda.empty_cache()

    # ---- the train CLI: global, -c, GMP; then predict
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    results = {"global": paths["results"] + "_dsff_global",
               "gmp": paths["results"] + "_dsff_gmp"}
    runs = []
    real_init, real_validate = Trainer.initialize, Trainer.validate
    real_load = Trainer.load_checkpoint_file

    def init_spy(self, training=True):
        real_init(self, training)
        self.save_every = 1
        run = {"trainer": self, "grad_steps": 0, "ratios": [],
               "loaded": None, "steps": 0}
        runs.append(run)
        per_t = kernel_launches_per_train_step(self.network)
        want_t = {k: per_t["forward"].get(k, 0)
                  + per_t["backward"].get(k, 0) for k in ops}
        step_fn_t, grad_fn = self.train_step, self._dsff_grad_step
        update_fn = self.mask_update
        cfg = self.dsff_config
        prev = [1.01]

        def step(st, d, t, lr, *extras):
            before = counts()
            res = step_fn_t(st, d, t, lr, *extras)
            check(d_counts(before) == want_t, f"[dsff] cli step "
                  f"{st.step}: launches {d_counts(before)}")
            run["steps"] += 1
            return res

        def grad(d, t):
            before = counts()
            g = grad_fn(d, t)
            check(d_counts(before) == want_t, f"[dsff] cli gradient "
                  f"step: launches {d_counts(before)}")
            run["grad_steps"] += 1
            return g

        def update(st, death_rate, grads=None, regrow_ratio=1.0):
            tw = float(sum(m.numel() for m in st.masks.values()))
            tn = float(sum(int(m.sum()) for m in st.masks.values()))
            host = dsff.grow_schedule_ratio(
                st.step, cfg.update_frequency, self.num_batches_per_epoch,
                cfg.density, cfg.final_density, death_rate, tw, tn, tn / tw,
                prev[0], cfg.init_prune_epoch, cfg.final_prune_epoch)
            check(host == regrow_ratio, f"[dsff] cli update at step "
                  f"{st.step}: regrow_ratio {regrow_ratio} != the host's "
                  f"{host}")
            prev[0] = host
            run["ratios"].append(host)
            st = update_fn(st, death_rate, grads, regrow_ratio)
            assert_dead_zero("[dsff] cli update", st)
            return st
        self.train_step = step
        if grad_fn is not None:
            self._dsff_grad_step = grad
        if cfg.prune_mode == "global":
            self.mask_update = update

    def load_spy(self, which, train=True):
        real_load(self, which, train)
        runs[-1]["loaded"] = (
            {n: m.cpu().clone() for n, m in self.state.masks.items()},
            {n: m.cpu().clone() for n, m in self.fired_masks.items()})

    base_args = ["--task", TRAIN_TASK, "--fold", "0", "--batches", "4",
                 "--val_batches", "1", "--sparse", "True", "--density",
                 str(DSFF_DENSITY)]
    global_args = base_args + ["--sparse_init", "ERK", "--prune_mode",
                               "global", "--growth", "gradient",
                               "--update_frequency", "2", "--final_density",
                               str(DSFF_FINAL_DENSITY),
                               "--final-prune-epoch", "2"]
    Trainer.initialize, Trainer.validate = init_spy, lambda s, *a, **k: None
    Trainer.load_checkpoint_file = load_spy
    walls = []
    try:
        os.environ["RESULTS_FOLDER"] = results["global"]
        for extra in (["--epochs", "1"], ["--epochs", "2", "-c"]):
            t0 = time.perf_counter()
            tcli.main(global_args + extra)
            walls.append(time.perf_counter() - t0)
            if extra[-1] != "-c":
                first = runs[-1]["trainer"]
                latest = ckpt.load_checkpoint(first.checkpoint_path("latest"))
                live = ({n: m.cpu() for n, m in first.state.masks.items()},
                        {n: m.cpu() for n, m in first.fired_masks.items()})
        os.environ["RESULTS_FOLDER"] = results["gmp"]
        t0 = time.perf_counter()
        tcli.main(base_args + ["--epochs", "2", "--sparse_init", "GMP",
                               "--init-prune-epoch", "0",
                               "--final-prune-epoch", "2"])
        walls.append(time.perf_counter() - t0)
    finally:
        Trainer.initialize, Trainer.validate = real_init, real_validate
        Trainer.load_checkpoint_file = real_load
    check(len(runs) == 3, f"[dsff] cli: {len(runs)} trainers")
    g1, g2, gm = (r["trainer"] for r in runs)
    check(runs[0]["steps"] == 4 and runs[1]["steps"] == 4
          and runs[0]["grad_steps"] == runs[1]["grad_steps"] == 2,
          f"[dsff] cli: steps / gradient steps "
          f"{[(r['steps'], r['grad_steps']) for r in runs]}")
    # the logged ratios are the host's
    for run in runs[:2]:
        log = open(run["trainer"].logger.log_file).read()
        logged = [float(v) for v in re.findall(r"regrow_ratio=(-?[0-9.]+)",
                                               log)]
        check(logged == [round(r, 4) for r in run["ratios"]]
              and len(logged) == 2, f"[dsff] cli: logged regrow_ratio "
              f"{logged}, the host's {run['ratios']}")
    # 'latest' in the flax layout, back equal to the bit
    state, _, meta = latest
    model_t = g1.network
    params_t = dict(model_t.named_parameters())
    for what, saved, sep, got in (
            ("masks", state["masks"], "|", live[0]),
            ("fired masks", meta["fired_masks"], "/", live[1])):
        for n, m in got.items():
            flax = saved[n.replace(".", sep)]
            check(flax.ndim == params_t[n].dim() and flax.shape == tuple(
                params_t[n].shape[i] for i in {4: (2, 3, 1, 0),
                                               5: (2, 3, 4, 0, 1)}[flax.ndim]),
                f"[dsff] cli: 'latest' {what} {n} of shape {flax.shape}")
        back = masks_for_model(saved, model_t, what, sep=sep)
        for n, m in got.items():
            check(np.array_equal(back[n], m.numpy()), f"[dsff] cli: "
                  f"'latest' {what} {n} differs from the run's")
    loaded_m, loaded_f = runs[1]["loaded"]
    for n in live[0]:
        check(torch.equal(loaded_m[n], live[0][n]) and torch.equal(
            loaded_f[n], live[1][n]), f"[dsff] cli -c: {n} differs from "
            f"'latest'")
    gmp_log = open(gm.logger.log_file).read()
    gmp_dens = [float(v) for v in re.findall(
        r"GMP prune at epoch \d+: density=([0-9.]+)", gmp_log)]
    check(len(gmp_dens) == 2 and gmp_dens[1] < gmp_dens[0],
          f"[dsff] cli GMP: densities {gmp_dens}")
    check("DSFF update" not in gmp_log, "[dsff] cli GMP: a DSFF update ran")
    losses = g1.all_tr_losses + g2.all_tr_losses + gm.all_tr_losses
    check(all(np.isfinite(losses)), f"[dsff] cli: epoch losses {losses}")
    print(f"[dsff] cli.train --sparse_init ERK --prune_mode global --growth "
          f"gradient --update_frequency 2: 4 steps, then -c 4 more; "
          f"regrow_ratio {runs[0]['ratios']} then {runs[1]['ratios']} (the "
          f"latch restarts at 1.01 on -c, as the reference's), each equal "
          f"to the host's and to the log; density "
          f"{masks_density(g2.state.masks, g2.network):.4f}; 'latest' "
          f"element masks and fired masks in the flax layout, back equal "
          f"to the bit; {walls[0]:.1f} s + {walls[1]:.1f} s", flush=True)
    print(f"[dsff] cli.train --sparse_init GMP --init-prune-epoch 0 "
          f"--final-prune-epoch 2: 2 epochs, GMP densities {gmp_dens}, "
          f"epoch losses {gm.all_tr_losses}; {walls[2]:.1f} s", flush=True)
    del runs, g1, g2, gm, model_t, params_t, latest, live
    torch.cuda.empty_cache()

    # ---- cli.predict with the global run's fold: dense masked
    os.environ["RESULTS_FOLDER"] = results["global"]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dsff_")
    inp = os.path.join(tmp.name, "in")
    os.makedirs(inp)
    case = TRAIN_VAL[0]
    os.symlink(os.path.join(paths["images"], f"{case}_0000.nii.gz"),
               os.path.join(inp, f"{case}_0000.nii.gz"))
    seen = []
    real_case = predictor.predict_case

    def spy(bundle, d, *a, **k):
        before = counts()
        out = real_case(bundle, d, *a, **k)
        padded, _ = pad_volume_to_patch(d, bundle.patch_size)
        steps = compute_steps_for_sliding_window(bundle.patch_size,
                                                 padded.shape[1:], 0.5)
        seen.append((bundle.sparse_plan, d_counts(before),
                     int(np.prod([len(s) for s in steps])),
                     TTA if k.get("do_tta", True) else 1,
                     kernel_launches_per_forward(bundle.fold_models[0])))
        return out
    predictor.predict_case = spy
    t0 = time.perf_counter()
    try:
        pcli.main(["-i", inp, "-o", os.path.join(tmp.name, "out"), "-t",
                   TRAIN_TASK, "-f", "0"])
    finally:
        predictor.predict_case = real_case
    check(len(seen) == 1, f"[dsff] predict: {len(seen)} cases")
    plan, got, tiles, passes, per_fwd = seen[0]
    want_p = {n: tiles * passes * per_fwd.get(n, 0) for n in got}
    check(plan is None, "[dsff] predict: element masks took the row plan")
    check(got == want_p, f"[dsff] predict: launches {got} != {want_p}")
    seg = read_nifti(os.path.join(tmp.name, "out", f"{case}.nii.gz")).array
    labels = np.unique(seg)
    check(seg.shape == TRAIN_CASES[case] and int(labels.min()) >= 0
          and int(labels.max()) < NUM_CLASSES, f"[dsff] predict: shape "
          f"{seg.shape}, labels {labels}")
    print(f"[dsff] cli.predict with the global run's fold on {case}: dense "
          f"masked (no plan), {tiles} tiles x {passes} passes, launches "
          f"{ {n: v for n, v in got.items() if v} }; labels "
          f"{labels.tolist()}; {time.perf_counter() - t0:.1f} s", flush=True)
    tmp.cleanup()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[dsff] ms per mask update (CUDA events; the gradient step "
          f"included where one runs): " + ", ".join(
              f"{k} {v:.1f}" for k, v in update_ms.items())
          + f"; peak memory allocated: the steps and updates "
          f"{steps_peak:.2f} GiB, GraSP and the CLI {peak:.2f} GiB; the phase "
          f"took {time.perf_counter() - t_phase:.1f} s  [{smi}]", flush=True)
    check("jax" not in sys.modules, "[dsff] jax was imported")


# the [2d] phase: a 2D plan of [trainer]'s raw task and shiftConvPP_noshift
TWOD_PLANNER = "ExperimentPlanner2D_v21"
TWOD_GRAD_BATCH = 8            # slices of the gradient check's batch


def twod_phase(rnd, R, ops, counts, smi, paths):
    """[2d] 2D plans and the shift off at the bench width (48 base
    features, 16 classes, bf16, one group of shift 0 at every kernel site):
    `python -m e2enet_tpu_torch.cli.plan_and_preprocess -t 501 -pl3d None
    -pl2d ExperimentPlanner2D_v21` on [trainer]'s raw task in a fresh
    process (exit code, wall seconds; the plan asserted to be depth 1 with
    (1, a, b) pools); the kernels against their plain versions at the
    plan's shapes (batch B of (1, H, W) slices): #1 at every level-0 and
    level-1 block (also all 8 mirror passes), #2 at the level-0 nest node
    and the level-1 one, #5 at stride (1, 2, 2) (also all 8 mirror
    passes), #6 at stride (1, 2, 2), #7 and #8 at window (1, 2, 2), #9 at
    the train batch, #10 at one slice, with the route each took; #3 and #4
    with the one-group table at the main path's shapes. One step's
    gradients of the 2D model on TWOD_GRAD_BATCH slices: the kernel path
    within 1.25x the bf16 plain path's error from a float32 plain run.
    cli/train.main --network 2d (kernel DSFF at 0.2, an update every 4
    steps, one epoch of 4 + 1 batches at the planned batch, then -c to a
    second), its launches per step, the loss falling, dead entries zero;
    cli/train.main --Tconv shiftConvPP_noshift on the 3D plan for 4 steps
    (the lazy route, #3 with the one-group table), none of them
    validating (fold 0 of [trainer]'s split); cli/predict.main -m 2d on
    one validation case in --mode fastest (launches tiles x passes x per
    forward, labels in [0, 16), the probabilities summing to 1) and
    one slice through the kernel path against float32. Prints ms per step,
    the host's wait per batch, s per epoch, the peak
    memory, the phase's seconds; returns the kernels' 2D results."""
    import os
    from pathlib import Path
    import torch
    from e2enet_tpu_torch.cli import predict as pcli
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.inference import predictor
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, ds_loss_weights, kernel_launches_per_forward)
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.fused_block import shift_groups
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, pad_volume_to_patch)
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()

    # ---- the 2D plan of the raw task, in a fresh process
    argv = ["-t", str(int(TRAIN_TASK[4:7])), "-pl3d", "None", "-pl2d",
            TWOD_PLANNER]
    env = dict(os.environ, nnUNet_raw_data_base=paths["raw"],
               nnUNet_preprocessed=paths["preprocessed"])
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "e2enet_tpu_torch.cli.plan_and_preprocess"]
        + argv, cwd=Path(__file__).resolve().parent, env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"[2d] the plan CLI exited {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
    pre = os.path.join(paths["preprocessed"], TRAIN_TASK)
    plans = Plans.load(os.path.join(pre, "nnUNetPlansv2.1_plans_2D.json"))
    st = plans.plans_per_stage[0]
    pools = [tuple(int(k) for k in p) for p in st.pool_op_kernel_sizes]
    B, (D1, H, W) = int(st.batch_size), (int(v) for v in st.patch_size)
    check(plans.num_stages == 1 and D1 == 1 and all(p[0] == 1 for p in pools)
          and pools[0] == (1, 2, 2) and len(pools) == 5,
          f"[2d] the 2D plan is patch {st.patch_size}, pools {pools}")
    print(f"[2d] python -m e2enet_tpu_torch.cli.plan_and_preprocess "
          f"{' '.join(argv)}: exit 0, {wall:.2f} s wall; plan: patch "
          f"{st.patch_size}, pools {pools}, batch {B}  [{smi}]", flush=True)

    # ---- the kernels at the 2D plan's shapes, one group of shift 0
    out = {}
    H1, W1 = H // 2, W // 2
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    with torch.inference_mode():
        print(f"[2d] kernels vs plain at the 2D plan's shapes (N = {B} "
              f"slices of 1 x {H} x {W}), one group of shift 0", flush=True)
        fused = [("2d_l0_c1_to48", B, 1, H, W, [1], [False], 48),
                 ("2d_l0_48_to48", B, 1, H, W, [48], [True], 48),
                 ("2d_l0_48+48_to48", B, 1, H, W, [48, 48], [True, False],
                  48),
                 ("2d_l1_96_to96", B, 1, H1, W1, [96], [True], 96),
                 ("2d_l1_96+96+48_to96", B, 1, H1, W1, [96, 96, 48],
                  [True, False, False], 96)]
        r1 = {c[0]: fused_case(*c, rnd=rnd, reps=R,
                               groups=shift_groups(sum(c[5]), False))
              for c in fused}
        errs = [fused_case("2d_flips", B, 1, H, W, [48, 48], [True, False],
                           48, rnd=rnd, reps=0, flips=f,
                           groups=shift_groups(96, False))["max_abs_err"]
                for f in FLIPS]
        out["fused_shift_conv_block"] = dict(
            max_abs_err=max([r["max_abs_err"] for r in r1.values()] + errs),
            shapes={n: {k: r[k] for k in keys} for n, r in r1.items()})
        r5 = strided_case("2d_l0_to_l1_48_to96", B, 1, H, W, 48, 96, rnd, R,
                          stride=(1, 2, 2), groups=shift_groups(48, False))
        errs = [strided_case("2d_flips", B, 1, H, W, 48, 96, rnd, 0, f,
                             (1, 2, 2), shift_groups(48, False))[
                                 "max_abs_err"] for f in FLIPS]
        out["strided_fused"] = dict(
            {k: r5[k] for k in keys},
            max_abs_err=max([r5["max_abs_err"]] + errs))
        r6 = uplink_case("2d_l1_to_l0_96_to48", B, 1, H1, W1, 96, 48, rnd,
                         R, route=None, stride=(1, 2, 2))
        out["uplink"] = {k: r6[k] for k in keys + ("max_abs_err",
                                                   "kernel_route")}
        r7 = downlink_case("2d_l0_to_l1_48", B, 1, H, W, 48, rnd, R,
                           window=(1, 2, 2))
        out["downlink"] = {k: r7[k] for k in keys + ("max_abs_err",)}
        r9 = seghead_case("2d_l0_logits_48_to16", B, 1, H, W, 48, 16, False,
                          rnd, R, route=None)
        r10 = seghead_case("2d_l0_probs_48_to16", 1, 1, H, W, 48, 16, True,
                           rnd, R, route=None)
        out["seghead"] = dict(
            {k: r10[k] for k in keys + ("kernel_route",)},
            max_abs_err=max(r9["max_abs_err"], r10["max_abs_err"]),
            logits={k: r9[k] for k in keys + ("kernel_route",)})
        print("[2d] the lazy up-link block (#3) with the one-group table at "
              "the main path's shapes", flush=True)
        r3 = lazy_case("l0_48+up96to48_to48_one_group", 1, 64, 64, 64, [48],
                       [True], 96, 48, 48, rnd, R,
                       groups=shift_groups(96, False))
        out["lazy_up_fused_block"] = {k: r3[k] for k in
                                      keys + ("max_abs_err",)}
    print("[2d] the block backward (#2 at the 2D shapes, #4 with the "
          "one-group table at the main path's) and #8 at window (1, 2, 2)",
          flush=True)
    r2 = {c[0]: block_bwd_case(*c, rnd=rnd, reps=R,
                               groups=shift_groups(sum(c[5]), False))
          for c in [("2d_l0_48+u48_to48", B, 1, H, W, [48, 48],
                     [True, False], 48),
                    ("2d_l1_96+96+48_to96", B, 1, H1, W1, [96, 96, 48],
                     [True, False, False], 96),
                    ("l0_48+u48_to48_one_group", 2, 128, 128, 128, [48, 48],
                     [True, False], 48)]}
    out["fused_shift_conv_block_bwd"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in r2.values()),
        shapes={n: {k: r[k] for k in keys} for n, r in r2.items()})
    r8 = downlink_bwd_case("2d_l0_to_l1_48", B, 1, H, W, 48, rnd, R,
                           window=(1, 2, 2))
    out["downlink_bwd"] = {k: r8[k] for k in keys + ("max_abs_err",
                                                     "kernel_route")}
    print(f"[2d] routes: up-link {r6['kernel_route']}, seg head logits "
          f"(N = {B}) {r9['kernel_route']}, probs (N = 1) "
          f"{r10['kernel_route']}, down-link backward {r8['kernel_route']}",
          flush=True)
    torch.cuda.empty_cache()

    # ---- one step's gradients of the 2D model: kernel path, bf16 plain
    # path, float32 plain run
    def model_2d(dtype):
        m = ShiftUNetPlusPlus(1, NUM_CLASSES, pools, base_num_features=48,
                              compute_dtype=dtype, do_shift=False,
                              device="cuda")
        m.reset_parameters(seed=0)
        return m
    model = model_2d(torch.bfloat16)
    n_out = model.num_ds_outputs()
    v, ts = tbm.make_batch(np.random.RandomState(6), TWOD_GRAD_BATCH,
                           (1, H, W), NUM_CLASSES,
                           tbm.ds_factors(pools, n_out))
    data = torch.from_numpy(v).cuda()
    targets = [torch.from_numpy(t).cuda() for t in ts]
    weights = ds_loss_weights(len(pools), n_out)

    g_k = loss_grads(model, data, targets, weights, batch_dice=False)
    with blocks.plain_ops():
        g_p = loss_grads(model, data, targets, weights, batch_dice=False)
        g_32 = loss_grads(model_2d(torch.float32), data, targets, weights,
                          batch_dice=False)
    e_k = float((g_k - g_32).norm() / g_32.norm())
    e_p = float((g_p - g_32).norm() / g_32.norm())
    print(f"[2d] one step's gradients on {TWOD_GRAD_BATCH} x 1 x {H} x {W}, "
          f"against a float32 plain run: kernel path rel L2 err {e_k:.4e}, "
          f"bf16 plain path {e_p:.4e}", flush=True)
    check(e_k <= ERR_RATIO * e_p, "[2d] kernel-path gradients further from "
          "the float32 run than the bf16 plain path's")
    del model, g_k, g_p, g_32
    torch.cuda.empty_cache()

    # ---- cli.train --network 2d, then -c; then --Tconv
    # shiftConvPP_noshift on the 3D plan. No run validates: a 2D validation
    # predicts each case slice by slice, 319 tiles x 8 passes of ~160^3
    # (70-120 s on the card), its export, scoring and postprocessing are
    # [trainer]'s, and cli.predict -m 2d below runs the 2D tile loop
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"]
    runs = []
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    Trainer.initialize, Trainer.load_checkpoint_file = trainer_spies(
        "2d", ops, counts, runs, validate_runs=())
    args = ["--task", TRAIN_TASK, "--fold", "0", "--network", "2d",
            "--batches", "4", "--val_batches", "1", "--sparse", "True",
            "--density", "0.2", "--update_frequency", "4"]
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for extra in (["--epochs", "1"], ["--epochs", "2", "-c"]):
            t0 = time.perf_counter()
            tcli.main(args + extra)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        tcli.main(["--task", TRAIN_TASK, "--fold", "0", "--Tconv",
                   "shiftConvPP_noshift", "--epochs", "1", "--batches", "4",
                   "--val_batches", "1"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
    check(len(runs) == 3, f"[2d] {len(runs)} trainers")
    check(runs[1]["loaded"] is not None and runs[1]["loaded"][0] == "latest"
          and runs[1]["loaded"][1] == 1, "[2d] -c did not load 'latest' of "
          "epoch 1")
    for i, run in enumerate(runs):
        tr = run["trainer"]
        check(not tr.network.do_shift, f"[2d] run {i + 1} shifts")
        losses = [float(v) for v in run["losses"]]
        ms = [a.elapsed_time(b) for a, b in run["events"]]
        check(all(np.isfinite(losses)) and all(
            np.isfinite(tr.all_tr_losses + tr.all_val_losses)),
            f"[2d] run {i + 1}: a loss is not finite")
        waits, epochs = run["waits"], [b - a for a, b in run["epochs"]]
        print(f"[2d] run {i + 1} ({tr.tconv}, patch "
              f"{[int(v) for v in tr.patch_size]}, batch {tr.batch_size}, "
              f"batch dice {tr.batch_dice}): {len(losses)} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; {run['updates']} "
              f"mask updates; launches per step {run['want']}", flush=True)
        print(f"[2d] run {i + 1}: ms per step (CUDA events) "
              f"{' '.join(f'{v:.1f}' for v in ms)}; steps after the first: "
              f"median {float(np.median(ms[1:])):.1f}; host wait per batch "
              f"in next(tr_gen) (s) {' '.join(f'{v:.3f}' for v in waits)}; "
              f"s per epoch {' '.join(f'{v:.2f}' for v in epochs)}; "
              f"{validation_text(tr, run)}; cli.main {walls[i]:.1f} s  "
              f"[{smi}]", flush=True)
    second = runs[1]["trainer"]
    n_steps = len(runs[0]["losses"]) + len(runs[1]["losses"])
    check(runs[0]["updates"] + runs[1]["updates"] == n_steps // 4, "[2d] "
          f"{runs[0]['updates']} + {runs[1]['updates']} mask updates in "
          f"{n_steps} steps")
    check(second.epoch == 2 and second.all_tr_losses[0]
          > second.all_tr_losses[-1], f"[2d] epoch train losses "
          f"{second.all_tr_losses}: the first not above the last")
    check(runs[2]["trainer"].network.lazy_up_route(),
          "[2d] shiftConvPP_noshift on the 3D plan left the lazy route")
    print(f"[2d] peak memory allocated over the 2D runs {peak:.2f} GiB",
          flush=True)
    fold = second.output_folder
    check(os.path.basename(os.path.dirname(os.path.dirname(os.path.dirname(
        fold)))) == "2d", f"[2d] the fold is under {fold}")
    per_fwd = kernel_launches_per_forward(second.network)
    del runs, second
    torch.cuda.empty_cache()

    # ---- cli.predict -m 2d, one validation case, fastest mode
    inp = os.path.join(paths["results"], "2d_predict_in")
    os.makedirs(inp)
    case = TRAIN_VAL[0]
    os.symlink(os.path.join(paths["images"], f"{case}_0000.nii.gz"),
               os.path.join(inp, f"{case}_0000.nii.gz"))
    real_case = predictor.predict_case
    got = {}

    def spy(bundle, d, *a, **k):
        before = counts()
        p = real_case(bundle, d, *a, **k)
        torch.cuda.synchronize()
        padded, _ = pad_volume_to_patch(d, bundle.patch_size)
        steps = compute_steps_for_sliding_window(bundle.patch_size,
                                                 padded.shape[1:], 0.5)
        got.update(launches={n: v - before[n] for n, v in counts().items()},
                   tiles=int(np.prod([len(s) for s in steps])),
                   passes=TTA if k.get("do_tta", True) else 1,
                   sums=np.asarray(p, np.float32).sum(0), bundle=bundle,
                   data=d)
        return p
    predictor.predict_case = spy
    t0 = time.perf_counter()
    try:
        pcli.main(["-i", inp, "-o", os.path.join(paths["results"],
                                                 "2d_predict_out"),
                   "-t", TRAIN_TASK, "-m", "2d", "-f", "0", "--mode",
                   "fastest"])
    finally:
        predictor.predict_case = real_case
    pred_s = time.perf_counter() - t0
    seg = read_nifti(os.path.join(paths["results"], "2d_predict_out",
                                  f"{case}.nii.gz")).array
    labels = np.unique(seg)
    check(seg.shape == TRAIN_CASES[case] and int(labels.min()) >= 0
          and int(labels.max()) < NUM_CLASSES, f"[2d] predict: shape "
          f"{seg.shape}, labels {labels}")
    want = {n: got["tiles"] * got["passes"] * v for n, v in per_fwd.items()}
    have = {n: got["launches"][n] for n in per_fwd}
    check(have == want and all(got["launches"][n] == 0 for n in
                               got["launches"] if n not in per_fwd),
          f"[2d] predict: launches {got['launches']} != {want}")
    s_dev = float(np.abs(got["sums"] - 1.0).max())
    check(s_dev <= PROB_SUM_ATOL, f"[2d] predict: probs sum off by {s_dev}")
    print(f"[2d] cli.predict -m 2d --mode fastest on {case}: shape "
          f"{seg.shape}, labels {labels.tolist()[:4]}...{int(labels.max())}, "
          f"{got['tiles']} tiles x {got['passes']} pass, launches {have}, "
          f"max |sum_k p - 1| {s_dev:.2e}, {pred_s:.1f} s", flush=True)

    # one slice of the case through the trained fold: kernel path and bf16
    # plain path against a float32 plain run
    net = got["bundle"].fold_models[0]
    net.head_probs_dtype = None
    z = got["data"].shape[1] // 2
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        got["data"][:, z:z + 1, :H, :W], 0, -1)))[None].float().cuda()
    net32 = ShiftUNetPlusPlus(1, NUM_CLASSES, pools, base_num_features=48,
                              compute_dtype=torch.float32, do_shift=False,
                              device="cuda")
    net32.load_state_dict(net.state_dict())
    with torch.inference_mode():
        lk = net(x, do_ds=False).float()
        with blocks.plain_ops():
            lp = net(x, do_ds=False).float()
            l32 = net32(x, do_ds=False)
    check(bool(torch.isfinite(lk).all()), "[2d] non-finite logits")
    e = {n: (float((lg - l32).abs().mean()),
             float((lg.argmax(-1) == l32.argmax(-1)).float().mean()))
         for n, lg in (("kernel", lk), ("plain", lp))}
    print(f"[2d] one 1 x {H} x {W} slice of {case} through the trained fold, "
          f"against float32: kernel path mean |dlogit| {e['kernel'][0]:.4e}, "
          f"argmax agreement {e['kernel'][1]:.6f}; bf16 plain path "
          f"{e['plain'][0]:.4e}, {e['plain'][1]:.6f}", flush=True)
    check(e["kernel"][0] <= ERR_RATIO * e["plain"][0]
          and e["kernel"][1] >= e["plain"][1] - AGREE_SLACK,
          "[2d] the kernel path's slice further from float32 than the "
          "plain path's")
    del net, net32, got
    torch.cuda.empty_cache()
    check("jax" not in sys.modules, "[2d] jax was imported")
    print(f"[2d] phase {time.perf_counter() - t_phase:.1f} s  [{smi}]",
          flush=True)
    return out


# the [cascade] phase: 3d_lowres -> 3d_cascade_fullres on [trainer]'s cases
CASCADE_TASK = "Task502_ChipSmokeCascade"
CASCADE_LOWRES_SPACING = 1.25
CASCADE_DEVICE = "cuda"
CASCADE_PP_WORKERS = 6
# three of [trainer]'s six cases (the planned predict case among them):
# predict_next_stage and the cascade fold's validation cost ~10 and ~15 s
# per case, most of it on the host (its softmax resampled to stage 1's
# shape); a fourth case took the whole script past 1090 s on a slow host
CASCADE_CASES = ("case_000", "case_001", TRAIN_VAL[0])
# the lowres run takes [trainer]'s 18 steps (3 epochs of 6 batches): after
# 4 its argmax is speckle, thousands of components per label, and the
# cascade's augmentation (a connected-component removal that counts each
# component over the patch) then kept the card waiting 1.2-74 s per batch
CASCADE_LOWRES_RUN = ["--epochs", "3", "--batches", "6"]
CASCADE_FULLRES_RUN = ["--epochs", "1", "--batches", "4"]


def cascade_task(paths, smi):
    """[cascade]'s task on CASCADE_CASES: [trainer]'s 3D plan as stage 1,
    those cases' preprocessed files linked in (the same spacing: the
    preprocessor would write them again), and a stage 0 at
    CASCADE_LOWRES_SPACING from the port's
    ExperimentPlanner3D_v21.get_properties_for_stage over [trainer]'s
    median (of its six cases), preprocessed from those cases' cropped
    files by the port's preprocessor (tests/test_cascade.py's way of
    building a second stage). Checks the two stages' geometries. Returns
    the task folder."""
    import os
    from e2enet_tpu_torch.planning.planner import ExperimentPlanner3D_v21
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.utils.registry import PREPROCESSORS
    t0 = time.perf_counter()
    src = os.path.join(paths["preprocessed"], TRAIN_TASK)
    pre = os.path.join(paths["preprocessed"], CASCADE_TASK)
    cropped = os.path.join(paths["raw"], "nnUNet_cropped_data", TRAIN_TASK)
    name = "nnUNetPlansv2.1_plans_3D.json"
    plans = Plans.load(os.path.join(src, name))
    full = plans.plans_per_stage[0]
    low = ExperimentPlanner3D_v21(cropped, pre).get_properties_for_stage(
        np.array([CASCADE_LOWRES_SPACING] * 3),
        np.array(full.current_spacing, float),
        np.array(full.median_patient_size_in_voxels), len(TRAIN_CASES),
        plans.num_modalities, NUM_CLASSES)
    plans.plans_per_stage = {0: low, 1: full}
    plans.num_stages = 2
    plans.preprocessed_data_folder = pre
    stage = {i: os.path.join(pre, f"{plans.data_identifier}_stage{i}")
             for i in (0, 1)}
    os.makedirs(stage[1])
    plans.save(os.path.join(pre, name))
    src_stage = os.path.join(src, f"{plans.data_identifier}_stage0")
    for f in os.listdir(src_stage):
        if f.split(".")[0] in CASCADE_CASES:
            os.link(os.path.join(src_stage, f), os.path.join(stage[1], f))
    # the cropped cases of the task, beside the cropping's other files
    cropped_sub = os.path.join(pre, "cropped")
    os.makedirs(cropped_sub)
    for f in os.listdir(cropped):
        if not f.startswith("case_") or f.split(".")[0] in CASCADE_CASES:
            os.symlink(os.path.join(cropped, f), os.path.join(cropped_sub, f))
    for f in ("gt_segmentations", "dataset.json", "dataset_properties.pkl"):
        if os.path.exists(os.path.join(src, f)):
            os.symlink(os.path.join(src, f), os.path.join(pre, f))
    t1 = time.perf_counter()
    pp = PREPROCESSORS.get(plans.preprocessor_name)(
        plans.normalization_schemes, plans.use_mask_for_norm,
        plans.transpose_forward, plans.intensity_properties)
    pp.run([low.current_spacing], cropped_sub, pre, plans.data_identifier,
           CASCADE_PP_WORKERS)
    t2 = time.perf_counter()
    got = dict(stages=plans.num_stages,
               spacing=[list(map(float, s.current_spacing))
                        for s in (low, full)],
               median=[list(map(int, s.median_patient_size_in_voxels))
                       for s in (low, full)],
               patch=[list(map(int, s.patch_size)) for s in (low, full)],
               pools=[s.pool_op_kernel_sizes for s in (low, full)],
               batch=[int(s.batch_size) for s in (low, full)])
    want = dict(stages=2, spacing=[[CASCADE_LOWRES_SPACING] * 3,
                                   [1.0] * 3],
                median=[[128] * 3, got["median"][1]],
                patch=[list(PATCH)] * 2, pools=[[[2, 2, 2]] * 5] * 2,
                batch=[2, 2])
    check(got == want, f"[cascade] the two-stage plan {got}, not {want}")
    check(sorted(f[:-4] for f in os.listdir(stage[0]) if f.endswith(".npz"))
          == sorted(CASCADE_CASES), f"[cascade] stage 0 cases "
          f"{sorted(os.listdir(stage[0]))}")
    for case in CASCADE_CASES:
        d = np.load(os.path.join(stage[0], f"{case}.npz"))["data"]
        f = np.load(os.path.join(stage[1], f"{case}.npz"))["data"]
        check(all(round(b / CASCADE_LOWRES_SPACING) == a
                  for a, b in zip(d.shape[1:], f.shape[1:])),
              f"[cascade] {case}: stage 0 {d.shape} against stage 1 "
              f"{f.shape}")
    print(f"[cascade] task {CASCADE_TASK} on {len(CASCADE_CASES)} of "
          f"[trainer]'s cases: stage 1 [trainer]'s plan and "
          f"files (linked, {t1 - t0:.2f} s), stage 0 from "
          f"get_properties_for_stage at {CASCADE_LOWRES_SPACING} mm, "
          f"preprocessed by the port's preprocessor in {t2 - t1:.2f} s "
          f"({CASCADE_PP_WORKERS} workers); plan {got}  [{smi}]", flush=True)
    return pre


class _FirstBatches:
    """A batch generator that keeps its first batch's data in `seen`."""

    def __init__(self, gen, seen):
        self.gen, self.seen = gen, seen

    def __next__(self):
        batch = next(self.gen)
        if not self.seen:
            self.seen.append(np.array(batch["data"]))
        return batch

    def stop(self):
        self.gen.stop()


def cascade_phase(rnd, R, ops, counts, smi, paths):
    """[cascade] the 3d_lowres -> 3d_cascade_fullres cascade at the bench
    width (48 base features, 16 classes, bf16, kernel DSFF at 0.2): the
    cascade's level-0 kernel shapes against their plain versions (#1 at 16
    and 3 input channels, one modality and the one-hot labels of 16 and 3
    classes; the block backward there with no part wanted, the train
    step's, and with its part wanted; #9 and #10 at 3 classes), timed as
    the other rows; cascade_task; cli/train.main --network 3d_lowres
    --fold all (CASCADE_LOWRES_RUN, one validation batch an epoch, its
    fold's validation left out), its predict_next_stage writing a uint8
    segFromPrevStage file of the stage-1 shape with labels in [0, 16) for
    each of the task's cases; cli/train.main --network 3d_cascade_fullres
    --fold all (CASCADE_FULLRES_RUN, the validation over all its cases):
    16 input channels, launches per step those of the 3D step, a
    validation batch's one-hot channels 0/1 and at most one per voxel;
    one step's gradients of the trained cascade model on a 2 x 64^3 batch
    with one-hot channels against a float32 plain run (the 1.25x rule);
    cli/predict.main -m 3d_cascade_fullres -f all --mode fastest on one
    raw case (the _lowres folder written, the output's shape and labels,
    launches tiles x passes x per forward for each stage). Prints ms per
    step, the host's wait per batch, s per validation case, the peak
    memory, the phase's seconds; returns the kernels' cascade results."""
    import os
    import torch
    from e2enet_tpu_torch.cli import predict as pcli
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.inference import predictor
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, ds_loss_weights, kernel_launches_per_forward,
        kernel_launches_per_train_step)
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, pad_volume_to_patch)
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    dev = CASCADE_DEVICE

    # ---- the kernels at the cascade's level-0 shapes
    out = {}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    D, H, W = PATCH
    print("[cascade] kernels vs plain at the cascade's level-0 shapes: the "
          "first block over one modality and the one-hot labels of 16 and 3 "
          "classes", flush=True)
    with torch.inference_mode():
        r1 = {c[0]: fused_case(*c, rnd=rnd, reps=R) for c in
              [("cascade_l0_c16_to48", 1, D, H, W, [16], [False], 48),
               ("cascade_l0_c3_to48", 1, D, H, W, [3], [False], 48)]}
        errs = [fused_case(n, 2, D, H, W, [c], [False], 48, rnd=rnd,
                           reps=0)["max_abs_err"]
                for n, c in (("cascade_l0_c16_to48_n2", 16),
                             ("cascade_l0_c3_to48_n2", 3))]
        out["fused_shift_conv_block"] = dict(
            max_abs_err=max([r["max_abs_err"] for r in r1.values()] + errs),
            shapes={n: {k: r[k] for k in keys + ("mma_ms", "host_ms")}
                    for n, r in r1.items()})
        r9 = seghead_case("cascade_l0_logits_48_to3", 2, D, H, W, 48, 3,
                          False, rnd, R, route=None)
        r10 = seghead_case("cascade_l0_probs_48_to3", 1, D, H, W, 48, 3,
                           True, rnd, R, route=None)
        out["seghead"] = dict(
            {k: r10[k] for k in keys + ("kernel_route",)},
            max_abs_err=max(r9["max_abs_err"], r10["max_abs_err"]),
            logits={k: r9[k] for k in keys + ("kernel_route",)})
    r2 = {c[0]: block_bwd_case(*c, rnd=rnd, reps=R, want=[False]) for c in
          [("cascade_l0_c16_to48", 2, D, H, W, [16], [False], 48),
           ("cascade_l0_c3_to48", 2, D, H, W, [3], [False], 48)]}
    errs = [block_bwd_case(n, 2, D // 4, H, W, [c], [False], 48, rnd=rnd,
                           reps=0)["max_abs_err"]
            for n, c in (("cascade_l0_c16_to48_dgrad", 16),
                         ("cascade_l0_c3_to48_dgrad", 3))]
    out["fused_shift_conv_block_bwd"] = dict(
        max_abs_err=max([r["max_abs_err"] for r in r2.values()] + errs),
        shapes={n: {k: r[k] for k in keys} for n, r in r2.items()})
    print(f"[cascade] seg head at K = 3: logits (N = 2) route "
          f"{r9['kernel_route']}, probs (N = 1) {r10['kernel_route']}",
          flush=True)
    torch.cuda.empty_cache()

    # ---- the task, the lowres run, its predictions for stage 1
    pre = cascade_task(paths, smi)
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"]
    runs, seen, nxt = [], [], {}
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    # the lowres run's validation is left out (predict_next_stage predicts
    # every case through the same tile loop, and [trainer] validates a 3D
    # fold); the cascade run validates all the task's cases
    init_spy, load_spy = trainer_spies("cascade", ops, counts, runs,
                                       validate_runs={1})

    def init(self, training=True):
        init_spy(self, training)
        if training and self.cascade:
            self.val_gen = _FirstBatches(self.val_gen, seen)
    real_next = tcli.predict_next_stage

    def next_stage(trainer, folder, *a, **k):
        before = counts()
        t0 = time.perf_counter()
        real_next(trainer, folder, *a, **k)
        torch.cuda.synchronize()
        nxt.update(s=time.perf_counter() - t0, folder=folder,
                   launches={n: v - before[n] for n, v in counts().items()})
    args = ["--task", CASCADE_TASK, "--fold", "all", "--sparse", "True",
            "--density", "0.2", "--update_frequency", "4", "--val_batches",
            "1", "--device", dev]
    Trainer.initialize, Trainer.load_checkpoint_file = init, load_spy
    tcli.predict_next_stage = next_stage
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for extra in (["--network", "3d_lowres"] + CASCADE_LOWRES_RUN,
                      ["--network", "3d_cascade_fullres"]
                      + CASCADE_FULLRES_RUN):
            t0 = time.perf_counter()
            tcli.main(args + extra)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
        tcli.predict_next_stage = real_next
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(runs) == 2, f"[cascade] {len(runs)} trainers")
    low, casc = runs[0]["trainer"], runs[1]["trainer"]
    check(low.stage == 0 and not low.cascade and casc.stage == 1
          and casc.cascade, "[cascade] the stages or the cascade flags")
    check(len(casc.validation_timings) == len(CASCADE_CASES), "[cascade] "
          "the cascade run's validation did not cover every case")
    cin = [int(t.network.context0.block0.kernel.shape[1]) for t in (low,
                                                                   casc)]
    check(cin == [1, NUM_CLASSES], f"[cascade] input channels {cin}")
    # the cascade's step launches what the 3D step does: its input width
    # changes no kernel count
    ref = ShiftUNetPlusPlus(1, NUM_CLASSES, casc.network.pools,
                            base_num_features=48, device=dev)
    per_3d = kernel_launches_per_train_step(ref)
    del ref
    want3d = {k: per_3d["forward"].get(k, 0) + per_3d["backward"].get(k, 0)
              for k in ops}
    check(runs[1]["want"] == want3d, f"[cascade] launches per step "
          f"{runs[1]['want']}, the 3D step's {want3d}")
    for i, run in enumerate(runs):
        tr = run["trainer"]
        losses = [float(v) for v in run["losses"]]
        ms = [a.elapsed_time(b) for a, b in run["events"]]
        check(all(np.isfinite(losses)) and all(
            np.isfinite(tr.all_tr_losses + tr.all_val_losses)),
            f"[cascade] run {i + 1}: a loss is not finite")
        check(run["updates"] == len(losses) // 4, f"[cascade] run {i + 1}: "
              f"{run['updates']} mask updates in {len(losses)} steps")
        waits = run["waits"]
        print(f"[cascade] run {i + 1} (--network "
              f"{'3d_cascade_fullres' if tr.cascade else '3d_lowres'}, "
              f"stage {tr.stage}, patch {[int(v) for v in tr.patch_size]}, "
              f"{cin[i]} input channels): {len(losses)} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; {run['updates']} "
              f"mask updates; launches per step {run['want']}", flush=True)
        print(f"[cascade] run {i + 1}: ms per step (CUDA events) "
              f"{' '.join(f'{v:.1f}' for v in ms)}; steps after the first: "
              f"median {float(np.median(ms[1:])):.1f}; host wait per batch "
              f"in next(tr_gen) (s) {' '.join(f'{v:.3f}' for v in waits)}, "
              f"after the first: median {float(np.median(waits[1:])):.3f}, "
              f"mean {float(np.mean(waits[1:])):.3f}; "
              f"{validation_text(tr, run)}; cli.main {walls[i]:.1f} s  "
              f"[{smi}]", flush=True)

    # predict_next_stage: one file per case, at stage 1's shape
    stage1 = os.path.join(pre, "nnUNetData_plans_v2.1_stage1")
    check(os.path.realpath(nxt.get("folder", "")) == os.path.realpath(
        stage1), f"[cascade] predict_next_stage wrote to {nxt.get('folder')}")
    hist = np.zeros(NUM_CLASSES, np.int64)
    for case in CASCADE_CASES:
        seg = np.load(os.path.join(stage1, f"{case}_segFromPrevStage.npz"))[
            "data"]
        shape = np.load(os.path.join(stage1, f"{case}.npz"))["data"].shape
        check(seg.dtype == np.uint8 and seg.shape == shape[1:]
              and int(seg.max()) < NUM_CLASSES, f"[cascade] {case}: "
              f"segFromPrevStage {seg.dtype} {seg.shape} max {seg.max()}, "
              f"the stage-1 data {shape}")
        hist += np.bincount(seg.ravel(), minlength=NUM_CLASSES)
    per_fwd = kernel_launches_per_forward(low.network)
    tiles = 0
    for case in CASCADE_CASES:
        d = np.load(os.path.join(pre, "nnUNetData_plans_v2.1_stage0",
                                 f"{case}.npz"))["data"][:-1]
        padded, _ = pad_volume_to_patch(d, low.patch_size)
        tiles += int(np.prod([len(s) for s in compute_steps_for_sliding_window(
            low.patch_size, padded.shape[1:], 0.5)]))
    want = {n: tiles * TTA * v for n, v in per_fwd.items()}
    check({n: nxt["launches"][n] for n in per_fwd} == want,
          f"[cascade] predict_next_stage launches {nxt['launches']} != "
          f"{want}")
    print(f"[cascade] predict_next_stage: {len(CASCADE_CASES)} "
          f"segFromPrevStage files in stage 1 (uint8, the stage-1 shapes) in "
          f"{nxt['s']:.1f} s, {tiles} tiles x {TTA} passes, launches "
          f"{want}; label voxel shares "
          f"{np.round(hist / hist.sum(), 4).tolist()}", flush=True)

    # a validation batch's one-hot channels
    check(len(seen) == 1, "[cascade] no validation batch seen")
    oh = seen[0][:, 1:]
    check(oh.shape[1] == NUM_CLASSES - 1 and bool(np.isin(oh, (0.0, 1.0))
                                                  .all())
          and float(oh.sum(1).max()) <= 1.0, f"[cascade] the validation "
          f"batch's one-hot channels: shape {oh.shape}, values "
          f"{np.unique(oh)[:4]}, max sum {float(oh.sum(1).max())}")
    print(f"[cascade] a validation batch {seen[0].shape}: its "
          f"{oh.shape[1]} one-hot channels 0/1, at most one per voxel "
          f"(share labelled {float(oh.sum(1).mean()):.4f}); peak memory "
          f"allocated over both runs {peak:.2f} GiB", flush=True)

    # ---- one step's gradients of the trained cascade model
    net = casc.network
    pools = net.pools
    n_out = net.num_ds_outputs()
    v, ts = tbm.make_batch(np.random.RandomState(8), 2, GRAD_PATCH,
                           NUM_CLASSES, tbm.ds_factors(pools, n_out))
    # the previous stage's labels: the target, one voxel off on each axis
    prev = np.roll(ts[0], 1, axis=(1, 2, 3))
    onehot = (prev[..., None] == np.arange(1, NUM_CLASSES)).astype(np.float32)
    data = torch.from_numpy(np.concatenate([v, onehot], -1)).to(dev)
    targets = [torch.from_numpy(t).to(dev) for t in ts]
    weights = ds_loss_weights(len(pools), n_out)
    g_k = loss_grads(net, data, targets, weights)
    with blocks.plain_ops():
        g_p = loss_grads(net, data, targets, weights)
        net32 = ShiftUNetPlusPlus(NUM_CLASSES, NUM_CLASSES, pools,
                                  base_num_features=48,
                                  compute_dtype=torch.float32, device=dev)
        net32.load_state_dict(net.state_dict())
        g_32 = loss_grads(net32, data, targets, weights)
    e_k = float((g_k - g_32).norm() / g_32.norm())
    e_p = float((g_p - g_32).norm() / g_32.norm())
    print(f"[cascade] one step's gradients of the trained cascade model on 2 "
          f"x {GRAD_PATCH[0]}^3 x {NUM_CLASSES} channels, against a float32 "
          f"plain run: kernel path rel L2 err {e_k:.4e}, bf16 plain path "
          f"{e_p:.4e}", flush=True)
    check(e_k <= ERR_RATIO * e_p, "[cascade] kernel-path gradients further "
          "from the float32 run than the bf16 plain path's")
    del runs, low, casc, net, net32, g_k, g_p, g_32, data, targets
    torch.cuda.empty_cache()

    # ---- cli.predict -m 3d_cascade_fullres, one raw case, fastest mode
    inp = os.path.join(paths["results"], "cascade_predict_in")
    os.makedirs(inp)
    case = TRAIN_VAL[0]
    os.symlink(os.path.join(paths["images"], f"{case}_0000.nii.gz"),
               os.path.join(inp, f"{case}_0000.nii.gz"))
    out_dir = os.path.join(paths["results"], "cascade_predict_out")
    real_case = predictor.predict_case
    calls = []

    def spy(bundle, d, *a, **k):
        before = counts()
        p = real_case(bundle, d, *a, **k)
        torch.cuda.synchronize()
        padded, _ = pad_volume_to_patch(d, bundle.patch_size)
        steps = compute_steps_for_sliding_window(bundle.patch_size,
                                                 padded.shape[1:], 0.5)
        calls.append(dict(
            launches={n: v - before[n] for n, v in counts().items()},
            tiles=int(np.prod([len(s) for s in steps])),
            passes=TTA if k.get("do_tta", True) else 1, shape=d.shape,
            per_fwd=kernel_launches_per_forward(bundle.fold_models[0])))
        return p
    predictor.predict_case = spy
    t0 = time.perf_counter()
    try:
        pcli.main(["-i", inp, "-o", out_dir, "-t", CASCADE_TASK, "-m",
                   "3d_cascade_fullres", "-f", "all", "--mode", "fastest",
                   "--device", dev])
    finally:
        predictor.predict_case = real_case
    pred_s = time.perf_counter() - t0
    check(len(calls) == 2, f"[cascade] predict: {len(calls)} predict_case "
          f"calls, not the lowres stage's and the cascade's")
    for tag, c in zip(("lowres", "cascade"), calls):
        want = {n: c["tiles"] * c["passes"] * v
                for n, v in c["per_fwd"].items()}
        have = {n: c["launches"][n] for n in want}
        check(have == want and all(c["launches"][n] == 0 for n in
                                   c["launches"] if n not in want),
              f"[cascade] predict, {tag} stage: launches {c['launches']} "
              f"!= {want}")
        print(f"[cascade] predict, {tag} stage: network input "
              f"{tuple(c['shape'])}, {c['tiles']} tiles x {c['passes']} "
              f"passes, launches {have}", flush=True)
    check(calls[1]["shape"][0] == NUM_CLASSES, "[cascade] predict: the "
          "cascade stage's input is not 16 channels")
    for folder in (out_dir + "_lowres", out_dir):
        seg = read_nifti(os.path.join(folder, f"{case}.nii.gz")).array
        labels = np.unique(seg)
        check(seg.shape == TRAIN_CASES[case] and int(labels.min()) >= 0
              and int(labels.max()) < NUM_CLASSES, f"[cascade] predict: "
              f"{folder}: shape {seg.shape}, labels {labels}")
    print(f"[cascade] cli.predict -m 3d_cascade_fullres -f all --mode "
          f"fastest (the lowres stage in the fast mode, as the CLI runs it) "
          f"on {case}: the _lowres folder and the output of shape "
          f"{seg.shape}, labels {labels.tolist()[:4]}...{int(labels.max())}; "
          f"{pred_s:.1f} s", flush=True)
    check("jax" not in sys.modules, "[cascade] jax was imported")
    print(f"[cascade] phase {time.perf_counter() - t_phase:.1f} s  [{smi}]",
          flush=True)
    return out


REGIONS_TASK = "Task503_ChipSmokeRegions"
REGIONS_CASES = {"case_000": (136, 160, 136), "case_001": (140, 156, 136),
                 "case_002": (132, 164, 140), "case_003": (136, 160, 132)}
REGIONS_VAL = ("case_003",)
REGIONS_MODALITIES = ("t1", "t1ce", "t2", "flair")
# the BraTS labels: background, then three nested tumour labels
REGIONS_LABELS = 4
BRATS = ((1, 2, 3), (2, 3), (3,))
VARIANTS_DEVICE = "cuda"
VARIANTS_REGION_RUN = ["--epochs", "2", "--batches", "3"]
VARIANTS_STEP_RUN = ["--epochs", "1", "--batches", "4"]


def regions_task(paths, smi):
    """[variants]' BraTS-like task: REGIONS_CASES written as a raw task
    (write_raw_task: four MR modalities, labels 0-3, 1 mm) beside
    [trainer]'s and planned by `python -m
    e2enet_tpu_torch.cli.plan_and_preprocess -t 503` in a fresh process;
    the plan asserted to be one stage of PATCH, 5 x (2, 2, 2) pools, batch
    2, four modalities z-scored (nonCT); splits_final.pkl with
    REGIONS_VAL as fold 0's validation. Returns the preprocessed task
    folder."""
    import os
    from pathlib import Path
    from e2enet_tpu_torch.plans import Plans
    t0 = time.perf_counter()
    write_raw_task(paths["raw"], REGIONS_TASK, REGIONS_CASES,
                   REGIONS_LABELS, seed=3, modalities=REGIONS_MODALITIES)
    t1 = time.perf_counter()
    env = dict(os.environ, nnUNet_raw_data_base=paths["raw"],
               nnUNet_preprocessed=paths["preprocessed"])
    r = subprocess.run(
        [sys.executable, "-m", "e2enet_tpu_torch.cli.plan_and_preprocess",
         "-t", str(int(REGIONS_TASK[4:7]))],
        cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
        text=True, timeout=600)
    t2 = time.perf_counter()
    check(r.returncode == 0, f"[variants] the plan CLI exited "
          f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
    pre = os.path.join(paths["preprocessed"], REGIONS_TASK)
    plans = Plans.load(os.path.join(pre, "nnUNetPlansv2.1_plans_3D.json"))
    st = plans.plans_per_stage[0]
    got = dict(stages=plans.num_stages, patch=st.patch_size,
               pools=st.pool_op_kernel_sizes, batch=st.batch_size,
               modalities=plans.num_modalities,
               schemes=sorted(set(plans.normalization_schemes.values())))
    want = dict(stages=1, patch=list(PATCH), pools=[[2, 2, 2]] * 5, batch=2,
                modalities=4, schemes=["nonCT"])
    check(got == want, f"[variants] the region task's plan {got}, not "
          f"{want}")
    write_split(pre, REGIONS_CASES, REGIONS_VAL)
    print(f"[variants] raw task {REGIONS_TASK}: {len(REGIONS_CASES)} cases "
          f"{sorted(set(REGIONS_CASES.values()))}, modalities "
          f"{REGIONS_MODALITIES}, labels 0-3, written in {t1 - t0:.1f} s; "
          f"the plan CLI (-t 503): exit 0, {t2 - t1:.2f} s wall; plan {got}"
          f"  [{smi}]", flush=True)
    return pre


def variants_phase(rnd, R, ops, counts, smi, paths, trainer_ms=None):
    """[variants] the variants' knobs and the region trainers at the bench
    width (48 base features, bf16, kernel DSFF at 0.2), through
    cli/train.main on the card:
    (a) regions_task, then -tr nnUNetTrainerV2_fullEvals (regions 'brats',
    DC + BCE, per-sample Dice, validate_every 1; 3 train cases and 1
    validation case, 2 epochs of 3 + 1 batches): the model 4 -> 3
    channels; validation_ep001/, validation_ep002/ (one pass) and the
    fold's validation_raw/ (8 passes), each with a summary.csv of the three
    regions and no postprocessing; every exported probability finite in
    [0, 1] (no sum-to-1 rule: the regions overlap), the labels in {0, 1,
    2, 3} at the case's geometry; each validation's forwards launching the
    seg head's logits mode (#9) tiles x passes times and its probs mode
    (#10) never; launches per step the 3D step's. Kernel #1 at the first
    block (4 -> 48, the 4-byte row route) and the block backward's wgrad
    there against their plain versions, #9 at 48 -> 3; one step's
    gradients of the trained region model on 2 x 64^3 x 4 channels
    against a float32 plain run (the 1.25x rule); load_pretrained_weights
    of [trainer]'s fold checkpoint (or, run alone, (b)'s) into the region
    model: the count the host's rule gives on the two checkpoints' trees,
    the first block (1 against 4 input channels) left as it was.
    (b) -tr nnUNetTrainerV2_noDeepSupervision on [trainer]'s task, 4 + 1
    batches, its validation left out: launches per step
    kernel_launches_per_train_step(do_ds=False), the seg head once.
    (c) -tr nnUNetTrainerV2_DA5 on the same task, 4 + 1 batches, no
    validation: the trainer's AugmentParams those apply_da_level('da5')
    makes of (b)'s. Prints ms per step of (b) beside (c)'s (the
    deep-supervision step) and trainer_ms ([trainer]'s runs' medians, None
    when run alone), the host's wait per batch, the phase's seconds;
    returns the kernels' variants results."""
    import dataclasses
    import glob
    import os
    import torch
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.inference import export
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, ds_loss_weights, kernel_launches_per_forward,
        kernel_launches_per_train_step)
    from e2enet_tpu_torch.models.weights import (from_jax_params,
                                                 to_jax_params)
    from e2enet_tpu_torch.ops import _native, blocks
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, pad_volume_to_patch)
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.training.checkpoint import load_checkpoint
    from e2enet_tpu_torch.training.pretrained import load_pretrained_weights
    from e2enet_tpu_torch.training.regions import convert_seg_to_regions
    from e2enet_tpu_torch.training.trainer import Trainer
    from e2enet_tpu_torch.training.variants import apply_da_level
    t_phase = time.perf_counter()
    dev = VARIANTS_DEVICE

    # ---- the kernels at the region model's first block and head
    out = {}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    D, H, W = PATCH
    print("[variants] kernels vs plain at the region model's shapes: the "
          "first block over four modalities, the head over three regions",
          flush=True)
    with torch.inference_mode():
        r1 = fused_case("regions_l0_c4_to48", 1, D, H, W, [4], [False], 48,
                        rnd=rnd, reps=R)
        e1 = fused_case("regions_l0_c4_to48_n2", 2, D, H, W, [4], [False], 48,
                        rnd=rnd, reps=0)["max_abs_err"]
        out["fused_shift_conv_block"] = dict(
            max_abs_err=max(r1["max_abs_err"], e1),
            shapes={"regions_l0_c4_to48": {
                k: r1[k] for k in keys + ("mma_ms", "host_ms")}})
        r9 = seghead_case("regions_l0_logits_48_to3", 2, D, H, W, 48, 3,
                          False, rnd, R, route=None)
        out["seghead"] = dict(
            max_abs_err=r9["max_abs_err"],
            logits={k: r9[k] for k in keys + ("kernel_route",)})
    r2 = block_bwd_case("regions_l0_c4_to48", 2, D, H, W, [4], [False], 48,
                        rnd=rnd, reps=R, want=[False])
    e2 = block_bwd_case("regions_l0_c4_to48_dgrad", 2, D // 4, H, W, [4],
                        [False], 48, rnd=rnd, reps=0)["max_abs_err"]
    out["fused_shift_conv_block_bwd"] = dict(
        max_abs_err=max(r2["max_abs_err"], e2),
        shapes={"regions_l0_c4_to48": {k: r2[k] for k in keys}})
    torch.cuda.empty_cache()

    # ---- (b) noDeepSupervision and (c) DA5 on [trainer]'s task
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    runs, walls = [], []
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    # (b) and (c) leave their validation out; (a) validates
    init_spy, load_spy = trainer_spies("variants", ops, counts, runs,
                                       validate_runs={2})
    Trainer.initialize, Trainer.load_checkpoint_file = init_spy, load_spy
    step_args = ["--task", TRAIN_TASK, "--fold", "0", "--val_batches", "1",
                 "--sparse", "True", "--density", "0.2",
                 "--update_frequency", "4", "--device", dev]
    try:
        for preset in ("nnUNetTrainerV2_noDeepSupervision",
                       "nnUNetTrainerV2_DA5"):
            os.environ["RESULTS_FOLDER"] = (paths["results"] + "_variants_"
                                            + preset.split("_")[-1])
            t0 = time.perf_counter()
            tcli.main(step_args + VARIANTS_STEP_RUN + ["-tr", preset])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # (a) the region trainer on its BraTS-like task
        pre = regions_task(paths, smi)
        os.environ["RESULTS_FOLDER"] = paths["results"] + "_variants"
        val_runs = []
        region_init = Trainer.initialize

        def init(self, training=True):
            region_init(self, training)
            validate = self.validate

            def spied(*a, **k):
                flags, real = [], _native.launch_seghead

                def launch(*la, **lk):
                    flags.append(bool(la[-1]))
                    return real(*la, **lk)
                before = counts()
                _native.launch_seghead = launch
                try:
                    validate(*a, **k)
                finally:
                    _native.launch_seghead = real
                torch.cuda.synchronize()
                val_runs.append(dict(
                    folder=k.get("validation_folder_name", "validation_raw"),
                    mirror=k.get("do_mirroring", True), probs=flags,
                    launches={n: v - before[n] for n, v in counts().items()}))
            self.validate = spied
        Trainer.initialize = init
        exported = []
        real_save = export.save_segmentation_nifti_from_softmax

        def save(softmax, out_fname, props, *a, **k):
            p = np.asarray(softmax)
            exported.append(dict(
                file=out_fname, shape=p.shape, finite=bool(
                    np.isfinite(p).all()), lo=float(p.min()),
                hi=float(p.max()), sum_dev=float(np.abs(p.sum(0) - 1).max()),
                order=a[1] if len(a) > 1 else None))
            return real_save(softmax, out_fname, props, *a, **k)
        export.save_segmentation_nifti_from_softmax = save
        try:
            t0 = time.perf_counter()
            tcli.main(["--task", REGIONS_TASK, "--fold", "0",
                       "--val_batches", "1", "--sparse", "True",
                       "--density", "0.2", "--update_frequency", "4",
                       "--device", dev, "-tr", "nnUNetTrainerV2_fullEvals"]
                      + VARIANTS_REGION_RUN)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        finally:
            export.save_segmentation_nifti_from_softmax = real_save
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
    check(len(runs) == 3, f"[variants] {len(runs)} trainers")
    nods, da5, reg = (r["trainer"] for r in runs)

    # (b): one head per step
    per = kernel_launches_per_train_step(nods.network, do_ds=False)
    check(nods.ds_mode == "none" and nods.ds_weights == [1.0]
          and nods.ds_scales is None and per["forward"]["seghead"] == 1
          and runs[0]["want"]["seghead"] == 1
          and kernel_launches_per_train_step(nods.network)["forward"][
              "seghead"] == 2, f"[variants] noDeepSupervision: ds_mode "
          f"{nods.ds_mode}, weights {nods.ds_weights}, launches {per}")
    # (c): the level's parameters
    want = apply_da_level(dataclasses.replace(
        nods.da_params, deep_supervision_scales=da5.ds_scales), "da5")
    check(dataclasses.asdict(da5.da_params) == dataclasses.asdict(want),
          f"[variants] DA5's AugmentParams {da5.da_params} are not "
          f"apply_da_level's {want}")
    check(da5.da_params.independent_scale_per_axis
          and da5.da_params.do_additive_brightness
          and tuple(da5.da_params.gamma_range) == (0.5, 1.6),
          "[variants] DA5's level not applied")
    for i, (tag, run) in enumerate(zip(("(b) noDeepSupervision",
                                        "(c) DA5", "(a) fullEvals"),
                                       runs)):
        tr = run["trainer"]
        losses = [float(v) for v in run["losses"]]
        ms = [a.elapsed_time(b) for a, b in run["events"]]
        waits = run["waits"]
        check(all(np.isfinite(losses)) and all(
            np.isfinite(tr.all_tr_losses + tr.all_val_losses)),
            f"[variants] {tag}: a loss is not finite")
        check(run["updates"] == len(losses) // 4, f"[variants] {tag}: "
              f"{run['updates']} mask updates in {len(losses)} steps")
        run["median_ms"] = float(np.median(ms[1:]))
        print(f"[variants] {tag}: {len(losses)} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; online Dice "
              f"{tr.all_val_eval_metrics}; launches per step {run['want']}; "
              f"ms per step (CUDA events) {' '.join(f'{v:.1f}' for v in ms)}"
              f", after the first: median {run['median_ms']:.1f}; host wait "
              f"per batch in next(tr_gen) (s) "
              f"{' '.join(f'{v:.3f}' for v in waits)}, after the first: "
              f"median {float(np.median(waits[1:])):.3f}, mean "
              f"{float(np.mean(waits[1:])):.3f}; cli.main {walls[i]:.1f} s"
              f"  [{smi}]", flush=True)
    print(f"[variants] the noDeepSupervision step: median "
          f"{runs[0]['median_ms']:.1f} ms (one seg head) beside the "
          f"deep-supervision step's {runs[1]['median_ms']:.1f} ms (DA5 on "
          f"the same task) and [trainer]'s runs' "
          + (" / ".join(f"{v:.1f}" for v in trainer_ms) + " ms"
             if trainer_ms else "(not run: --variants alone)")
          + f" in this run  [{smi}]", flush=True)

    # (a): the region trainer
    check(list(reg.regions.values()) == list(BRATS)
          and reg.regions_class_order == (1, 2, 3)
          and reg.loss_name == "dc_bce" and not reg.batch_dice
          and reg.validate_every == 1, "[variants] fullEvals' options")
    cin = int(reg.network.context0.block0.kernel.shape[1])
    cout = int(reg.network.seg_head0.kernel.shape[0])
    check((cin, cout) == (4, 3), f"[variants] the region model {cin} -> "
          f"{cout} channels")
    ref = ShiftUNetPlusPlus(1, NUM_CLASSES, reg.network.pools,
                            base_num_features=48, device=dev)
    per_3d = kernel_launches_per_train_step(ref)
    del ref
    want3d = {k: per_3d["forward"].get(k, 0) + per_3d["backward"].get(k, 0)
              for k in ops}
    check(runs[2]["want"] == want3d and runs[1]["want"] == want3d,
          f"[variants] launches per step {runs[2]['want']}, the 3D step's "
          f"{want3d}")
    fold = reg.output_folder
    folders = ["validation_ep001", "validation_ep002", "validation_raw"]
    check([v["folder"] for v in val_runs] == folders
          and [v["mirror"] for v in val_runs] == [False, False, True],
          f"[variants] validations {[(v['folder'], v['mirror']) for v in val_runs]}")
    case = REGIONS_VAL[0]
    d = np.load(os.path.join(pre, "nnUNetData_plans_v2.1_stage0",
                             f"{case}.npz"))["data"][:-1]
    padded, _ = pad_volume_to_patch(d, reg.patch_size)
    tiles = int(np.prod([len(s) for s in compute_steps_for_sliding_window(
        reg.patch_size, padded.shape[1:], 0.5)]))
    per_fwd = kernel_launches_per_forward(reg.network)
    raw_img = read_nifti(os.path.join(paths["raw"], "nnUNet_raw_data",
                                      REGIONS_TASK, "imagesTr",
                                      f"{case}_0000.nii.gz"))
    for v in val_runs:
        passes = TTA if v["mirror"] else 1
        want = {n: tiles * passes * c for n, c in per_fwd.items()}
        check({n: v["launches"][n] for n in want} == want
              and all(v["launches"][n] == 0 for n in v["launches"]
                      if n not in want), f"[variants] {v['folder']}: "
              f"launches {v['launches']} != {want}")
        check(len(v["probs"]) == want["seghead"] and not any(v["probs"]),
              f"[variants] {v['folder']}: {sum(v['probs'])} of "
              f"{len(v['probs'])} seg-head launches in the probs mode (#10)")
        with open(os.path.join(fold, v["folder"], "summary.csv")) as f:
            rows = [r.split(",") for r in f.read().splitlines()]
        check(rows[0] == ["casename", "whole tumor", "tumor core",
                          "enhancing tumor"] and [r[0] for r in rows[1:]]
              == [case, "mean", "median"], f"[variants] {v['folder']}/"
              f"summary.csv: {rows}")
        seg = read_nifti(os.path.join(fold, v["folder"], f"{case}.nii.gz"))
        labels = set(np.unique(seg.array).tolist())
        check(seg.array.shape == REGIONS_CASES[case] and labels <= {0, 1, 2, 3}
              and np.allclose(seg.spacing, raw_img.spacing)
              and np.allclose(seg.origin, raw_img.origin),
              f"[variants] {v['folder']}: labels {labels}, shape "
              f"{seg.array.shape}, spacing {seg.spacing}")
        v["dice"] = rows[1][1:]
        v["labels"] = sorted(labels)
    check(len(exported) == 3 and all(
        e["finite"] and e["lo"] >= 0.0 and e["hi"] <= 1.0
        and e["shape"][0] == 3 and e["order"] == (1, 2, 3)
        for e in exported), f"[variants] the exported region "
        f"probabilities {exported}")
    check(not os.path.exists(os.path.join(fold, "postprocessing.json")),
          "[variants] the region fold was postprocessed")
    print(f"[variants] (a) fullEvals on {case}: {tiles} tiles; "
          + "; ".join(f"{v['folder']} ({TTA if v['mirror'] else 1} passes): "
                      f"region Dice {v['dice']}, labels {v['labels']}, "
                      f"#9 launches {len(v['probs'])}, #10 0"
                      for v in val_runs)
          + f"; exported probabilities in [{min(e['lo'] for e in exported):.4f}"
          f", {max(e['hi'] for e in exported):.4f}], max |sum - 1| "
          f"{max(e['sum_dev'] for e in exported):.3f} (regions overlap); "
          f"{validation_text(reg, runs[2])}", flush=True)

    # ---- one step's gradients of the trained region model
    net = reg.network
    pools = net.pools
    n_out = net.num_ds_outputs()
    rng = np.random.RandomState(9)
    v, ts = tbm.make_batch(rng, 2, GRAD_PATCH, REGIONS_LABELS,
                           tbm.ds_factors(pools, n_out))
    lv = rng.randn(3, REGIONS_LABELS).astype(np.float32)
    chans = [v] + [lv[i][ts[0]][..., None] + 0.5 * v for i in range(3)]
    data = torch.from_numpy(np.concatenate(chans, -1)).to(dev)
    targets = [torch.from_numpy(convert_seg_to_regions(t, BRATS)).to(dev)
               for t in ts]
    weights = ds_loss_weights(len(pools), n_out)
    lk = dict(loss_name="dc_bce", loss_kwargs={"smooth": 0.0},
              batch_dice=False)
    g_k = loss_grads(net, data, targets, weights, **lk)
    with blocks.plain_ops():
        g_p = loss_grads(net, data, targets, weights, **lk)
        net32 = ShiftUNetPlusPlus(4, 3, pools,
                                  base_num_features=reg.base_num_features,
                                  compute_dtype=torch.float32, device=dev)
        net32.load_state_dict(net.state_dict())
        g_32 = loss_grads(net32, data, targets, weights, **lk)
    e_k = float((g_k - g_32).norm() / g_32.norm())
    e_p = float((g_p - g_32).norm() / g_32.norm())
    print(f"[variants] one step's gradients of the trained region model on "
          f"2 x {GRAD_PATCH[0]}^3 x 4 channels (DC + BCE on 3 regions), "
          f"against a float32 plain run: kernel path rel L2 err {e_k:.4e}, "
          f"bf16 plain path {e_p:.4e}", flush=True)
    check(e_k <= ERR_RATIO * e_p, "[variants] kernel-path gradients further "
          "from the float32 run than the bf16 plain path's")
    del net32, g_k, g_p, g_32, data, targets

    # ---- the pretrained transfer into the region model
    found = sorted(glob.glob(os.path.join(
        paths["results"], "**", TRAIN_TASK, "*", "fold_0",
        "shiftConvPP_model_final_checkpoint.model"), recursive=True))
    src = found[0] if found else nods.checkpoint_path("final_checkpoint")
    target = dict(net.state_dict())
    before = {k: t.detach().clone() for k, t in target.items()}
    t0 = time.perf_counter()
    new = load_pretrained_weights(target, src, verbose=False)
    t_tr = time.perf_counter() - t0
    net.load_state_dict(new)
    # the host's rule on the two checkpoints' flax trees
    s_tree = load_checkpoint(src)[0]["params"]

    def leaves(tree, prefix=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, prefix + (k,))
            else:
                yield prefix + (k,), val
    s_flat = dict(leaves(s_tree))
    rule = {".".join(p) for p, val in leaves(to_jax_params(before))
            if p[0].startswith("context") and p in s_flat
            and s_flat[p].shape == val.shape}
    moved = {k for k in new if new[k] is not target[k]}
    source = from_jax_params(s_tree)
    check(moved == rule and len(rule) > 0
          and "context0.block0.kernel" not in moved,
          f"[variants] transferred {sorted(moved)[:4]}... ({len(moved)}), "
          f"the rule's {len(rule)}")
    after = net.state_dict()
    check(all(torch.equal(after[k].cpu(), source[k]) for k in moved)
          and all(torch.equal(after[k], before[k]) for k in after
                  if k not in moved), "[variants] the transferred model's "
          "tensors are not the checkpoint's where moved and its own "
          "elsewhere")
    print(f"[variants] load_pretrained_weights from "
          f"{'[trainer]' if found else '(b)'}'s fold checkpoint (1 -> 16 "
          f"channels) into the region model (4 -> 3): {len(moved)} tensors, "
          f"the host's rule {len(rule)}; context0.block0.kernel (1 against 4 "
          f"input channels) kept; {t_tr:.2f} s", flush=True)
    del runs, nods, da5, reg, net
    torch.cuda.empty_cache()
    check("jax" not in sys.modules, "[variants] jax was imported")
    print(f"[variants] phase {time.perf_counter() - t_phase:.1f} s  [{smi}]",
          flush=True)
    return out


# the [ensembles] phase: validation with saved softmax, model selection,
# consolidation, the merge of two models' softmax and the AMOS2022
# predictor, on [trainer]'s task
ENSEMBLE_NETWORKS = ("3d_fullres", "2d")
# one validated case per fold, into a folder of its own (not [trainer]'s
# validation_raw): each case costs about 10 scoring passes and 15 label
# map writes over the phase (the validations, the ensemble's and the
# consolidation's postprocessing searches, the merges)
ENSEMBLE_VAL = TRAIN_VAL[:1]
ENSEMBLE_VAL_FOLDER = "validation_ensembles"
ENSEMBLE_FOLD_ARGS = ["--task", TRAIN_TASK, "--fold", "0", "--sparse",
                      "True", "--density", "0.2", "--update_frequency", "4"]
ENSEMBLE_DEVICE = "cuda"
# the AMOS2022 case: the central 128^3 of the first validation case's
# image at ITK (x, y, z) spacing (1.25, 0.8, 1.0) mm; at the plan's 1 mm
# the network sees (z, y, x) = (128, 102, 160), and the resample back
# keeps z, grows y and shrinks x (jax's antialiased filter)
AMOS_CROP = 128
AMOS_SPACING = (1.25, 0.8, 1.0)
AMOS_MARGIN = 1e-4


def ensemble_folds(paths, ops, counts, smi):
    """--ensembles alone: the folds [ensembles] reads, as [trainer] and
    [2d] train them but shorter: the 2D plan by the plan CLI in a fresh
    process, then cli/train.main for one epoch of 4 + 1 batches on the 3D
    and on the 2D plan (kernel DSFF at 0.2), neither validating."""
    import os
    from pathlib import Path
    import torch
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.training.trainer import Trainer
    env = dict(os.environ, nnUNet_raw_data_base=paths["raw"],
               nnUNet_preprocessed=paths["preprocessed"])
    r = subprocess.run(
        [sys.executable, "-m", "e2enet_tpu_torch.cli.plan_and_preprocess",
         "-t", str(int(TRAIN_TASK[4:7])), "-pl3d", "None", "-pl2d",
         TWOD_PLANNER], cwd=Path(__file__).resolve().parent, env=env,
        capture_output=True, text=True, timeout=900)
    check(r.returncode == 0, f"[ensembles] the 2D plan CLI exited "
          f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"]
    runs = []
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    Trainer.initialize, Trainer.load_checkpoint_file = trainer_spies(
        "ensembles", ops, counts, runs, validate_runs=())
    try:
        for net in ENSEMBLE_NETWORKS:
            t0 = time.perf_counter()
            tcli.main(ENSEMBLE_FOLD_ARGS + ["--network", net, "--epochs",
                                            "1", "--batches", "4",
                                            "--val_batches", "1"])
            torch.cuda.synchronize()
            print(f"[ensembles] cli.train --network {net}, one epoch of 4 "
                  f"+ 1 batches: {time.perf_counter() - t0:.1f} s  [{smi}]",
                  flush=True)
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
    check(len(runs) == 2, f"[ensembles] {len(runs)} trainers")


def ensembles_phase(ops, counts, smi, paths):
    """[ensembles] the last step of the nnU-Net workflow on [trainer]'s
    task, with the 3d_fullres and the 2d fold 0 that [trainer] and [2d]
    trained: (1) each fold validated by cli/train.main --validation_only
    with validate(save_softmax=True, do_mirroring=False) on ENSEMBLE_VAL
    into ENSEMBLE_VAL_FOLDER, its postprocessing left to (3); (2)
    figure_out_what_to_submit over both networks: the pairwise ensemble
    built, scored and its postprocessing determined, the ranking holding
    all three candidates, summary.csv a row per candidate; (3)
    consolidate_folds on the 3d_fullres folder (fold 0); (4) cli/predict
    -z of the validated case with -m 3d_fullres (TTA), merged with the 2d
    fold's saved validation softmax of the same case (the same files a
    -z run writes; a 2D -z run is left out for time) and the ensemble's
    postprocessing.json: the labels, the input's geometry, the labels the
    plain merge's under the decision (as they are under an empty one);
    the launches of each validation and of the -z run tiles x passes x
    kernel_launches_per_forward; (5) predict_from_folder_amos2022
    with TTA on one case at the bench width (AMOS_CROP^3 at
    AMOS_SPACING): its launches tiles x passes x
    kernel_launches_per_forward, the labels of the card's resample equal
    to the CPU resample's of the same softmax where its top two differ by
    more than AMOS_MARGIN, the input's geometry. Prints the seconds of
    each step, of resample_softmax_on_device and of the phase."""
    import os
    from collections import OrderedDict
    import torch
    from e2enet_tpu_torch.cli import predict as pcli
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.evaluation.model_selection import (
        figure_out_what_to_submit)
    from e2enet_tpu_torch.inference import amos2022, predictor
    from e2enet_tpu_torch.inference.ensemble_predictions import merge
    from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_forward
    from e2enet_tpu_torch.ops.sliding import (
        compute_steps_for_sliding_window, pad_volume_to_patch)
    from e2enet_tpu_torch.postprocessing.connected_components import (
        load_postprocessing, remove_all_but_the_largest_connected_component)
    from e2enet_tpu_torch.postprocessing.consolidate import consolidate_folds
    from e2enet_tpu_torch.training import trainer as trainer_mod
    from e2enet_tpu_torch.utils.files import join, load_json
    t_phase = time.perf_counter()
    secs = OrderedDict()
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"]
    gt = os.path.join(paths["preprocessed"], TRAIN_TASK, "gt_segmentations")
    trainer_plan = "TPUTrainer__nnUNetPlansv2.1"
    folders = {net: os.path.join(paths["results"], "nnUNet", net,
                                 TRAIN_TASK, trainer_plan)
               for net in ENSEMBLE_NETWORKS}

    # ---- (1) each fold validated with its softmax saved, no mirroring
    real_validate = trainer_mod.Trainer.validate
    validated = []

    def validate(self, *a, **k):
        folder = join(self.dataset_directory, self.plans.data_identifier
                      + "_stage%d" % self.stage)
        dataset = trainer_mod.load_dataset(folder)
        _, val = trainer_mod.do_split(dataset, self.fold, join(
            self.dataset_directory, "splits_final.pkl"))
        self.dataset_val = OrderedDict((c, dataset[c]) for c in val
                                       if c in ENSEMBLE_VAL)
        patch = tuple(int(i) for i in self.patch_size)
        tiles = 0
        for c in self.dataset_val:
            shape = trainer_mod.load_case(self.dataset_val[c]).shape[1:]
            tiles += int(np.prod([len(s) for s in
                                  compute_steps_for_sliding_window(
                                      patch, [max(i, p) for i, p in
                                              zip(shape, patch)], 0.5)]))
        before = counts()
        t0 = time.perf_counter()
        real_validate(self, save_softmax=True, do_mirroring=False,
                      validation_folder_name=ENSEMBLE_VAL_FOLDER,
                      run_postprocessing_on_folds=False)
        torch.cuda.synchronize()
        validated.append((self, time.perf_counter() - t0, tiles,
                          {n: v - before[n] for n, v in counts().items()}))
    trainer_mod.Trainer.validate = validate
    try:
        for net in ENSEMBLE_NETWORKS:
            t0 = time.perf_counter()
            tcli.main(ENSEMBLE_FOLD_ARGS + ["--network", net,
                                            "--validation_only"])
            torch.cuda.synchronize()
            secs[f"validate {net}"] = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer.validate = real_validate
    check(len(validated) == 2, f"[ensembles] {len(validated)} validations")
    for (tr, sec, tiles, launched), net in zip(validated,
                                               ENSEMBLE_NETWORKS):
        val = os.path.join(tr.output_folder, ENSEMBLE_VAL_FOLDER)
        # one pass per tile (no mirroring), every forward on the kernels
        want = {n: tiles * v for n, v in
                kernel_launches_per_forward(tr.network).items()}
        check({n: launched[n] for n in want} == want
              and all(launched[n] == 0 for n in launched if n not in want),
              f"[ensembles] {net} validation: launches {launched} != "
              f"{want} ({tiles} tiles x 1 pass)")
        check(os.path.dirname(os.path.dirname(tr.output_folder))
              == os.path.dirname(folders[net]), f"[ensembles] {net} "
              f"validated {tr.output_folder}")
        for c in ENSEMBLE_VAL:
            with np.load(os.path.join(val, c + ".npz")) as z:
                p = z["softmax"]
            check(p.dtype == np.float16 and p.shape == (NUM_CLASSES,
                                                        *TRAIN_CASES[c])
                  and bool(np.isfinite(p).all()), f"[ensembles] {net} {c}: "
                  f"softmax {p.dtype} {p.shape}")
            check(os.path.isfile(os.path.join(val, c + ".pkl")),
                  f"[ensembles] {net} {c}: no .pkl beside the softmax")
        print(f"[ensembles] {net} fold 0 validate(save_softmax=True, "
              f"do_mirroring=False) on {ENSEMBLE_VAL}: "
              + ", ".join(f"{t['case']} predict {t['predict_s']:.2f} "
                          f"export {t['export_s']:.2f}"
                          for t in tr.validation_timings)
              + f"; {tiles} tiles x 1 pass, launches "
              f"{ {n: c for n, c in launched.items() if c} }; {sec:.1f} s "
              f"(scoring included)  [{smi}]", flush=True)
    del validated
    torch.cuda.empty_cache()

    # ---- (2) model selection: both networks and their ensemble
    t0 = time.perf_counter()
    report = figure_out_what_to_submit(
        TRAIN_TASK, networks=ENSEMBLE_NETWORKS, trainer_plan=trainer_plan,
        validation_folder_name=ENSEMBLE_VAL_FOLDER, folds=(0,),
        gt_folder=gt)
    secs["figure_out_what_to_submit"] = time.perf_counter() - t0
    ens_name = (f"ensemble_2d__{trainer_plan}--3d_fullres__{trainer_plan}")
    ens = os.path.join(paths["results"], "nnUNet", "ensembles", TRAIN_TASK)
    ens_pp = os.path.join(ens, ens_name, "postprocessing.json")
    check(ens_name in report["candidates"] and os.path.isfile(ens_pp)
          and os.path.isfile(os.path.join(ens, ens_name, "ensembled_raw",
                                          "summary.json")),
          f"[ensembles] the ensemble was not built: candidates "
          f"{list(report['candidates'])}")
    check(sorted(report["ranking"]) == sorted(ENSEMBLE_NETWORKS
                                              + (ens_name,)),
          f"[ensembles] ranking {report['ranking']}")
    with open(os.path.join(ens, "summary.csv")) as f:
        rows = f.read().splitlines()
    check(len(rows) == 4 and sorted(r.split(",")[0] for r in rows[1:])
          == sorted(report["ranking"]), f"[ensembles] summary.csv {rows}")
    with open(os.path.join(ens, "prediction_commands.txt")) as f:
        commands = f.read()
    print(f"[ensembles] figure_out_what_to_submit: mean foreground Dice "
          + ", ".join(f"{k} {report['candidates'][k]['mean_fg_dice']:.4f}"
                      for k in report["ranking"])
          + f"; best {report['best']}; the ensemble's postprocessing "
          f"{load_json(ens_pp)['for_which_classes']}; prediction_commands"
          f".txt {len(commands.splitlines())} lines; "
          f"{secs['figure_out_what_to_submit']:.1f} s", flush=True)

    # ---- (3) the 3d_fullres folds consolidated
    t0 = time.perf_counter()
    pp = consolidate_folds(folders["3d_fullres"], gt,
                           validation_folder_name=ENSEMBLE_VAL_FOLDER,
                           folds=(0,))
    secs["consolidate_folds"] = time.perf_counter() - t0
    for f in ("postprocessing.json", "cv_niftis_raw/summary.json",
              "cv_niftis_postprocessed/summary.json"):
        check(os.path.isfile(os.path.join(folders["3d_fullres"], f)),
              f"[ensembles] consolidate_folds wrote no {f}")
    pooled = len(os.listdir(os.path.join(folders["3d_fullres"],
                                         "cv_niftis_raw"))) - 1
    print(f"[ensembles] consolidate_folds(3d_fullres, folds=(0,)): {pooled} "
          f"cases pooled, postprocessing {pp['for_which_classes']}; "
          f"{secs['consolidate_folds']:.1f} s", flush=True)

    # ---- (4) a -z prediction merged with the 2d fold's saved softmax of
    # the same case and the ensemble's postprocessing
    case = ENSEMBLE_VAL[0]
    base = os.path.join(paths["results"], "ensembles_predict")
    inp = os.path.join(base, "in")
    os.makedirs(inp)
    image = os.path.join(paths["images"], f"{case}_0000.nii.gz")
    os.symlink(image, os.path.join(inp, f"{case}_0000.nii.gz"))
    out3d = os.path.join(base, "3d_fullres")
    got = {}

    def spy_case(real):
        """predict_case recording its launches, tiles and passes in got."""
        def spy(bundle, d, *a, **k):
            before = counts()
            p = real(bundle, d, *a, **k)
            torch.cuda.synchronize()
            padded, _ = pad_volume_to_patch(d, bundle.patch_size)
            steps = compute_steps_for_sliding_window(bundle.patch_size,
                                                     padded.shape[1:], 0.5)
            got.update(
                launches={n: v - before[n] for n, v in counts().items()},
                tiles=int(np.prod([len(s) for s in steps])),
                passes=TTA if k.get("do_tta", True) else 1,
                per_fwd=kernel_launches_per_forward(bundle.fold_models[0]),
                shape=d.shape[1:])
            return p
        return spy
    real_case = predictor.predict_case
    predictor.predict_case = spy_case(real_case)
    t0 = time.perf_counter()
    try:
        pcli.main(["-i", inp, "-o", out3d, "-t", TRAIN_TASK, "-m",
                   "3d_fullres", "-f", "0", "-z"])
    finally:
        predictor.predict_case = real_case
    secs["predict -z 3d_fullres"] = time.perf_counter() - t0
    want = {n: got["tiles"] * got["passes"] * v
            for n, v in got["per_fwd"].items()}
    z_launches = {n: got["launches"][n] for n in want}
    check(z_launches == want and all(got["launches"][n] == 0 for n in
                                     got["launches"] if n not in want),
          f"[ensembles] predict -z: launches {got['launches']} != {want}")
    z_tiles = f"{got['tiles']} tiles x {got['passes']} passes"
    with np.load(os.path.join(out3d, case + ".npz")) as z:
        p = z["softmax"].astype(np.float32)
    dev = float(np.abs(p.sum(0) - 1.0).max())
    check(p.shape == (NUM_CLASSES, *TRAIN_CASES[case])
          and dev <= PROB_SUM_ATOL, f"[ensembles] predict -z 3d_fullres: "
          f"softmax {p.shape}, sums off by {dev}")
    del p
    sources = [out3d, os.path.join(folders["2d"], "fold_0",
                                   ENSEMBLE_VAL_FOLDER)]
    merged, plain = os.path.join(base, "merged"), os.path.join(base, "plain")
    t0 = time.perf_counter()
    merge(sources, merged, postprocessing_file=ens_pp)
    secs["merge"] = time.perf_counter() - t0
    merge(sources, plain)
    src = read_nifti(image)
    seg = read_nifti(os.path.join(merged, case + ".nii.gz"))
    raw = read_nifti(os.path.join(plain, case + ".nii.gz")).array
    labels = np.unique(seg.array)
    check(seg.array.shape == src.array.shape == TRAIN_CASES[case]
          and int(labels.min()) >= 0 and int(labels.max()) < NUM_CLASSES,
          f"[ensembles] merge: shape {seg.array.shape}, labels {labels}")
    for k in ("spacing", "origin", "direction"):
        check(np.allclose(getattr(seg, k), getattr(src, k)),
              f"[ensembles] merge: {k} {getattr(seg, k)} is not the "
              f"input's {getattr(src, k)}")
    fwc, mvos = load_postprocessing(ens_pp)
    check(load_json(os.path.join(merged, "postprocessing.json"))
          == load_json(ens_pp), "[ensembles] merge: postprocessing.json "
          "not copied")
    # the plain merge under the decision (an empty decision leaves it as
    # it is; ties of the largest size all stay)
    want_seg = (remove_all_but_the_largest_connected_component(
        raw.copy(), fwc, float(np.prod(seg.spacing)), mvos)[0] if fwc
        else raw)
    check(np.array_equal(seg.array, want_seg), "[ensembles] merge: the "
          "labels are not the plain merge's under the ensemble's "
          "postprocessing")
    removed = int((seg.array != raw).sum())
    print(f"[ensembles] cli.predict -z -m 3d_fullres (TTA) on {case}: "
          f"{z_tiles}, launches {z_launches}; "
          f"{secs['predict -z 3d_fullres']:.1f} s; merge with the 2d fold's "
          f"validation softmax and the ensemble's postprocessing {fwc}: "
          f"labels {labels.tolist()[:4]}...{int(labels.max())}, the "
          f"input's geometry, {removed} voxels removed; "
          f"{secs['merge']:.1f} s", flush=True)

    # ---- (5) the AMOS2022 predictor, one case, TTA
    amos_in, amos_out = (os.path.join(base, "amos_in"),
                         os.path.join(base, "amos_out"))
    os.makedirs(amos_in)
    lo = [(s - AMOS_CROP) // 2 for s in src.array.shape]
    crop = np.ascontiguousarray(src.array[lo[0]:lo[0] + AMOS_CROP,
                                          lo[1]:lo[1] + AMOS_CROP,
                                          lo[2]:lo[2] + AMOS_CROP])
    amos_img = NiftiImage(crop, AMOS_SPACING, src.origin, src.direction)
    write_nifti(os.path.join(amos_in, f"{case}_0000.nii.gz"), amos_img)
    real_case = amos2022.predict_case
    real_resample = amos2022.resample_softmax_on_device
    got.clear()
    resampled = []

    def resample_spy(softmax, target, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg = real_resample(softmax, target, *a, **k)
        dt = time.perf_counter() - t0
        check(isinstance(softmax, torch.Tensor) and softmax.is_cuda,
              "[ensembles] amos2022: the softmax reached the resample "
              "off the card")
        resampled.append((softmax.cpu().numpy(), tuple(target), seg, dt))
        return seg
    amos2022.predict_case = spy_case(real_case)
    amos2022.resample_softmax_on_device = resample_spy
    t0 = time.perf_counter()
    try:
        amos2022.predict_from_folder_amos2022(
            folders["3d_fullres"], amos_in, amos_out, (0,), do_tta=True,
            device=ENSEMBLE_DEVICE)
    finally:
        amos2022.predict_case = real_case
        amos2022.resample_softmax_on_device = real_resample
    secs["predict_from_folder_amos2022"] = time.perf_counter() - t0
    check(len(resampled) == 1, f"[ensembles] amos2022: {len(resampled)} "
          f"resamples")
    softmax, target, seg_card, t_resample = resampled[0]
    want = {n: got["tiles"] * got["passes"] * v
            for n, v in got["per_fwd"].items()}
    have = {n: got["launches"][n] for n in want}
    check(have == want and all(got["launches"][n] == 0 for n in
                               got["launches"] if n not in want),
          f"[ensembles] amos2022: launches {got['launches']} != {want}")
    # again on the same softmax, by parts: the upload of the contiguous
    # softmax from pageable memory (predict_from_folder_amos2022's, outside
    # the timed call above), the resize alone by CUDA events, the whole
    # call on the card's copy (resize, argmax, the labels to the host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_dev = torch.from_numpy(softmax).to(ENSEMBLE_DEVICE)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    amos2022.resize_softmax(x_dev, target, device=ENSEMBLE_DEVICE)
    ev[1].record()
    torch.cuda.synchronize()
    t_resize = ev[0].elapsed_time(ev[1]) / 1e3
    t0 = time.perf_counter()
    again = amos2022.resample_softmax_on_device(x_dev, target,
                                                device=ENSEMBLE_DEVICE)
    t_again = time.perf_counter() - t0
    del x_dev
    check(np.array_equal(again, seg_card), "[ensembles] amos2022: a second "
          "resample of the same softmax gave other labels")
    t0 = time.perf_counter()
    cpu = amos2022.resize_softmax(softmax, target, device="cpu")
    seg_cpu = torch.argmax(cpu, 0).to(torch.uint8).numpy()
    t_cpu = time.perf_counter() - t0
    top2 = torch.topk(cpu, 2, dim=0).values
    sure = ((top2[0] - top2[1]) > AMOS_MARGIN).numpy()
    n_diff = int((seg_card != seg_cpu).sum())
    check(bool((seg_card == seg_cpu)[sure].all()), f"[ensembles] amos2022: "
          f"the card's labels differ from the CPU resample's where the "
          f"margin exceeds {AMOS_MARGIN}")
    out = read_nifti(os.path.join(amos_out, case + ".nii.gz"))
    labels = np.unique(out.array)
    check(out.array.shape == crop.shape and int(labels.max()) < NUM_CLASSES,
          f"[ensembles] amos2022: shape {out.array.shape}, labels {labels}")
    for k in ("spacing", "origin", "direction"):
        check(np.allclose(getattr(out, k), getattr(amos_img, k)),
              f"[ensembles] amos2022: {k} {getattr(out, k)} is not the "
              f"input's {getattr(amos_img, k)}")
    check(np.array_equal(out.array, seg_card), "[ensembles] amos2022: the "
          "written labels are not the card's resample")
    print(f"[ensembles] predict_from_folder_amos2022 on a {AMOS_CROP}^3 "
          f"crop of {case} at {AMOS_SPACING} mm: network shape "
          f"{tuple(got['shape'])} -> {target}, {got['tiles']} tiles x "
          f"{got['passes']} passes, launches {have}; "
          f"resample_softmax_on_device {t_resample * 1e3:.1f} ms, again "
          f"{t_again * 1e3:.1f} ms, of it the resize {t_resize * 1e3:.2f} "
          f"ms (CUDA events); the upload of the {softmax.nbytes / 2 ** 20:.0f}"
          f" MiB softmax before it {t_upload * 1e3:.1f} ms; the CPU resize "
          f"{t_cpu:.2f} s; labels equal where the top two differ by "
          f"more than {AMOS_MARGIN} ({float(sure.mean()):.6f} of voxels; "
          f"{n_diff} differ in all); labels {labels.tolist()[:4]}..."
          f"{int(labels.max())}; {secs['predict_from_folder_amos2022']:.1f} "
          f"s  [{smi}]", flush=True)
    del got, resampled, softmax, cpu
    torch.cuda.empty_cache()
    check("jax" not in sys.modules, "[ensembles] jax was imported")
    print("[ensembles] seconds by step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s  [{smi}]",
        flush=True)


# the [models] phase: the architecture switches, ShiftUNet, _313/_331, the
# residual-encoder UNet and reference checkpoints (Queue 1 item 6)
MODELS_DEVICE = "cuda"
MODELS_R = 10                   # timed calls per base-24 kernel case
MODELS_RUN = ["--epochs", "2", "--batches", "3"]
MODELS_PRESETS = ("nnUNetTrainerV2_3ConvPerStage", "nnUNetTrainerV2_BN_ReLU",
                  "nnUNetTrainerV2_ResencUNet")
# (tag, Tconv, build_network switches, base features): every new network
# once, at the width its preset trains
MODELS_NETS = [
    ("3ConvPerStage", "shiftConvPP", dict(num_conv_per_stage=3), 24),
    ("biasInSegOutput", "shiftConvPP", dict(seg_bias=True), 48),
    ("BN", "shiftConvPP", dict(norm_op="batch"), 48),
    ("GN", "shiftConvPP", dict(norm_op="group"), 48),
    ("FRN", "shiftConvPP", dict(norm_op="frn"), 48),
    ("NoNormalization", "shiftConvPP", dict(norm_op="none"), 48),
    ("ReLU", "shiftConvPP", dict(nonlin="relu"), 48),
    ("GeLU", "shiftConvPP", dict(nonlin="gelu"), 48),
    ("Mish", "shiftConvPP", dict(nonlin="mish"), 48),
    ("LReLU_slope_2en1", "shiftConvPP", dict(nonlin="lrelu2e1"), 48),
    ("BN_ReLU", "shiftConvPP", dict(norm_op="batch", nonlin="relu"), 48),
    ("ReLU_convReLUIN", "shiftConvPP",
     dict(nonlin="relu", nonlin_before_norm=True), 48),
    ("allConv3x3", "shiftConvPP", dict(conv_kernel=(3, 3, 3)), 48),
    ("313", "shiftConvPP_313", {}, 48),
    ("331", "shiftConvPP_331", {}, 48),
    ("ori", "ori", {}, 48),
    ("nodff", "shiftConvPP_nodff", {}, 48),
    ("resenc", "resenc", {}, 24),
]
# a materialised network's bf16 forward against float32 (no kernel: the
# 1.25x rule has no plain path to hold it to): mean |dlogit| within this
# share of mean |logit|, argmax agreement at least MODELS_AGREE
MODELS_BF16_RTOL = 0.1
MODELS_AGREE = 0.9


def models_phase(rnd, R, ops, counts, smi, paths):
    """[models] Queue 1 item 6 on the card: (a) kernels #1-#10 at base 24
    (nnUNetTrainerV2_3ConvPerStage's width: level 0 1 -> 24, 24 -> 24, 24
    + 24 -> 24, the lazy node 24 + up 48 -> 24; level 1 48 -> 48, 48 + 48
    + 24 -> 48; the transition 24 -> 48, the up-link 48 -> 24, the
    down-link and the seg head at C = 24; the backward at batch 2)
    against their plain versions, timed with their bounds and library
    calls. (b) one bf16 forward per new network (MODELS_NETS) at its
    preset's width on a 1 x 128^3 patch (5 pools, 16 classes), against a
    float32 forward of the same weights: the kernel-route networks (3
    convs per stage, seg_bias) by the 1.25x rule against their plain
    path, their launches kernel_launches_per_forward; the materialised
    ones within MODELS_BF16_RTOL with no kernel launched. (c)
    cli/train.main on [trainer]'s task with MODELS_PRESETS (2 epochs of 3
    + 1 batches, no DSFF, validation left out): finite losses, the second
    epoch's mean below the first's, launches per step
    kernel_launches_per_train_step (0 off the kernel route). (d)
    cli/predict.main with TTA on one case with the resenc fold (data-flip
    TTA) and the BN_ReLU fold (flip-free; its network built from the
    sidecar's switches): labels, shape, no kernel launched. (e) a
    reference-format .model written from the 3-conv fold's weights by
    export_unetpp_state_dict, converted by
    convert_reference_model_to_native: its parameters equal the fold's,
    and in float32 (the plain path) it predicts the fold's own labels
    wherever the top two classes differ by more than 1e-4; the bf16
    kernel path's agreement printed beside a second run of the native
    checkpoint's (the statistics' atomics make runs differ). Returns the
    kernels' base-24 results."""
    import os
    import tempfile
    import torch
    from e2enet_tpu_torch import plans as tplans
    from e2enet_tpu_torch.cli import predict as pcli
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.inference import predictor as tpred
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.torch_checkpoint import \
        convert_reference_model_to_native
    from e2enet_tpu_torch.models.torch_import import \
        export_unetpp_state_dict
    from e2enet_tpu_torch.models.unetpp import (build_network,
                                                kernel_launches_per_forward)
    from e2enet_tpu_torch.models.weights import to_jax_params
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.training.trainer import Trainer
    from e2enet_tpu_torch.utils.files import save_pickle
    t_phase = time.perf_counter()
    steps = {}
    dev = MODELS_DEVICE
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    D, H, W = PATCH
    Dc, Hc, Wc = D // 2, H // 2, W // 2

    # ---- (a) kernels #1-#10 at base 24
    t0 = time.perf_counter()
    out, shapes = {}, {}
    print("[models] kernels vs plain at base 24 (3 convs per stage)",
          flush=True)

    def add(name, tag, r):
        shapes.setdefault(name, {})[tag] = {k: r[k] for k in keys if k in r}
        if "kernel_route" in r:
            shapes[name][tag]["kernel_route"] = r["kernel_route"]
        e = out.setdefault(name, dict(max_abs_err=0.0))
        e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
    with torch.inference_mode():
        for c in (("b24_l0_c1_to24", 1, D, H, W, [1], [False], 24),
                  ("b24_l0_24_to24", 1, D, H, W, [24], [True], 24),
                  ("b24_l0_24+24_to24", 1, D, H, W, [24, 24], [True, False],
                   24),
                  ("b24_l1_48_to48", 1, Dc, Hc, Wc, [48], [True], 48),
                  ("b24_l1_48+48+24_to48", 1, Dc, Hc, Wc, [48, 48, 24],
                   [True, False, False], 48)):
            add("fused_shift_conv_block", c[0],
                fused_case(*c, rnd=rnd, reps=R))
        add("lazy_up_fused_block", "b24_l0_24+up48to24_to24",
            lazy_case("b24_l0_24+up48to24_to24", 1, Dc, Hc, Wc, [24],
                      [True], 48, 24, 24, rnd, R))
        add("strided_fused", "b24_l0_to_l1_24_to48",
            strided_case("b24_l0_to_l1_24_to48", 1, D, H, W, 24, 48, rnd, R))
        add("uplink", "b24_l1_to_l0_48_to24",
            uplink_case("b24_l1_to_l0_48_to24", 1, Dc, Hc, Wc, 48, 24, rnd,
                        R, route=None))
        add("downlink", "b24_l0_to_l1_24",
            downlink_case("b24_l0_to_l1_24", 1, D, H, W, 24, rnd, R))
        for probs, tag in ((True, "b24_l0_probs_24_to16"),
                           (False, "b24_l0_logits_24_to16")):
            add("seghead", tag, seghead_case(tag, 1, D, H, W, 24, 16, probs,
                                             rnd, R, route=None))
    add("fused_shift_conv_block_bwd", "b24_l0_24+24_to24_n2",
        block_bwd_case("b24_l0_24+24_to24_n2", 2, D, H, W, [24, 24],
                       [True, False], 24, rnd=rnd, reps=R))
    add("fused_shift_conv_block_bwd", "b24_l1_48+48+24_to48_n2",
        block_bwd_case("b24_l1_48+48+24_to48_n2", 2, Dc, Hc, Wc,
                       [48, 48, 24], [True, False, False], 48, rnd=rnd,
                       reps=R))
    add("downlink_bwd", "b24_l0_to_l1_24_n2",
        downlink_bwd_case("b24_l0_to_l1_24_n2", 2, D, H, W, 24, rnd, R))
    for name in out:
        out[name]["shapes"] = shapes[name]
    torch.cuda.empty_cache()
    steps["(a) kernels at base 24"] = time.perf_counter() - t0

    # ---- (b) one forward per new network at full width
    t0 = time.perf_counter()
    stage = tplans.StagePlan(
        batch_size=2, num_pool_per_axis=[5, 5, 5], patch_size=list(PATCH),
        median_patient_size_in_voxels=list(PATCH),
        current_spacing=[1.0] * 3, original_spacing=[1.0] * 3,
        do_dummy_2D_data_aug=False, pool_op_kernel_sizes=[[2, 2, 2]] * 5,
        conv_kernel_sizes=[[1, 3, 3]] * 6)
    x = rnd(1, D, H, W, 1)
    rows = []
    for tag, tconv, sw, base in MODELS_NETS:
        kw = dict(tconv=tconv, base_num_features=base, device=dev, **sw)
        net = build_network(stage, 1, NUM_CLASSES, **kw)
        net.reset_parameters(len(rows))
        net32 = build_network(stage, 1, NUM_CLASSES,
                              compute_dtype=torch.float32, **kw)
        net32.load_state_dict(net.state_dict())
        per = kernel_launches_per_forward(net)
        with torch.inference_mode():
            net(x, do_ds=False)             # cuDNN's first call
            before = counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            k = net(x, do_ds=False).float()
            ev[1].record()
            torch.cuda.synchronize()
            got = {n: v - before[n] for n, v in counts().items()}
            ms = ev[0].elapsed_time(ev[1])
            p = None
            # the float32 network takes the plain versions (the kernels
            # take bfloat16)
            with blocks.plain_ops():
                f = net32(x, do_ds=False)
                if net.kernel_route():
                    p = net(x, do_ds=False).float()
        want = {n: per.get(n, 0) for n in got}
        check(got == want, f"[models] {tag}: launches {got} != {want}")
        check(bool(torch.isfinite(k).all()), f"[models] {tag}: non-finite")
        e_k = float((k - f).abs().mean())
        rel = e_k / float(f.abs().mean())
        agree = float((k.argmax(-1) == f.argmax(-1)).float().mean())
        row = dict(tag=tag, route="kernel" if net.kernel_route()
                   else "materialised", ms=ms, rel=rel, agree=agree,
                   launches=sum(got.values()))
        if p is not None:
            e_p = float((p - f).abs().mean())
            check(e_k <= ERR_RATIO * e_p, f"[models] {tag}: kernel path "
                  f"further from float32 ({e_k:.4e}) than the plain path "
                  f"({e_p:.4e})")
            check(row["launches"] > 0, f"[models] {tag}: no kernel launched")
            row["plain_rel"] = e_p / float(f.abs().mean())
        else:
            check(rel <= MODELS_BF16_RTOL and agree >= MODELS_AGREE,
                  f"[models] {tag}: bf16 against float32: mean |dlogit| "
                  f"{rel:.4f} of mean |logit|, argmax agreement {agree:.4f}")
        rows.append(row)
        print(f"[models] {tag} ({tconv}, base {base}, {row['route']} "
              f"route): bf16 forward {ms:.1f} ms, launches "
              f"{row['launches']} (kernel_launches_per_forward "
              f"{sum(per.values())}); against float32: mean |dlogit| "
              f"{rel:.4f} of mean |logit|"
              + (f" (plain bf16 path {row['plain_rel']:.4f})"
                 if p is not None else "")
              + f", argmax agreement {agree:.4f}", flush=True)
        del net, net32, k, f, p
        torch.cuda.empty_cache()
    steps["(b) forwards"] = time.perf_counter() - t0

    # ---- (c) three presets through the train CLI
    t0 = time.perf_counter()
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    runs, results, peaks = [], {}, {}
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    init_spy, load_spy = trainer_spies("models", ops, counts, runs,
                                       validate_runs=set())
    Trainer.initialize, Trainer.load_checkpoint_file = init_spy, load_spy
    try:
        for preset in MODELS_PRESETS:
            results[preset] = (paths["results"] + "_models_"
                               + preset.split("_", 1)[1])
            os.environ["RESULTS_FOLDER"] = results[preset]
            torch.cuda.reset_peak_memory_stats()
            tcli.main(["--task", TRAIN_TASK, "--fold", "0", "--val_batches",
                       "1", "--device", dev, "-tr", preset] + MODELS_RUN)
            torch.cuda.synchronize()
            peaks[preset] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
    check(len(runs) == len(MODELS_PRESETS), f"[models] {len(runs)} trainers")
    for preset, run in zip(MODELS_PRESETS, runs):
        tr = run["trainer"]
        losses = [float(v) for v in run["losses"]]
        ms = [a.elapsed_time(b) for a, b in run["events"]]
        check(all(np.isfinite(losses)) and all(np.isfinite(
            tr.all_tr_losses + tr.all_val_losses)),
            f"[models] {preset}: a loss is not finite")
        check(tr.all_tr_losses[-1] < tr.all_tr_losses[0],
              f"[models] {preset}: the train loss did not fall "
              f"({tr.all_tr_losses})")
        per_step = sum(run["want"].values())
        check((per_step > 0) == tr.network.kernel_route(),
              f"[models] {preset}: {per_step} launches per step")
        print(f"[models] {preset}: {type(tr.network).__name__} base "
              f"{tr.base_num_features}, switches "
              f"{ {k: v for k, v in tr.arch.items() if v is not None} }, "
              f"{len(losses)} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)} (epoch means "
              f"{' '.join(f'{v:.4f}' for v in tr.all_tr_losses)}); launches "
              f"per step {per_step}; ms per step (CUDA events) "
              f"{' '.join(f'{v:.1f}' for v in ms)}, after the first: median "
              f"{float(np.median(ms[1:])):.1f}; peak memory "
              f"{peaks[preset]:.1f} GiB  [{smi}]", flush=True)
    three, bn_relu, resenc = (r["trainer"] for r in runs)
    check(three.network.kernel_route()
          and three.network.num_conv_per_stage == 3
          and three.base_num_features == 24
          and not bn_relu.network.kernel_route()
          and type(resenc.network).__name__ == "ResidualUNet",
          "[models] the presets' networks")
    del runs
    torch.cuda.empty_cache()
    steps["(c) train CLI"] = time.perf_counter() - t0

    # ---- (d) the predict CLI with TTA: resenc (data flips), BN_ReLU
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_models_")
    inp = os.path.join(tmp.name, "predict_in")
    os.makedirs(inp)
    case = TRAIN_VAL[0]
    os.symlink(os.path.join(paths["images"], f"{case}_0000.nii.gz"),
               os.path.join(inp, f"{case}_0000.nii.gz"))
    seen = []
    real_tiled, real_build = tpred.predict_volume_tiled, tpred.build_network

    def tiled(*a, **k):
        seen.append(("tiles", k.get("mirror_apply_fns") is not None))
        return real_tiled(*a, **k)

    def build(*a, **k):
        net = real_build(*a, **k)
        seen.append(("net", net))
        return net
    tpred.predict_volume_tiled, tpred.build_network = tiled, build
    try:
        for preset, tconv, trainer in (
                ("nnUNetTrainerV2_ResencUNet", "resenc", resenc),
                ("nnUNetTrainerV2_BN_ReLU", "shiftConvPP", bn_relu)):
            os.environ["RESULTS_FOLDER"] = results[preset]
            out_dir = os.path.join(tmp.name, f"predict_{tconv}")
            seen.clear()
            before = counts()
            t1 = time.perf_counter()
            pcli.main(["-i", inp, "-o", out_dir, "-t", TRAIN_TASK, "-f", "0",
                       "--Tconv", tconv])
            wall = time.perf_counter() - t1
            got = {n: v - before[n] for n, v in counts().items()}
            seg = read_nifti(os.path.join(out_dir, f"{case}.nii.gz")).array
            labels = np.unique(seg)
            nets = [v for kind, v in seen if kind == "net"]
            flip_free = [v for kind, v in seen if kind == "tiles"]
            net = nets[0] if nets else None
            check(len(nets) == 1 and type(net) is type(trainer.network),
                  f"[models] {preset}: the predictor built {nets}")
            if tconv == "shiftConvPP":
                check(net.norm_op == "batch" and net.nonlin == "relu"
                      and not net.kernel_route(), f"[models] {preset}: the "
                      f"predictor's network {net.norm_op}/{net.nonlin}, not "
                      f"the sidecar's batch/relu")
            check(flip_free == [tconv != "resenc"], f"[models] {preset}: "
                  f"flip-free TTA {flip_free}")
            check(sum(got.values()) == 0, f"[models] {preset}: the "
                  f"materialised network launched {got}")
            check(seg.shape == TRAIN_CASES[case] and int(labels.min()) >= 0
                  and int(labels.max()) < NUM_CLASSES, f"[models] {preset} "
                  f"predict: shape {seg.shape}, labels {labels}")
            print(f"[models] cli.predict with TTA, the {preset} fold on "
                  f"{case}: {type(net).__name__} "
                  f"({'flip-free' if flip_free[0] else 'data-flip'} TTA), "
                  f"no kernel launched, shape {seg.shape}, labels "
                  f"{labels.tolist()}, {wall:.1f} s", flush=True)
    finally:
        tpred.predict_volume_tiled, tpred.build_network = \
            real_tiled, real_build
    del bn_relu, resenc
    torch.cuda.empty_cache()
    steps["(d) predict CLI"] = time.perf_counter() - t0

    # ---- (e) a reference-format checkpoint of the 3-conv fold's weights
    t0 = time.perf_counter()
    params = to_jax_params(three.network.state_dict())
    P = len(three.stage_plan.pool_op_kernel_sizes)
    sd = export_unetpp_state_dict(params, P, num_conv_per_stage=3)
    ref = os.path.join(tmp.name, "shiftConvPP_model_final_checkpoint.model")
    torch.save({"epoch": three.epoch, "state_dict": {
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        "optimizer_state_dict": None}, ref)
    raw = three.plans.to_dict()
    raw["conv_per_stage"] = 3
    raw["dataset_properties"] = dict(
        raw.get("dataset_properties") or {},
        intensityproperties=three.plans.intensity_properties)
    save_pickle({"init": (None,) * 9, "name": "nnUNetTrainerV2_3ConvPerStage",
                 "class": "nnUNetTrainerV2_3ConvPerStage", "plans": raw},
                ref + ".pkl")
    conv_dir = os.path.join(tmp.name, "converted", "fold_0")
    os.makedirs(conv_dir)
    convert_reference_model_to_native(
        ref, os.path.join(conv_dir,
                          "shiftConvPP_model_final_checkpoint.model"),
        base_num_features=24)
    data = np.load(os.path.join(
        paths["preprocessed"], TRAIN_TASK, "nnUNetData_plans_v2.1_stage0",
        f"{case}.npz"))["data"][:-1]
    folders = (os.path.dirname(conv_dir),
               os.path.dirname(three.output_folder))
    bundles = [tpred.ModelBundle(f, [0], "shiftConvPP", device=dev)
               for f in folders]
    sd_c, sd_n = (b.fold_models[0].state_dict() for b in bundles)
    check(set(sd_c) == set(sd_n) and all(torch.equal(sd_c[k], sd_n[k])
                                         for k in sd_n),
          "[models] the converted reference checkpoint's parameters differ "
          "from the fold's")
    # the kernel path (bf16; its float32 statistics sum by atomics, so two
    # runs of one checkpoint may differ where classes nearly tie), and
    # the float32 plain path, where the same weights give the same labels
    p_k = [tpred.predict_case(b, data, do_tta=False, step_size=0.5)
           for b in bundles + bundles[1:]]
    with blocks.plain_ops():
        p_f = [tpred.predict_case(tpred.ModelBundle(
            f, [0], "shiftConvPP", compute_dtype=torch.float32,
            device=dev), data, do_tta=False, step_size=0.5)
            for f in folders]
    top2 = np.sort(p_f[1], axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 1e-4
    same = p_f[0].argmax(0) == p_f[1].argmax(0)
    agree_k, again_k = (float((p_k[i].argmax(0) == p_k[1].argmax(0))
                              .mean()) for i in (0, 2))
    check(bool(same[clear].all()), f"[models] the converted checkpoint's "
          f"float32 labels differ from the native fold's on "
          f"{int((~same & clear).sum())} voxels whose top two classes "
          f"differ by more than 1e-4")
    print(f"[models] reference checkpoint: export_unetpp_state_dict of the "
          f"3-conv fold ({len(sd)} tensors), convert_reference_model_to_"
          f"native: parameters equal to the fold's; on {case} the float32 "
          f"labels equal the native checkpoint's on {int(same.sum())} of "
          f"{same.size} voxels ({int(clear.sum())} with a top-two margin "
          f"above 1e-4, all equal; max |dp| "
          f"{float(np.abs(p_f[0] - p_f[1]).max()):.2e}); the bf16 kernel "
          f"path's labels agree on {agree_k:.6f} (max |dp| "
          f"{float(np.abs(p_k[0] - p_k[1]).max()):.2e}), and the native "
          f"checkpoint's run again with its first run on {again_k:.6f} "
          f"(max |dp| {float(np.abs(p_k[2] - p_k[1]).max()):.2e})",
          flush=True)
    del bundles, p_k, p_f, three
    tmp.cleanup()
    torch.cuda.empty_cache()
    steps["(e) reference checkpoint"] = time.perf_counter() - t0
    check("jax" not in sys.modules, "[models] jax was imported")
    print("[models] seconds by step: " + "; ".join(
        f"{k} {v:.1f}" for k, v in steps.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s  [{smi}]",
        flush=True)
    return out


def models_only() -> None:
    """--models: the build, [trainer]'s planned task and the [models]
    phase alone (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_models_") as tmp:
        paths = plan_train_task(tmp, smi)
        for op in ops.values():
            op.launches = 0
        stamp("[trainer]'s planned task")
        models_phase(Rnd(0), MODELS_R, ops,
                     lambda: {n: op.launches for n, op in ops.items()},
                     smi, paths)
        stamp("[models]")
    print(json.dumps({"models_launches": {n: op.launches
                                          for n, op in ops.items()}}),
          flush=True)


# the [device_augment] phase: the training batches augmented on the card
DEVAUG_DEVICE = "cuda"
DEVAUG_RUN = ["--epochs", "2", "--batches", "3", "--val_batches", "1"]
DEVAUG_R = 20                   # timed calls per augmentation case
DEVAUG_HOST_BATCHES = 3
DEVAUG_ATOL = 1e-4
DEVAUG_TIE = 1e-4


def device_augment_phase(ops, counts, smi, paths, trainer=None):
    """[device_augment] the trainer's device_augment mode on [trainer]'s
    planned task, bf16, kernel DSFF at 0.2 as [trainer]:
    (b) cli/train.main --device_augment, 2 epochs of 3 + 1 batches, its
    validation left out: every loss finite, each step's launches
    kernel_launches_per_train_step (and, after [trainer], [trainer]'s per
    step), the training pipeline raw and the validation pipeline not; the
    host's wait per batch in next(tr_gen) beside [trainer]'s (trainer:
    its runs' mean waits after the first and per-step launches, None when
    run alone), the ms between CUDA events around _augment_on_device per
    batch in the loop and its host ms (the pinning, the upload and the
    enqueue).
    (a) ops/device_augment.py at (b)'s trainer's generator patch -> 128^3,
    batch 2, on raw batches of its sampler: one set of sampled params with
    rotation and scaling forced on and every other transform on, applied
    on the card and on the CPU with the same noise: data within
    DEVAUG_ATOL, targets equal but where a source coordinate lies within
    DEVAUG_TIE of a .5 (the count printed); ms per batch by CUDA events
    (mean of DEVAUG_R after a warm-up) of apply warped (both samples, no
    other transform), cropped, every transform on, and of the trainer's
    augmenter with fresh draws; beside it the host's augment_batch wall
    per batch of the same raw batches with the trainer's AugmentParams."""
    import dataclasses
    import os
    import torch
    from e2enet_tpu_torch import native
    from e2enet_tpu_torch.cli import train as tcli
    from e2enet_tpu_torch.data.augment import augment_batch
    from e2enet_tpu_torch.data.sampler import PatchSampler3D
    from e2enet_tpu_torch.ops import device_augment as da
    from e2enet_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    dev = DEVAUG_DEVICE

    # ---- (b) cli.train --device_augment
    os.environ["nnUNet_preprocessed"] = paths["preprocessed"]
    os.environ["RESULTS_FOLDER"] = paths["results"] + "_device_augment"
    runs, aug = [], {"events": [], "host": []}
    real_init, real_load = Trainer.initialize, Trainer.load_checkpoint_file
    real_aug = Trainer._augment_on_device
    init_spy, load_spy = trainer_spies("device_augment", ops, counts, runs,
                                       validate_runs=set())

    def aug_spy(self, batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = real_aug(self, batch)
        ev[1].record()
        aug["host"].append(time.perf_counter() - t0)
        aug["events"].append(ev)
        return out
    Trainer.initialize, Trainer.load_checkpoint_file = init_spy, load_spy
    Trainer._augment_on_device = aug_spy
    try:
        t0 = time.perf_counter()
        tcli.main(["--task", TRAIN_TASK, "--fold", "0", "--sparse", "True",
                   "--density", "0.2", "--update_frequency", "4",
                   "--device_augment", "--device", dev] + DEVAUG_RUN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.initialize, Trainer.load_checkpoint_file = \
            real_init, real_load
        Trainer._augment_on_device = real_aug
    check(len(runs) == 1, f"[device_augment] {len(runs)} trainers")
    run = runs[0]
    tr = run["trainer"]
    losses = [float(v) for v in run["losses"]]
    check(tr.device_augment and tr.tr_gen.gen.raw and not tr.val_gen.raw,
          "[device_augment] the training pipeline is not raw, or the "
          "validation pipeline is")
    check(len(losses) == 6 and len(aug["events"]) == 6 and all(
        np.isfinite(losses)) and all(
        np.isfinite(tr.all_tr_losses + tr.all_val_losses)),
        f"[device_augment] losses {losses}, epochs {tr.all_tr_losses} / "
        f"{tr.all_val_losses}, {len(aug['events'])} augmented batches")
    if trainer is not None:
        check(run["want"] == trainer["want"], f"[device_augment] launches "
              f"per step {run['want']} != [trainer]'s {trainer['want']}")
    ms = [a.elapsed_time(b) for a, b in run["events"]]
    aug_ms = [a.elapsed_time(b) for a, b in aug["events"]]
    waits = run["waits"]
    beside = ("[trainer] not run" if trainer is None else "[trainer]'s "
              f"runs {' '.join(f'{w:.3f}' for w in trainer['waits'])}")
    print(f"[device_augment] (b) cli.train --device_augment: {len(losses)} "
          f"steps, losses {' '.join(f'{v:.4f}' for v in losses)}; epoch "
          f"train / validation loss {tr.all_tr_losses} / "
          f"{tr.all_val_losses}; launches per step as [trainer]'s "
          f"({sum(run['want'].values())}); ms per step (CUDA events) "
          f"{' '.join(f'{v:.1f}' for v in ms)}, median after the first "
          f"{float(np.median(ms[1:])):.1f}; the augmentation per batch in "
          f"the loop: ms between CUDA events around it "
          f"{' '.join(f'{v:.2f}' for v in aug_ms)}, host ms (pinning, "
          f"upload and enqueue) "
          f"{' '.join(f'{1e3 * v:.2f}' for v in aug['host'])}; host wait "
          f"per batch in next(tr_gen) (s) "
          f"{' '.join(f'{v:.3f}' for v in waits)}, after the first: mean "
          f"{float(np.mean(waits[1:])):.3f} (host augmentation, mean after "
          f"the first: {beside}); {run['updates']} mask updates; cli.main "
          f"{wall:.1f} s  [{smi}]", flush=True)

    # ---- (a) the augmenter at the generator patch, batch 2
    patch = tuple(int(i) for i in tr.patch_size)
    in_patch = tuple(int(i) for i in tr.basic_generator_patch_size)
    sampler = PatchSampler3D(tr.dataset_tr, in_patch, patch, 2,
                             oversample_foreground_percent=0.33, seed=11)
    raws = [sampler.generate_train_batch()
            for _ in range(DEVAUG_HOST_BATCHES)]
    rng = np.random.RandomState(0)
    host_s = []
    for b in raws:
        t0 = time.perf_counter()
        augment_batch({"data": b["data"], "seg": b["seg"]}, tr.da_params,
                      rng)
        host_s.append(time.perf_counter() - t0)
    data = torch.from_numpy(raws[0]["data"])
    seg = torch.from_numpy(raws[0]["seg"][:, 0].astype(np.int8))
    B, C = data.shape[:2]
    on = np.ones(B, bool)
    p = da.sample_params(torch.Generator().manual_seed(0), B, C, patch,
                         p_rot=1.0, p_scale=1.0)
    p_all = dataclasses.replace(p, noise=on, blur=np.ones((B, C), bool),
                                bright=on, contrast=on, gamma_inv=on,
                                gamma=on)
    off = dict(noise=~on, blur=np.zeros((B, C), bool), bright=~on,
               contrast=~on, gamma_inv=~on, gamma=~on)
    p_warp = dataclasses.replace(p, **off)
    p_crop = dataclasses.replace(p_warp, warp=~on)
    noise = torch.randn((B, C) + patch,
                        generator=torch.Generator().manual_seed(1))
    d_cpu, s_cpu = da.apply(p_all, data, seg, noise)
    gd, gs, gn = data.to(dev), seg.to(dev), noise.to(dev)
    d_dev, s_dev = da.apply(p_all, gd, gs, gn)
    err = float((d_dev.cpu() - d_cpu).abs().max())
    near = np.zeros((B,) + patch, bool)
    for b in range(B):
        m, offset = da.affine(p.angles[b], p.scale[b], patch, in_patch)
        src = da.affine_coords(m, offset, patch).numpy()
        nb = (np.abs(src - np.floor(src) - 0.5) < DEVAUG_TIE).any(0)
        near[b] = np.flip(nb, [a for a in range(3) if p.flips[b, a]])
    differ = (s_dev.cpu() != s_cpu).numpy()
    check(err <= DEVAUG_ATOL and np.isfinite(d_cpu.numpy()).all(),
          f"[device_augment] data on the card vs the CPU: max abs err "
          f"{err:.3e}")
    check(not (differ & ~near).any(), f"[device_augment] {int(differ.sum())}"
          f" target voxels differ, {int((differ & ~near).sum())} away from "
          f".5 ties")
    times = {name: cuda_ms(lambda q=q: da.apply(q, gd, gs, gn), DEVAUG_R)
             for name, q in (("warped", p_warp), ("cropped", p_crop),
                             ("all on", p_all))}
    gen, noise_gen = (torch.Generator().manual_seed(2),
                      torch.Generator(device=dev).manual_seed(2))
    times["drawn"] = cuda_ms(lambda: tr.device_aug(gen, noise_gen, gd, gs),
                             DEVAUG_R)
    print(f"[device_augment] (a) apply at {B} x {in_patch} -> {patch}, "
          f"rotation and scaling forced on and every transform on: card vs "
          f"CPU max abs err {err:.3e} (limit {DEVAUG_ATOL:g}); target "
          f"voxels differing {int(differ.sum())} of {differ.size}, "
          f"{int(near.sum())} within {DEVAUG_TIE:g} of a .5; ms per batch "
          f"(CUDA events, mean of {DEVAUG_R}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; the host's augment_batch on the same raw batches (s per "
          f"batch, the warp's route {native.route()}) "
          f"{' '.join(f'{v:.3f}' for v in host_s)}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s  [{smi}]", flush=True)
    check("jax" not in sys.modules, "[device_augment] jax was imported")
    del gd, gs, gn, d_dev, s_dev, tr, runs
    torch.cuda.empty_cache()

def device_augment_only() -> None:
    """--device_augment: the build, [trainer]'s planned task and the
    [device_augment] phase alone (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_devaug_") as tmp:
        paths = plan_train_task(tmp, smi)
        for op in ops.values():
            op.launches = 0
        stamp("[trainer]'s planned task")
        device_augment_phase(ops, lambda: {n: op.launches
                                           for n, op in ops.items()},
                             smi, paths)
        stamp("[device_augment]")
    print(json.dumps({"device_augment_launches": {
        n: op.launches for n, op in ops.items()}}), flush=True)


# the [formats] phase: challenge downloads in the other formats converted
# to the raw layout, a VerSe tree reoriented to RAS and back, the converted
# task planned, and a fold packed and installed; host work with numpy and
# the standard library only (the card's machine has no PIL, h5py, pandas
# or matplotlib)
FORMATS_TASK = "Task024_Promise"
# PROMISE12 training MR volumes: (slices, rows, cols) and (x, y, z) mm
FORMATS_PROMISE = {"Case00": ((20, 256, 256), (0.625, 0.625, 3.6)),
                   "Case01": ((24, 320, 320), (0.5, 0.5, 3.0))}
FORMATS_DICOM = (24, 256, 256)  # one MR series: slices, rows, cols
FORMATS_VERSE = (96, 160, 128)  # one VerSe CT, PIR: (z, y, x) array
FORMATS_BASE = 8                # the packed fold's base width
# a PIR volume: data x runs to P, y to I, z to R (LPS direction columns)
PIR = (0.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0, -1.0, 0.0)


def write_dicom_slice(path, pix, position, instance, spacing=(1.2, 0.8),
                      orientation=(1, 0, 0, 0, 1, 0), slope=1.0,
                      intercept=0.0, explicit=True, part10=True):
    """One uncompressed DICOM slice of int16 pixels `pix` (rows, cols):
    with part10 a Part-10 file (128-byte preamble, 'DICM', the explicit-VR
    file meta group naming the transfer syntax) of explicit or implicit VR
    little endian; without, the bare implicit-VR dataset. The dataset
    opens with an undefined-length sequence of one item, which a reader
    skips. spacing is (row spacing, column spacing) in mm, position the
    first pixel's LPS position, orientation the row and column cosines."""
    import struct

    def elem(group, el, vr, value, expl=explicit):
        if len(value) % 2:
            value += b"\0" if vr == b"UI" else b" "
        head = struct.pack("<HH", group, el)
        if not expl:
            return head + struct.pack("<I", len(value)) + value
        if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
            return head + vr + b"\0\0" + struct.pack("<I", len(value)) + value
        return head + vr + struct.pack("<H", len(value)) + value

    def ds(*vals):
        return "\\".join(f"{float(v):.10g}" for v in vals).encode()

    def us(v):
        return struct.pack("<H", v)

    item = elem(0x0008, 0x1150, b"UI", b"1.2.840.10008.5.1.4.1.1.4")
    seq = (struct.pack("<HH", 0x0008, 0x1140)
           + (b"SQ\0\0" if explicit else b"")
           + struct.pack("<I", 0xFFFFFFFF)
           + struct.pack("<HHI", 0xFFFE, 0xE000, len(item)) + item
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    rows, cols = pix.shape
    body = b"".join([
        seq,
        elem(0x0018, 0x0050, b"DS", ds(spacing[0])),
        elem(0x0020, 0x0013, b"IS", str(instance).encode()),
        elem(0x0020, 0x0032, b"DS", ds(*position)),
        elem(0x0020, 0x0037, b"DS", ds(*orientation)),
        elem(0x0028, 0x0010, b"US", us(rows)),
        elem(0x0028, 0x0011, b"US", us(cols)),
        elem(0x0028, 0x0030, b"DS", ds(*spacing)),
        elem(0x0028, 0x0100, b"US", us(16)),
        elem(0x0028, 0x0103, b"US", us(1)),
        elem(0x0028, 0x1052, b"DS", ds(intercept)),
        elem(0x0028, 0x1053, b"DS", ds(slope)),
        elem(0x7FE0, 0x0010, b"OW", np.asarray(pix, "<i2").tobytes()),
    ])
    if part10:
        ts = b"1.2.840.10008.1.2.1" if explicit else b"1.2.840.10008.1.2"
        meta = elem(0x0002, 0x0010, b"UI", ts, True)
        meta = elem(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)),
                    True) + meta
        body = b"\0" * 128 + b"DICM" + meta + body
    else:
        assert not explicit, "a bare dataset is implicit VR"
    with open(path, "wb") as f:
        f.write(body)


def _mr_case(rng, shape):
    """A seeded MR-like volume (float32, a bright ellipsoid on a noisy
    body) and its label map (uint8, the ellipsoid), as PROMISE12's."""
    z, y, x = (np.linspace(-1, 1, s)[:, None, None] for s in shape)
    y, x = y.reshape(1, -1, 1), x.reshape(1, 1, -1)
    body = (y ** 2 + x ** 2) < 0.8
    gland = (z ** 2 / 0.5 + (y - 0.1) ** 2 / 0.08 + x ** 2 / 0.1) < 1
    vol = (300.0 * body + 250.0 * gland
           + 40.0 * rng.randn(*shape)).astype(np.float32)
    return vol, gland.astype(np.uint8)


def _ras_world_check(tag, new, src):
    """Every voxel of `new` equals the voxel of `src` at the same world
    position (both NiftiImages, their RAS affines a permutation with
    signs of each other)."""
    from e2enet_tpu_torch.preprocessing.reorientation import ras_affine
    a_new, a_src = ras_affine(new), ras_affine(src)
    # new (x, y, z) index -> world -> src (x, y, z) index
    T = np.linalg.solve(a_src, a_new)
    R = np.rint(T[:3, :3]).astype(int)
    t = np.rint(T[:3, 3]).astype(int)
    check(np.allclose(T[:3, :3], R, atol=1e-6)
          and np.allclose(T[:3, 3], t, atol=1e-4),
          f"[formats] {tag}: the voxel grids are not a permutation")
    idx = np.indices(new.array.shape[::-1]).reshape(3, -1)
    src_idx = R @ idx + t[:, None]
    got = new.array.transpose(2, 1, 0).reshape(-1)
    want = src.array.transpose(2, 1, 0)[tuple(src_idx)]
    check(np.array_equal(got, want), f"[formats] {tag}: a voxel moved")


def formats_phase(base, smi):
    """[formats] host work with numpy and the standard library, in
    folders under `base`:
    (a) a PROMISE12 download (train/ Case00 .mhd + .raw, Case01 .mhd +
        zlib .zraw, each with its _segmentation.mhd; test/ one case)
        converted by convert_promise2012; every voxel and the geometry of
        each converted image and label against its source;
    (b) a DICOM series (FORMATS_DICOM, implicit VR, written out of order,
        half of the files without an extension, one text file beside
        them) read by read_dicom_series: every voxel the rescaled source
        in position order, the spacing and origin the series';
    (c) that volume written as NRRD (gzip and raw) and read back equal;
    (d) a VerSe2019 download (one PIR CT with its labels for training,
        one for testing) converted by convert_verse2019, which reorients
        each to RAS (its axis codes, every voxel at its world position),
        then reverted: every voxel and the geometry the source's;
    (e) `python -m e2enet_tpu_torch.cli.plan_and_preprocess -t 24
        --verify_dataset_integrity` on the converted task in a fresh
        process: exit 0, a plan and both cases' stage files;
    (f) a fold at that plan (ShiftUNet++, FORMATS_BASE base features,
        random weights from seed 0) written by save_checkpoint, packed by
        export_pretrained_model, installed by install_model_from_zip_file
        into a fresh RESULTS_FOLDER: the installed files equal the packed
        ones, and ModelBundle restores the fold's weights on the CPU.
    Prints each step's seconds; checks that jax was not imported.
    Returns the phase's seconds."""
    import os
    import zipfile
    from unittest import mock
    import torch
    from e2enet_tpu_torch.dataset_conversion.tasks_extra import (
        convert_promise2012, convert_verse2019)
    from e2enet_tpu_torch.inference.predictor import ModelBundle
    from e2enet_tpu_torch.inference.pretrained_models import (
        export_pretrained_model, install_model_from_zip_file)
    from e2enet_tpu_torch.io.dicom import read_dicom_series
    from e2enet_tpu_torch.io.metaimage import read_mhd, write_mhd
    from e2enet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
    from e2enet_tpu_torch.io.nrrd import read_nrrd, write_nrrd
    from e2enet_tpu_torch.models.unetpp import build_network
    from e2enet_tpu_torch.models.weights import to_jax_params
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.preprocessing.reorientation import (
        aff2axcodes, ras_affine, revert_orientation_on_all_images_in_folder)
    from e2enet_tpu_torch.training.checkpoint import save_checkpoint
    from e2enet_tpu_torch.utils.files import load_json
    t_phase = time.perf_counter()
    seconds = {}
    rng = np.random.RandomState(24)
    raw = os.path.join(base, "raw")
    os.makedirs(os.path.join(raw, "nnUNet_raw_data"))

    def same_geometry(a, b):
        return all(np.allclose(getattr(a, k), getattr(b, k), atol=1e-6)
                   for k in ("spacing", "origin", "direction"))

    # ---- (a) PROMISE12, MetaImage
    t0 = time.perf_counter()
    src = os.path.join(base, "promise")
    for sub in ("train", "test"):
        os.makedirs(os.path.join(src, sub))
    sources = {}
    for i, (case, (shape, spacing)) in enumerate(FORMATS_PROMISE.items()):
        vol, seg = _mr_case(rng, shape)
        geom = dict(spacing=spacing, origin=(-80.5 - i, -92.25, -30.0 * i))
        sources[case] = (vol, seg, geom)
        write_mhd(os.path.join(src, "train", f"{case}.mhd"),
                  NiftiImage(vol, **geom), compressed=i == 1)
        write_mhd(os.path.join(src, "train", f"{case}_segmentation.mhd"),
                  NiftiImage(seg, **geom), compressed=i == 1)
    test_vol = _mr_case(rng, FORMATS_PROMISE["Case00"][0])[0]
    write_mhd(os.path.join(src, "test", "Case10.mhd"),
              NiftiImage(test_vol, (0.625, 0.625, 3.6)))
    seconds["promise_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, nnUNet_raw_data_base=raw):
        out = convert_promise2012(src)
    seconds["promise_convert"] = time.perf_counter() - t0
    check(os.path.basename(out) == FORMATS_TASK,
          f"[formats] PROMISE12 converted to {out}")
    for case, (vol, seg, geom) in sources.items():
        img = read_nifti(os.path.join(out, "imagesTr", f"{case}_0000.nii.gz"))
        lab = read_nifti(os.path.join(out, "labelsTr", f"{case}.nii.gz"))
        want = NiftiImage(vol, **geom)
        check(img.array.dtype == np.float32 and np.array_equal(img.array, vol)
              and lab.array.dtype == np.uint8 and np.array_equal(lab.array,
                                                                  seg),
              f"[formats] PROMISE12 {case}: a voxel differs from its .mhd")
        check(same_geometry(img, want) and same_geometry(lab, want),
              f"[formats] PROMISE12 {case}: geometry {img.geometry}")
    test = read_nifti(os.path.join(out, "imagesTs", "Case10_0000.nii.gz"))
    check(np.array_equal(test.array, test_vol), "[formats] PROMISE12 Case10")
    ds = load_json(os.path.join(out, "dataset.json"))
    check(ds["numTraining"] == 2 and ds["numTest"] == 1
          and ds["labels"] == {"0": "background", "1": "prostate"},
          f"[formats] PROMISE12 dataset.json {ds}")
    n_vox = sum(int(np.prod(s)) for s, _ in FORMATS_PROMISE.values())
    print(f"[formats] (a) PROMISE12 .mhd/.raw and .mhd/.zraw -> "
          f"{FORMATS_TASK}: {len(sources)} training cases "
          f"{[s for s, _ in FORMATS_PROMISE.values()]} + 1 test, {n_vox} "
          f"training voxels each equal to its source, geometry held; "
          f"written in {seconds['promise_write']:.2f} s, converted in "
          f"{seconds['promise_convert']:.2f} s", flush=True)

    # ---- (b) a DICOM series, (c) the same volume as NRRD
    t0 = time.perf_counter()
    series = os.path.join(base, "dicom")
    os.makedirs(series)
    n, rows, cols = FORMATS_DICOM
    pix = (rng.randint(0, 1600, (n, rows, cols))).astype(np.int16)
    origin, dz, slope, intercept = (-120.0, -135.5, 40.0), 3.3, 1.0, -20.0
    for z in rng.permutation(n):
        name = f"IM{z:04d}" + (".dcm" if z % 2 else "")
        write_dicom_slice(os.path.join(series, name), pix[z],
                          (origin[0], origin[1], origin[2] + dz * z),
                          int(z) + 1, spacing=(0.9, 0.8), slope=slope,
                          intercept=intercept, explicit=False)
    with open(os.path.join(series, "notes.txt"), "w") as f:
        f.write("not a slice\n")
    seconds["dicom_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vol = read_dicom_series(series)
    seconds["dicom_read"] = time.perf_counter() - t0
    want = pix.astype(np.float32) * slope + intercept
    check(vol.array.dtype == np.float32 and np.array_equal(vol.array, want),
          "[formats] DICOM: a voxel differs from its slice")
    check(np.allclose(vol.spacing, (0.8, 0.9, dz))
          and np.allclose(vol.origin, origin)
          and np.allclose(vol.direction, np.eye(3).reshape(-1)),
          f"[formats] DICOM geometry {vol.geometry}")
    t0 = time.perf_counter()
    for compressed in (True, False):
        p = os.path.join(base, f"dicom_{compressed}.nrrd")
        write_nrrd(p, vol, compressed=compressed)
        back = read_nrrd(p)
        check(back.array.dtype == np.float32
              and np.array_equal(back.array, vol.array)
              and same_geometry(back, vol),
              f"[formats] NRRD (gzip {compressed}) differs from its source")
    seconds["nrrd"] = time.perf_counter() - t0
    print(f"[formats] (b) DICOM series {FORMATS_DICOM}, implicit VR, "
          f"written out of order, half without an extension: every voxel "
          f"the rescaled slice, spacing {tuple(vol.spacing)}; written in "
          f"{seconds['dicom_write']:.2f} s, read in "
          f"{seconds['dicom_read']:.2f} s; (c) NRRD gzip and raw written "
          f"and read back equal in {seconds['nrrd']:.2f} s", flush=True)

    # ---- (d) VerSe2019: reoriented to RAS, then back
    t0 = time.perf_counter()
    verse = os.path.join(base, "verse")
    for sub in ("train", "test"):
        os.makedirs(os.path.join(verse, sub))
    ct = (rng.randn(*FORMATS_VERSE) * 300.0 + 100.0).astype(np.float32)
    labels = rng.randint(0, 26, FORMATS_VERSE).astype(np.uint8)
    ct_test = (rng.randn(*FORMATS_VERSE) * 300.0).astype(np.float32)
    geom = dict(spacing=(1.0, 1.25, 0.8), origin=(40.0, -60.5, 210.0),
                direction=PIR)
    originals = {("imagesTr", "verse004_0000"): NiftiImage(ct, **geom),
                 ("labelsTr", "verse004"): NiftiImage(labels, **geom),
                 ("imagesTs", "verse005_0000"): NiftiImage(ct_test, **geom)}
    write_nifti(os.path.join(verse, "train", "verse004.nii.gz"),
                originals[("imagesTr", "verse004_0000")])
    write_nifti(os.path.join(verse, "train", "verse004_seg.nii.gz"),
                originals[("labelsTr", "verse004")])
    write_nifti(os.path.join(verse, "test", "verse005.nii.gz"),
                originals[("imagesTs", "verse005_0000")])
    seconds["verse_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, nnUNet_raw_data_base=raw):
        vout = convert_verse2019(verse)
    seconds["verse_convert"] = time.perf_counter() - t0
    codes = set()
    for (sub, name), src_img in originals.items():
        p = os.path.join(vout, sub, name + ".nii.gz")
        img = read_nifti(p)
        codes.add(aff2axcodes(ras_affine(img)))
        check(os.path.isfile(p[:-7] + "_originalAffine.pkl"),
              f"[formats] VerSe {name}: no sidecar")
        _ras_world_check(f"VerSe {name}", img, src_img)
    check(codes == {("R", "A", "S")}, f"[formats] VerSe axis codes {codes}")
    t0 = time.perf_counter()
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        revert_orientation_on_all_images_in_folder(os.path.join(vout, sub))
    seconds["verse_revert"] = time.perf_counter() - t0
    for (sub, name), src_img in originals.items():
        p = os.path.join(vout, sub, name + ".nii.gz")
        img = read_nifti(p)
        check(img.array.dtype == src_img.array.dtype
              and np.array_equal(img.array, src_img.array)
              and same_geometry(img, src_img)
              and not os.path.isfile(p[:-7] + "_originalAffine.pkl"),
              f"[formats] VerSe {name}: the reverted image is not its "
              f"source")
    print(f"[formats] (d) VerSe2019 PIR {FORMATS_VERSE} -> RAS, every "
          f"voxel at its world position, then reverted equal to the source "
          f"(3 images); written in {seconds['verse_write']:.2f} s, converted "
          f"and reoriented in {seconds['verse_convert']:.2f} s, reverted in "
          f"{seconds['verse_revert']:.2f} s", flush=True)

    # ---- (e) the plan CLI on the converted PROMISE12 task
    pre = os.path.join(base, "preprocessed")
    argv = ["-t", "24", "--verify_dataset_integrity"]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "e2enet_tpu_torch.cli.plan_and_preprocess"]
        + argv, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, nnUNet_raw_data_base=raw,
                 nnUNet_preprocessed=pre),
        capture_output=True, text=True, timeout=600)
    seconds["plan_cli"] = time.perf_counter() - t0
    check(r.returncode == 0, f"[formats] the plan CLI exited "
          f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
    plans = Plans.load(os.path.join(pre, FORMATS_TASK,
                                    "nnUNetPlansv2.1_plans_3D.json"))
    stage = plans.plans_per_stage[plans.num_stages - 1]
    stage_dir = os.path.join(pre, FORMATS_TASK, plans.data_identifier
                             + f"_stage{plans.num_stages - 1}")
    check(all(os.path.isfile(os.path.join(stage_dir, f"{c}.npz"))
              for c in FORMATS_PROMISE),
          f"[formats] the plan CLI wrote no stage files in {stage_dir}")
    print(f"[formats] (e) python -m e2enet_tpu_torch.cli.plan_and_preprocess "
          f"{' '.join(argv)}: exit 0 in {seconds['plan_cli']:.2f} s; "
          f"{plans.num_stages} stage(s), patch {stage.patch_size}, pools "
          f"{stage.pool_op_kernel_sizes}, normalisation "
          f"{plans.normalization_schemes}", flush=True)

    # ---- (f) a fold packed into a zip and installed
    t0 = time.perf_counter()
    results = os.path.join(base, "results")
    folder = os.path.join(results, "nnUNet", "3d_fullres", FORMATS_TASK,
                          "TPUTrainer__nnUNetPlansv2.1")
    os.makedirs(os.path.join(folder, "fold_0"))
    net = build_network(stage, 1, plans.num_classes + 1,
                        base_num_features=FORMATS_BASE,
                        compute_dtype=torch.float32, device="cpu")
    net.reset_parameters(seed=0)
    params = to_jax_params(net.state_dict())
    save_checkpoint(
        os.path.join(folder, "fold_0",
                     "shiftConvPP_model_final_checkpoint.model"),
        params, 1000,
        sidecar={"init": {"fold": 0, "stage": plans.num_stages - 1,
                          "tconv": "shiftConvPP",
                          "base_num_features": FORMATS_BASE,
                          "cascade": False},
                 "name": "TPUTrainer", "class": "TPUTrainer",
                 "plans": plans.to_dict()})
    plans.save(os.path.join(folder, "plans.json"))
    zip_file = os.path.join(base, f"{FORMATS_TASK}.zip")
    with mock.patch.dict(os.environ, RESULTS_FOLDER=results):
        export_pretrained_model(FORMATS_TASK, zip_file, folds=(0,))
    installed = os.path.join(base, "installed")
    with mock.patch.dict(os.environ, RESULTS_FOLDER=installed):
        install_model_from_zip_file(zip_file)
    with zipfile.ZipFile(zip_file) as zf:
        members = zf.namelist()
        for m in members:
            with open(os.path.join(installed, "nnUNet", m), "rb") as f, \
                    open(os.path.join(results, "nnUNet", m), "rb") as g:
                packed = zf.read(m)
                check(f.read() == packed == g.read(),
                      f"[formats] {m}: installed bytes differ")
    check(len(members) == 3, f"[formats] zip members {members}")
    bundle = ModelBundle(folder.replace(results, installed), [0],
                         "shiftConvPP", compute_dtype=torch.float32,
                         device="cpu")
    got = to_jax_params(bundle.fold_models[0].state_dict())

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)
    got = dict(leaves(got))
    check(all(np.array_equal(got[k], v) for k, v in leaves(params)),
          "[formats] the installed fold's weights differ")
    seconds["pack_install"] = time.perf_counter() - t0
    print(f"[formats] (f) a base-{FORMATS_BASE} fold at that plan packed by "
          f"export_pretrained_model ({len(members)} members, "
          f"{os.path.getsize(zip_file)} bytes), installed by "
          f"install_model_from_zip_file: the installed files equal the "
          f"packed ones; ModelBundle restored its weights on the CPU; "
          f"{seconds['pack_install']:.2f} s", flush=True)
    check("jax" not in sys.modules, "[formats] jax was imported")
    total = time.perf_counter() - t_phase
    print(f"[formats] the phase took {total:.1f} s (host only, no kernel "
          f"launched)  [{smi}]", flush=True)
    return total


def formats_only() -> None:
    """--formats: the [formats] phase alone (no kernel is built: the phase
    launches none)."""
    import tempfile
    import torch
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as tmp:
        seconds = formats_phase(tmp, smi)
    print(json.dumps({"formats_seconds": seconds}), flush=True)


def bench_phase(smi):
    """[bench] python -m e2enet_tpu_torch.bench at its defaults (the sparse
    model, fast mode) in a subprocess: exit 0 and a last stdout line with
    the reference's four keys. Echoes that line and the stderr summary."""
    from pathlib import Path
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "e2enet_tpu_torch.bench"],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=900)
    for line in r.stderr.splitlines():
        if any(k in line for k in ("group:", "sliding-window:", "exact-f32",
                                   "per forward:", "masks from", "plan:",
                                   "Error", "error")):
            print(f"[bench] {line.strip()}", flush=True)
    check(r.returncode == 0, f"[bench] exit {r.returncode}: "
          f"{r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    check(len(lines) == 1, f"[bench] {len(lines)} stdout lines")
    out = json.loads(lines[-1])
    check(list(out) == ["metric", "value", "unit", "vs_baseline"]
          and out["unit"].startswith("128^3_patches_per_sec_per_chip_tta8"
                                     "_rowsparse") and out["value"] > 0,
          f"[bench] line {out}")
    print(f"[bench] {lines[-1]}  ({time.time() - t0:.1f} s)  [{smi}]",
          flush=True)
    return out


def host_only() -> None:
    """--host-ms: the host's time per call (host_ms) of the up-link (#6)
    and the seg head (#10 probs, #9 logits) wrappers at the bench's shapes
    with the model's bf16 weights, HOST_READINGS readings of HOST_CALLS
    calls each, the cases in turns; prints their median and quartiles. It
    imports e2enet_tpu_torch from the directory it runs in, so a copy of
    this script run in another checkout reads that checkout's wrappers
    (the same measurement for a commit and its parent)."""
    import torch
    from e2enet_tpu_torch.ops import _native, qlink
    _native.build_all()
    rnd = Rnd(0)
    bf = torch.bfloat16
    x6 = rnd(1, 64, 64, 64, 96).to(bf)
    m6, o6 = rnd.affine(1, 96)
    k6 = rnd(96, 48, 2, 2, 2, scale=96 ** -0.5).to(bf)
    x10 = rnd(1, 128, 128, 128, 48).to(bf)
    m10, o10 = rnd.affine(1, 48)
    w10 = rnd(16, 48, scale=(2.0 / 48) ** 0.5).to(bf)
    cases = {
        "uplink": lambda: qlink.uplink(x6, m6, o6, k6),
        "uplink_flips": lambda: qlink.uplink(x6, m6, o6, k6,
                                             (True, False, True)),
        "seghead_probs": lambda: qlink.seghead(x10, m10, o10, w10, bf),
        "seghead_logits": lambda: qlink.seghead(x10, m10, o10, w10)}
    got = {k: [] for k in cases}
    with torch.inference_mode():
        for _ in range(HOST_READINGS):
            for k, fn in cases.items():
                got[k].append(host_ms(fn))
    out = {k: dict(zip(("q1", "median", "q3"),
                       (float(v) for v in np.percentile(r, (25, 50, 75)))))
           for k, r in got.items()}
    print(json.dumps({"host_ms": out, "calls": HOST_CALLS,
                      "readings": HOST_READINGS, "card": nvidia_smi_line()}),
          flush=True)


def trainer_only() -> None:
    """--trainer: the build and the [trainer] phase alone (its launches
    printed as JSON), to iterate on the training path."""
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}

    def reset_counts():
        for op in ops.values():
            op.launches = 0
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    total = trainer_phase(ops, reset_counts,
                          lambda: {n: op.launches for n, op in ops.items()},
                          smi)
    print(json.dumps({"trainer_launches": total}), flush=True)


def options_only() -> None:
    """--options: the build, [trainer]'s planned task and the [options]
    phase alone (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    for op in ops.values():
        op.launches = 0
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as tmp:
        paths = plan_train_task(tmp, smi)
        options_phase(ops, lambda: {n: op.launches for n, op in ops.items()},
                      smi, paths)
    print(json.dumps({"options_launches": {n: op.launches
                                           for n, op in ops.items()}}),
          flush=True)


def dsff_only() -> None:
    """--dsff: the build, [trainer]'s planned task and the [dsff] phase
    alone (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    for op in ops.values():
        op.launches = 0
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dsff_") as tmp:
        paths = plan_train_task(tmp, smi)
        dsff_phase(ops, lambda: {n: op.launches for n, op in ops.items()},
                   smi, paths)
    print(json.dumps({"dsff_launches": {n: op.launches
                                        for n, op in ops.items()}}),
          flush=True)


def twod_only() -> None:
    """--2d: the build, [trainer]'s planned task and the [2d] phase alone
    (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    for op in ops.values():
        op.launches = 0
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_2d_") as tmp:
        paths = plan_train_task(tmp, smi)
        for op in ops.values():
            op.launches = 0
        twod_phase(Rnd(0), 20, ops,
                   lambda: {n: op.launches for n, op in ops.items()}, smi,
                   paths)
    print(json.dumps({"2d_launches": {n: op.launches
                                      for n, op in ops.items()}}),
          flush=True)


def cascade_only() -> None:
    """--cascade: the build, [trainer]'s planned task and the [cascade]
    phase alone (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cascade_") as tmp:
        paths = plan_train_task(tmp, smi)
        for op in ops.values():
            op.launches = 0
        cascade_phase(Rnd(0), 20, ops,
                      lambda: {n: op.launches for n, op in ops.items()}, smi,
                      paths)
    print(json.dumps({"cascade_launches": {n: op.launches
                                           for n, op in ops.items()}}),
          flush=True)


def variants_only() -> None:
    """--variants: the build, [trainer]'s planned task and the [variants]
    phase alone (its launches printed as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as tmp:
        paths = plan_train_task(tmp, smi)
        for op in ops.values():
            op.launches = 0
        stamp("[trainer]'s planned task")
        variants_phase(Rnd(0), 20, ops,
                       lambda: {n: op.launches for n, op in ops.items()},
                       smi, paths)
        stamp("[variants]")
    print(json.dumps({"variants_launches": {n: op.launches
                                            for n, op in ops.items()}}),
          flush=True)


def ensembles_only() -> None:
    """--ensembles: the build, [trainer]'s planned task, the two folds
    (ensemble_folds) and the [ensembles] phase alone (its launches printed
    as JSON)."""
    import tempfile
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}

    def counts():
        return {n: op.launches for n, op in ops.items()}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ensembles_") as tmp:
        paths = plan_train_task(tmp, smi)
        ensemble_folds(paths, ops, counts, smi)
        stamp("[trainer]'s planned task and the two folds")
        for op in ops.values():
            op.launches = 0
        ensembles_phase(ops, counts, smi, paths)
        stamp("[ensembles]")
    print(json.dumps({"ensembles_launches": counts()}), flush=True)


# the [parallel] phase: data-parallel training and tile-sharded prediction
# (parallel/mesh.py) at the bench width, through the users' entry points;
# this host has one card, so (a) runs a world of one NCCL rank and (b), (c)
# two gloo ranks on cuda:0
PARALLEL_DENSITY = 0.2           # kernel-granular DSFF masks
PARALLEL_STEPS = 3               # (a)'s steps each way; the first warms up
# (b)'s Trainer steps; the second ends in a mask update (update_frequency)
PARALLEL_TRAINER_STEPS = 2
PARALLEL_LOSS_RTOL = 1e-3
# 128 x 128 x 256: tiles at depths 0, 64 and 128 of the last axis, so the
# ranks take two tiles and one
PARALLEL_VOLUME = (128, 128, 256)
# predict_from_folder's input: one case of that size, (z, y, x), at the
# plan's spacing (no resampling)
PARALLEL_CASE = {"case_000": ((256, 128, 128), (1.0, 1.0, 1.0))}
# the plain path's max |dp|, the kernel path's mean |dp| (two runs of the
# kernel path on one device differ: its statistics sum by atomics)
PARALLEL_PROB_ATOL = 1e-3
PARALLEL_AGREE = 0.995


def parallel_model(dtype=None):
    """The bench-width train model with kernel masks at PARALLEL_DENSITY:
    (model, train state, ds weights), all from seeds."""
    import torch
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    from e2enet_tpu_torch.training import dsff
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.models.unetpp import ds_loss_weights
    from e2enet_tpu_torch.training.train_state import create_train_state
    model = ShiftUNetPlusPlus(1, tbm.NUM_CLASSES, tbm.POOLS,
                              compute_dtype=dtype or torch.bfloat16,
                              device="cuda")
    model.reset_parameters(seed=tbm.SEED)
    masks = dsff.init_masks(model, PARALLEL_DENSITY,
                            torch.Generator().manual_seed(tbm.SEED + 1))
    masks = {k: v.cuda() for k, v in masks.items()}
    state = create_train_state(model, masks, seed=tbm.SEED)
    return model, state, ds_loss_weights(len(tbm.POOLS),
                                         model.num_ds_outputs())


def parallel_batch(patch, n_out, seed=3):
    """One seeded synthetic batch of two at `patch`, on the card."""
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    return tbm.device_batches(np.random.RandomState(seed), 1, 2, patch,
                              n_out, "cuda")[0]


def parallel_volume():
    return np.random.RandomState(11).randn(1, *PARALLEL_VOLUME).astype(
        np.float32)


def parallel_launches(ops, fn, *a, **k):
    """(fn(*a, **k), the kernel launches it made in this process)."""
    import torch
    before = {n: op.launches for n, op in ops.items()}
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, {n: op.launches - before[n] for n, op in ops.items()}


def parallel_trainer(out_dir, num_devices, ops, spatial_parallel=1):
    """Trainer(num_devices=..., spatial_parallel=...) at the bench plan
    (one stage of 128^3 patches, batch 2, five pools, 16 classes, 48
    features, bf16), dummy batches, kernel DSFF at PARALLEL_DENSITY
    updated every 2 steps: initialize, then PARALLEL_TRAINER_STEPS
    run_iteration calls. Returns each step's loss and launches, the
    launches a step should make, and the masks and parameters after the
    steps (on the CPU)."""
    import torch
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_train_step
    from e2enet_tpu_torch.training.dsff import DSFFConfig
    from e2enet_tpu_torch.training.trainer import Trainer
    tr = Trainer(predict_plans(48), 0, out_dir, dummy_load=True,
                 device="cuda", num_devices=num_devices,
                 spatial_parallel=spatial_parallel, max_num_epochs=10,
                 num_batches_per_epoch=2, num_val_batches_per_epoch=1,
                 dsff_config=DSFFConfig(sparse=True,
                                        density=PARALLEL_DENSITY,
                                        update_frequency=2))
    tr.initialize(True)
    per = kernel_launches_per_train_step(tr.network,
                                         spatial=tr.spatial_parallel)
    out = {"want": {k: per["forward"].get(k, 0) + per["backward"].get(k, 0)
                    for k in ops}, "losses": [], "launches": []}
    for _ in range(PARALLEL_TRAINER_STEPS):
        loss, got = parallel_launches(ops, tr.run_iteration, tr.tr_gen,
                                      tr.initial_lr, True)
        out["losses"].append(float(loss))
        out["launches"].append(got)
    out["masks"] = torch.cat([m.flatten().float()
                              for m in tr.state.masks.values()]).cpu()
    out["params"] = torch.cat([p.detach().flatten().float()
                               for p in tr.state.params.values()]).cpu()
    out["step"] = int(tr.state.step)
    del tr
    torch.cuda.empty_cache()
    return out


def probs_gap(a, b):
    """(max |dp|, mean |dp|, argmax agreement) of two probability
    volumes."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d = np.abs(a - b)
    return (float(d.max()), float(d.mean()),
            float((a.argmax(0) == b.argmax(0)).mean()))


def parallel_predictions(ops, folder, inputs, out, num_devices,
                         shapes=None):
    """The entry points of prediction on the model folder, num_devices
    ranks (1: this device): predict_case on the seeded volume in the fast
    mode (all_in_gpu, the sparse plan) on the kernel path and on every
    kernel site's plain version, and predict_from_folder on the input
    folder (labels written; the padded network shape of each volume its
    predict_case takes appended to `shapes`). Returns (kernel probs, plain
    probs, launches of the kernel predict_case, launches of
    predict_from_folder, written files)."""
    import torch
    from e2enet_tpu_torch.inference import predictor
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.sliding import pad_volume_to_patch
    bundle = predictor.ModelBundle(folder, None, "shiftConvPP",
                                   device="cuda")
    vol = parallel_volume()
    with torch.inference_mode():
        probs, launches = parallel_launches(
            ops, predictor.predict_case, bundle, vol, all_in_gpu=True,
            num_devices=num_devices)
        with blocks.plain_ops():
            plain = predictor.predict_case(bundle, vol, all_in_gpu=True,
                                           num_devices=num_devices)
        del bundle
        real_case = predictor.predict_case

        def spy(bundle, data, *a, **k):
            if shapes is not None:
                shapes.append(pad_volume_to_patch(
                    data, bundle.patch_size)[0].shape[1:])
            return real_case(bundle, data, *a, **k)
        predictor.predict_case = spy
        try:
            files, folder_launches = parallel_launches(
                ops, predictor.predict_from_folder, folder, inputs, out,
                None, False, all_in_gpu=True, num_devices=num_devices,
                device="cuda")
        finally:
            predictor.predict_case = real_case
    torch.cuda.empty_cache()
    return probs, plain, launches, folder_launches, files


def parallel_rank(folder, inputs, out):
    """One of two gloo ranks on cuda:0: (b) the sharded gradient on
    2 x 64^3 (make_grad_step, as the trainer's gradient growth takes it),
    then Trainer(num_devices=2) on its rows of the dummy batches; (c)
    predict_case(num_devices=2) and predict_from_folder(num_devices=2)."""
    import os
    import torch
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.parallel import mesh
    from e2enet_tpu_torch.training.train_state import make_grad_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    group = mesh.data_group(2)
    main = mesh.rank() == 0
    res = {"backend": torch.distributed.get_backend(group), "s": {}}
    t0 = time.perf_counter()

    def lap(name):
        torch.cuda.synchronize()
        res["s"][name] = round(time.perf_counter() - t0 - sum(
            res["s"].values()), 2)
    model, state, weights = parallel_model()
    data, targets = mesh.shard_batch(*parallel_batch(
        GRAD_PATCH, model.num_ds_outputs(), seed=5))
    g = make_grad_step(model, weights, group=group)(data, targets)
    res["grads"] = torch.cat([v.float().flatten() for v in g.values()]
                             ).cpu() if main else None
    del g, model, state, data, targets
    torch.cuda.empty_cache()
    lap("gradient")
    res["trainer"] = parallel_trainer(os.path.join(out, "trainer_two"), 2,
                                      ops)
    lap("trainer")
    probs, plain, res["predict_launches"], res["folder_launches"], \
        res["files"] = parallel_predictions(
            ops, folder, inputs, os.path.join(out, "out_two"), 2)
    res["probs"] = (probs, plain) if main else None
    lap("prediction")
    return res


def parallel_phase(ops, counts, smi):
    """[parallel]: (a) a world of one NCCL rank, sharded train steps
    against the single-device steps; two gloo ranks on the one card: (b)
    the sharded gradient against one device's and a float32 plain run, and
    Trainer(num_devices=2) against Trainer on one device; (c)
    predict_case(num_devices=2) and predict_from_folder(num_devices=2)
    against one device's; (d) the predict CLI asking for two cards.
    Returns the kernel launches of the sharded runs (both ranks summed)."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from e2enet_tpu_torch.cli import predict as cli_predict
    from e2enet_tpu_torch.inference import predictor
    from e2enet_tpu_torch.io.nifti import read_nifti
    from e2enet_tpu_torch.models.unetpp import (
        ShiftUNetPlusPlus, kernel_launches_per_forward,
        kernel_launches_per_train_step)
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.ops.sliding import compute_steps_for_sliding_window
    from e2enet_tpu_torch.parallel import mesh
    from e2enet_tpu_torch.training import train_bench_masks as tbm
    from e2enet_tpu_torch.training.train_state import (
        create_train_state, make_sharded_train_step, make_train_step)
    t_phase = time.perf_counter()
    total = {k: 0 for k in ops}

    def add(got):
        for k, v in got.items():
            total[k] += v

    # ---- (a) NCCL, world size 1
    model, state, weights = parallel_model()
    per = kernel_launches_per_train_step(model)
    want = {k: per["forward"].get(k, 0) + per["backward"].get(k, 0)
            for k in ops}
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_out = model.num_ds_outputs()
    batches = [parallel_batch(PATCH, n_out, seed=s)
               for s in range(3, 3 + PARALLEL_STEPS)]

    def steps(step_fn, st):
        losses, ms = [], []
        for i, (data, targets) in enumerate(batches):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            before = counts()
            start.record()
            st, metrics = step_fn(st, data, targets, 0.01)
            end.record()
            torch.cuda.synchronize()
            got = {k: counts()[k] - before[k] for k in ops}
            check(got == want, f"[parallel] step {i + 1}: launches {got} "
                  f"!= {want}")
            losses.append(float(metrics["loss"]))
            ms.append(start.elapsed_time(end))
        return losses, ms

    single, ms_single = steps(make_train_step(model, weights), state)
    model.load_state_dict(init)
    state = create_train_state(model, state.masks, seed=tbm.SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        mesh.init_group(0, 1, "nccl", "file://" + tmp + "/rendezvous")
        try:
            backend = dist.get_backend()
            before = counts()
            sharded, ms_sharded = steps(make_sharded_train_step(
                model, weights), state)
            add({k: counts()[k] - before[k] for k in ops})
        finally:
            mesh.destroy_group()
    err = max(abs(a - b) / abs(b) for a, b in zip(sharded, single))
    print(f"[parallel] (a) {backend}, world size 1: {PARALLEL_STEPS} "
          f"sharded steps at 2 x {PATCH[0]}^3 (kernel DSFF "
          f"{PARALLEL_DENSITY}), "
          f"losses {[round(v, 6) for v in sharded]} against the "
          f"single-device steps' {[round(v, 6) for v in single]} (max rel "
          f"{err:.2e}); ms per step {[round(v, 2) for v in ms_sharded]} "
          f"(steps 2-{PARALLEL_STEPS}: {np.mean(ms_sharded[1:]):.2f}) "
          f"against {[round(v, 2) for v in ms_single]} "
          f"({np.mean(ms_single[1:]):.2f}); launches per step {want}  "
          f"[{smi}]", flush=True)
    check(backend == "nccl", f"[parallel] (a) backend {backend}")
    check(err <= PARALLEL_LOSS_RTOL, f"[parallel] (a) losses {sharded} vs "
          f"{single}")

    # (b)'s gradient references on 2 x 64^3: the kernel path on the whole
    # batch and a float32 plain run
    model.load_state_dict(init)
    data, targets = parallel_batch(GRAD_PATCH, n_out, seed=5)
    g_one = loss_grads(model, data, targets, weights)
    with blocks.plain_ops():
        model32 = ShiftUNetPlusPlus(1, tbm.NUM_CLASSES, tbm.POOLS,
                                    compute_dtype=torch.float32,
                                    device="cuda")
        model32.load_state_dict(model.state_dict())
        g_32 = loss_grads(model32, data, targets, weights)
    del model, model32, state, batches, data, targets
    torch.cuda.empty_cache()

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_")
    # (b)'s Trainer reference: the same trainer on one device
    one = parallel_trainer(os.path.join(tmp.name, "trainer_one"), None, ops)
    for i, got in enumerate(one["launches"]):
        check(got == one["want"], f"[parallel] (b) one device's step "
              f"{i + 1}: launches {got} != {one['want']}")
    # (c)'s references: one device's predictions, through the same
    # entry points, on a model folder of the bench model (seed 0, the
    # trained masks)
    bench = ShiftUNetPlusPlus(
        input_channels=1, num_classes=NUM_CLASSES,
        pool_op_kernel_sizes=((2, 2, 2),) * 5, base_num_features=48,
        compute_dtype=torch.bfloat16, head_probs_dtype=torch.bfloat16,
        device="cuda")
    bench.reset_parameters(seed=0)
    _, inputs, folder = write_predict_inputs(tmp.name, bench.eval(),
                                             PARALLEL_CASE)
    per_fwd = kernel_launches_per_forward(bench)
    del bench
    shapes = []
    probs_one, plain_one, _, _, files_one = parallel_predictions(
        ops, folder, inputs, os.path.join(tmp.name, "out_one"), 1, shapes)
    bundle = predictor.ModelBundle(folder, None, "shiftConvPP",
                                   device="cuda")
    with torch.inference_mode():
        probs_again = predictor.predict_case(bundle, parallel_volume(),
                                             all_in_gpu=True)
    del bundle
    torch.cuda.empty_cache()

    # ---- (b), (c): two gloo ranks on cuda:0
    t0 = time.perf_counter()
    ranks = mesh.launch(parallel_rank, 2, "cuda", folder, inputs, tmp.name,
                        backend="gloo", _shared_device=True)
    t_ranks = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"[parallel] (b) two ranks on {r0['backend']} over CUDA tensors "
          f"on cuda:0 (spawned, started and joined in {t_ranks:.1f} s; s by "
          f"part in each rank {[r['s'] for r in ranks]})", flush=True)
    check(all(r["backend"] == "gloo" for r in ranks), "[parallel] (b) "
          "backend")
    g_two = r0["grads"].cuda()
    e_two = float((g_two - g_32).norm() / g_32.norm())
    e_one = float((g_one - g_32).norm() / g_32.norm())
    print(f"[parallel] (b) make_grad_step over the two ranks, rows 1 + 1 "
          f"on 2 x {GRAD_PATCH[0]}^3, against a float32 plain run: two "
          f"ranks rel L2 err {e_two:.4e}, one device {e_one:.4e}",
          flush=True)
    check(e_two <= ERR_RATIO * e_one, "[parallel] (b) two ranks' gradient "
          "further from the float32 run than one device's")
    t0_, t1_ = (r["trainer"] for r in ranks)
    lerr = max(abs(a - b) / abs(b)
               for a, b in zip(t0_["losses"], one["losses"]))
    perr = float((t0_["params"] - one["params"]).norm()
                 / one["params"].norm())
    print(f"[parallel] (b) Trainer(num_devices=2, dummy_load) at the bench "
          f"plan ({PATCH[0]}^3, batch 2, kernel DSFF {PARALLEL_DENSITY} "
          f"updated at step 2), one row per rank: losses "
          f"{[round(v, 6) for v in t0_['losses']]} against Trainer on one "
          f"device {[round(v, 6) for v in one['losses']]} (max rel "
          f"{lerr:.2e}); parameters after {PARALLEL_TRAINER_STEPS} steps rel "
          f"L2 {perr:.2e} from one device's; masks and parameters equal "
          f"on both ranks {torch.equal(t0_['masks'], t1_['masks'])} / "
          f"{torch.equal(t0_['params'], t1_['params'])}; launches per step "
          f"and rank {t0_['launches'][0]}", flush=True)
    check(t0_["losses"] == t1_["losses"], "[parallel] (b) the ranks' "
          "losses differ")
    check(torch.equal(t0_["masks"], t1_["masks"])
          and torch.equal(t0_["params"], t1_["params"]),
          "[parallel] (b) the ranks' states differ")
    check(t0_["step"] == one["step"] == PARALLEL_TRAINER_STEPS,
          f"[parallel] (b) steps {t0_['step']}")
    check(lerr <= PARALLEL_LOSS_RTOL, "[parallel] (b) Trainer losses")
    for r in ranks:
        # a rank counts the serving and train kernels (blocks' ops)
        for i, got in enumerate(r["trainer"]["launches"]):
            want_r = {k: one["want"].get(k, 0) for k in got}
            check(got == want_r and sum(one["want"].values())
                  == sum(want_r.values()), f"[parallel] (b) a rank's step "
                  f"{i + 1}: launches {got} != {one['want']}")
            add(got)

    steps_c = compute_steps_for_sliding_window(PATCH, PARALLEL_VOLUME, 0.5)
    n_tiles = int(np.prod([len(s) for s in steps_c]))
    got = {k: sum(r["predict_launches"].get(k, 0) for r in ranks)
           for k in ops}
    expect = {k: n_tiles * TTA * per_fwd.get(k, 0) for k in ops}
    add(got)
    probs_two, plain_two = r0["probs"]
    kernel = probs_gap(probs_two, probs_one)
    again = probs_gap(probs_again, probs_one)
    plain = probs_gap(plain_two, plain_one)
    print(f"[parallel] (c) predict_case(num_devices=2), {n_tiles} tiles x "
          f"{TTA} passes of {PARALLEL_VOLUME} (fast mode, sparse plan), "
          f"against one device's (max |dp|, mean |dp|, argmax agreement): "
          f"kernel path {kernel}, one device's kernel path run twice "
          f"{again}, plain path {plain}; launches summed over the ranks "
          f"{got} (expected {expect})", flush=True)
    check(np.shape(probs_two) == np.shape(probs_one)
          == (NUM_CLASSES, *PARALLEL_VOLUME),
          f"[parallel] (c) shape {np.shape(probs_two)}")
    check(bool(np.isfinite(probs_two).all()), "[parallel] (c) non-finite")
    check(plain[0] <= PARALLEL_PROB_ATOL, "[parallel] (c) plain path's "
          "probabilities")
    check(kernel[1] <= PARALLEL_PROB_ATOL, "[parallel] (c) kernel path's "
          "mean probabilities")
    check(kernel[2] >= PARALLEL_AGREE, "[parallel] (c) argmax agreement")
    check(got == expect, "[parallel] (c) launches")

    # predict_from_folder: rank 0 preprocessed, broadcast and exported
    check(len(shapes) == 1, f"[parallel] (c) {len(shapes)} volumes")
    folder_tiles = int(np.prod([
        len(s) for s in compute_steps_for_sliding_window(PATCH, shapes[0],
                                                         0.5)]))
    got = {k: sum(r["folder_launches"].get(k, 0) for r in ranks)
           for k in ops}
    expect = {k: folder_tiles * TTA * per_fwd.get(k, 0) for k in ops}
    add(got)
    check(got == expect, f"[parallel] (c) predict_from_folder launches "
          f"{got} != {expect}")
    check(len(files_one) == len(r0["files"]) == 1
          and ranks[1]["files"] == [],
          f"[parallel] (c) files {[r['files'] for r in ranks]}")
    name = next(iter(PARALLEL_CASE))
    segs = [read_nifti(os.path.join(tmp.name, d, name + ".nii.gz")).array
            for d in ("out_one", "out_two")]
    seg_agree = float((segs[0] == segs[1]).mean())
    print(f"[parallel] (c) predict_from_folder(num_devices=2) on "
          f"{PARALLEL_CASE}: network shape {tuple(shapes[0])}, "
          f"{folder_tiles} tiles x {TTA} passes, launches summed over the "
          f"ranks {got}; its labels {segs[1].shape} against one device's: "
          f"agreement {seg_agree:.6f}", flush=True)
    check(segs[1].shape == segs[0].shape == PARALLEL_CASE[name][0],
          f"[parallel] (c) labels {segs[1].shape}")
    check(seg_agree >= PARALLEL_AGREE,
          "[parallel] (c) predict_from_folder's labels")
    tmp.cleanup()

    # ---- (d) the predict CLI asking for more cards than there are
    try:
        cli_predict.main(["-i", "in", "-o", "out", "-t", "500",
                          "--num_devices", "2"])
        fail("[parallel] (d) --num_devices 2 ran on one card")
    except RuntimeError as e:
        check(f"only {torch.cuda.device_count()} present" in str(e),
              f"[parallel] (d) raised {e}")
        print(f"[parallel] (d) cli.predict --num_devices 2: {e}",
              flush=True)
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s  "
          f"[{smi}]", flush=True)
    return total


def parallel_only() -> None:
    """--parallel: the build and the [parallel] phase alone (its launches
    printed as JSON)."""
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    for op in ops.values():
        op.launches = 0
    got = parallel_phase(ops, lambda: {n: op.launches
                                       for n, op in ops.items()}, smi)
    stamp("[parallel]")
    print(json.dumps({"parallel_launches": got}), flush=True)


# the [spatial] phase: H-sharded training over a (data x space) grid
# (parallel/halo.py, mesh.make_grid) at the bench width; this host has one
# card, so the 1 x 2 grid is two gloo ranks on cuda:0
SPATIAL = 2                      # the ranks that split H
SPATIAL_SIDES = ("top", "bottom", "both")
# the grid's step against one device's: the loss within PARALLEL_LOSS_RTOL;
# the parameters after one step no further from one device's than
# SPATIAL_SPREAD_X times two runs of one device are from each other (the
# statistics' and the weight gradients' atomics vary run to run), and at
# least SPATIAL_STEP_FLOOR of the step's change
SPATIAL_SPREAD_X = 4.0
SPATIAL_STEP_FLOOR = 1e-3
# each rank's peak memory in the step at most this share of one device's
SPATIAL_MEMORY_SHARE = 0.7


def halo_split(whole, top: bool, bottom: bool, extra: int = 0):
    """A slab of `whole` (..., H on axis 2) and its halo rows: the first
    `extra` rows are outside both (a volume's rows further up), then the
    row above (top), the slab, the row below (bottom). Returns (slab, top
    row or None, bottom row or None, the slab's first row in whole)."""
    t0 = extra + (1 if top else 0)
    H = whole.shape[2] - t0 - (1 if bottom else 0)
    slab = whole[:, :, t0:t0 + H].contiguous()
    up = whole[:, :, t0 - 1:t0].contiguous() if top else None
    down = whole[:, :, t0 + H:t0 + H + 1].contiguous() if bottom else None
    return slab, up, down, t0


def spatial_fused_case(name, N, D, Hs, W, part_c, affine, CO, rnd, reps,
                       side):
    """Kernel #1 in halo mode on an H slab of Hs rows (side: which of its
    neighbour rows exist; the others are the volume's edge) against its
    plain version with the same rows, and its y against the rows of the
    whole-H kernel's output on the slab and its rows; with reps, ms in halo
    mode beside the same kernel on the slab alone and on the volume of
    SPATIAL slabs (one device's call)."""
    import torch
    from e2enet_tpu_torch.ops import fused_block as fb
    top, bottom = side in ("top", "both"), side in ("bottom", "both")
    wholes = [rnd(N, D, Hs + top + bottom, W, c).to(torch.bfloat16)
              for c in part_c]
    split = [halo_split(w, top, bottom) for w in wholes]
    parts = [s[0] for s in split]
    halos = ([s[1] for s in split], [s[2] for s in split])
    t0 = split[0][3]
    affines = [rnd.affine(N, c) if a else None
               for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = rnd(CO, scale=0.1)
    args = (parts, kernel, bias, affines, (False,) * 3, None, halos)
    y_k, s_k = fb.fused_shift_conv_block(*args)
    y_p, s_p = fb.fused_shift_conv_block_ref(*args)
    y_w, _ = fb.fused_shift_conv_block(wholes, kernel, bias, affines)
    torch.cuda.synchronize()
    ok, err = y_err(y_k, y_p, Y_ULPS)
    srel = stats_err(s_k, s_p, y_p)
    check(ok, f"[spatial] {name} {side}: y differs from the plain version "
              f"by more than {Y_ULPS} bf16 ulps")
    check(srel <= STATS_RTOL, f"[spatial] {name} {side}: stats rel err "
                              f"{srel}")
    ok_w, err_w = y_err(y_k, y_w[:, :, t0:t0 + Hs], ORDER_ULPS)
    check(ok_w, f"[spatial] {name} {side}: y differs from the whole-H "
                f"kernel's rows by more than {ORDER_ULPS} ulp")
    res = dict(max_abs_err=err, stats_rel=srel, whole_err=err_w)
    if reps:
        volume = [rnd(N, D, SPATIAL * Hs, W, c).to(torch.bfloat16)
                  for c in part_c]
        rows = sum(nbytes(r) for h in halos for r in h if r is not None)
        b_ms, b_by = bound(nbytes(*parts, y_k) + rows + 9 * C * CO * 2,
                           2.0 * N * D * Hs * W * 9 * C * CO, PEAK_BF16)
        res.update(
            ms=cuda_ms(lambda: fb.fused_shift_conv_block(*args), reps),
            plain_ms=cuda_ms(lambda: fb.fused_shift_conv_block_ref(*args),
                             reps),
            slab_ms=cuda_ms(lambda: fb.fused_shift_conv_block(
                parts, kernel, bias, affines), reps),
            whole_h_ms=cuda_ms(lambda: fb.fused_shift_conv_block(
                volume, kernel, bias, affines), reps),
            bound_ms=b_ms, bound_by=b_by)
        print(f"  {name} {side} halo rows, slab N={N} D={D} H={Hs} W={W} "
              f"C={list(part_c)} CO={CO}: max abs err {err:.3e} (whole-H "
              f"rows {err_w:.3e}, stats rel {srel:.2e})  halo mode "
              f"{res['ms']:.4f} ms  the slab without rows "
              f"{res['slab_ms']:.4f} ms  whole H ({SPATIAL * Hs} rows) "
              f"{res['whole_h_ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  "
              f"bound {b_ms:.4f} ms by {b_by} "
              f"({100 * b_ms / res['ms']:.1f} % of it)", flush=True)
    return res


def spatial_bwd_case(name, N, D, Hs, W, part_c, affine, CO, rnd, reps,
                     side):
    """Kernels #2/#4 in halo mode on an H slab: the forward's halo rows
    and the neighbours' y and gy rows, against the plain version with the
    same rows (gx, gW, gb, g(affine)), and gx against the rows of the
    whole-H backward (the volume of the slab and its neighbour rows,
    whose gradient of the slab's rows is the slab's whole gradient)."""
    import torch
    from e2enet_tpu_torch.ops import fused_block as fb
    bf = torch.bfloat16
    top, bottom = side in ("top", "both"), side in ("bottom", "both")
    Hw = Hs + top + bottom
    wholes = [rnd(N, D, Hw, W, c).to(bf) for c in part_c]
    split = [halo_split(w, top, bottom) for w in wholes]
    parts = [s[0] for s in split]
    halos = ([s[1] for s in split], [s[2] for s in split])
    t0 = split[0][3]
    affines = [rnd.affine(N, c) if a else None
               for c, a in zip(part_c, affine)]
    C = sum(part_c)
    kernel = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    bias = rnd(CO, scale=0.1)
    y_w, _ = fb.fused_shift_conv_block(wholes, kernel, bias, affines)
    gy_w = rnd(N, D, Hw, W, CO, scale=1e-3).to(bf)
    gstats = rnd(N, CO, 2, scale=1e-4)
    y, gy = (t[:, :, t0:t0 + Hs].contiguous() for t in (y_w, gy_w))
    edge = ((y_w[:, :, :1].contiguous(), gy_w[:, :, :1].contiguous())
            if top else None,
            (y_w[:, :, -1:].contiguous(), gy_w[:, :, -1:].contiguous())
            if bottom else None)
    args = (parts, kernel, bias, affines, y, gy, gstats, (False,) * 3, None)
    gp, gk, gb, ga = fb.fused_shift_conv_block_bwd(*args, halos=halos,
                                                   edge_rows=edge)
    rp, rk, rb, ra = fb.fused_shift_conv_block_bwd_ref(*args, halos=halos,
                                                       edge_rows=edge)
    wp, _, _, _ = fb.fused_shift_conv_block_bwd(
        wholes, kernel, bias, affines, y_w, gy_w, gstats)
    torch.cuda.synchronize()
    err = err_w = 0.0
    for g, r, w in zip(gp, rp, wp):
        ok, e = y_err(g, r, Y_ULPS)
        check(ok, f"[spatial] {name} {side}: gx differs from the plain "
                  f"version by more than {Y_ULPS} bf16 ulps")
        ok_w, e_w = y_err(g, w[:, :, t0:t0 + Hs], ORDER_ULPS)
        check(ok_w, f"[spatial] {name} {side}: gx differs from the whole-H "
                    f"backward's rows by more than {ORDER_ULPS} ulp")
        err, err_w = max(err, e), max(err_w, e_w)
    rel = max([close_max(gk, rk), close_max(gb, rb)]
              + [close_max(g[i], r[i]) for g, r in zip(ga, ra)
                 if g is not None for i in (0, 1)])
    check(rel <= BWD_RTOL, f"[spatial] {name} {side}: gW/gb/g(affine) rel "
                           f"err {rel}")
    res = dict(max_abs_err=err, rel_err=rel, whole_err=err_w)
    if reps:
        vol = [rnd(N, D, SPATIAL * Hs, W, c).to(bf) for c in part_c]
        vy, _ = fb.fused_shift_conv_block(vol, kernel, bias, affines)
        vgy = rnd(N, D, SPATIAL * Hs, W, CO, scale=1e-3).to(bf)
        rows = sum(nbytes(r) for h in halos for r in h if r is not None)
        rows += sum(nbytes(*p) for p in edge if p is not None)
        b_ms, b_by = bound(2 * nbytes(*parts) + nbytes(y, gy) + rows
                           + 9 * C * CO * (2 + 4) + CO * 4,
                           2.0 * N * D * Hs * W * 9 * CO * 2 * C, PEAK_BF16)
        res.update(
            ms=cuda_ms(lambda: fb.fused_shift_conv_block_bwd(
                *args, halos=halos, edge_rows=edge), reps),
            plain_ms=cuda_ms(lambda: fb.fused_shift_conv_block_bwd_ref(
                *args, halos=halos, edge_rows=edge), max(1, reps // 4)),
            slab_ms=cuda_ms(lambda: fb.fused_shift_conv_block_bwd(*args),
                            reps),
            whole_h_ms=cuda_ms(lambda: fb.fused_shift_conv_block_bwd(
                vol, kernel, bias, affines, vy, vgy, gstats), reps),
            bound_ms=b_ms, bound_by=b_by)
        print(f"  {name} {side} halo rows, slab N={N} D={D} H={Hs} W={W} "
              f"C={list(part_c)} CO={CO}: gx max abs err {err:.3e} "
              f"(whole-H rows {err_w:.3e}), gW/gb/g(affine) rel {rel:.2e}  "
              f"halo mode {res['ms']:.4f} ms  the slab without rows "
              f"{res['slab_ms']:.4f} ms  whole H ({SPATIAL * Hs} rows) "
              f"{res['whole_h_ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  "
              f"bound {b_ms:.4f} ms by {b_by} "
              f"({100 * b_ms / res['ms']:.1f} % of it)", flush=True)
    return res


def spatial_strided_case(name, N, D, Hs, W, C, CO, rnd, reps):
    """Kernel #5 in halo mode on an H slab below another (its top row; the
    slab starts on an even row of the volume) against its plain version
    with the same row and against the rows of the whole-H kernel's output
    on the volume of a row pair and the slab."""
    import torch
    from e2enet_tpu_torch.ops import qstride
    whole = rnd(N, D, Hs + 2, W, C).to(torch.bfloat16)
    x, up, _, t0 = halo_split(whole, True, False, extra=1)
    m, o = rnd.affine(N, C)
    k = rnd(CO, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    b = rnd(CO, scale=0.1)
    args = (x, m, o, k, b, (2, 2, 2), (False,) * 3, None, (up, None))
    y_k, s_k = qstride.strided_fused(*args)
    y_p, s_p = qstride.strided_fused_ref(*args)
    y_w, _ = qstride.strided_fused(whole, m, o, k, b)
    torch.cuda.synchronize()
    ok, err = y_err(y_k, y_p, Y_ULPS)
    srel = stats_err(s_k, s_p, y_p)
    check(ok, f"[spatial] {name}: y differs from the plain version by more "
              f"than {Y_ULPS} bf16 ulps")
    check(srel <= STATS_RTOL, f"[spatial] {name}: stats rel err {srel}")
    ok_w, err_w = y_err(y_k, y_w[:, :, t0 // 2:], ORDER_ULPS)
    check(ok_w, f"[spatial] {name}: y differs from the whole-H kernel's "
                f"rows by more than {ORDER_ULPS} ulp")
    res = dict(max_abs_err=err, stats_rel=srel, whole_err=err_w)
    if reps:
        vol = rnd(N, D, SPATIAL * Hs, W, C).to(torch.bfloat16)
        _, Do, Ho, Wo, _ = y_k.shape
        b_ms, b_by = bound(strided_read_bytes(x, Do, (False,) * 3)
                           + strided_read_bytes(up, Do, (False,) * 3)
                           + nbytes(y_k) + 9 * C * CO * 2,
                           2.0 * N * Do * Ho * Wo * 9 * C * CO, PEAK_BF16)
        res.update(
            ms=cuda_ms(lambda: qstride.strided_fused(*args), reps),
            plain_ms=cuda_ms(lambda: qstride.strided_fused_ref(*args), reps),
            slab_ms=cuda_ms(lambda: qstride.strided_fused(x, m, o, k, b),
                            reps),
            whole_h_ms=cuda_ms(lambda: qstride.strided_fused(vol, m, o, k,
                                                             b), reps),
            bound_ms=b_ms, bound_by=b_by)
        print(f"  {name} top halo row, slab N={N} D={D} H={Hs} W={W} C={C} "
              f"CO={CO}: max abs err {err:.3e} (whole-H rows {err_w:.3e}, "
              f"stats rel {srel:.2e})  halo mode {res['ms']:.4f} ms  the "
              f"slab without its row {res['slab_ms']:.4f} ms  whole H "
              f"({SPATIAL * Hs} rows) {res['whole_h_ms']:.4f} ms  plain "
              f"{res['plain_ms']:.4f} ms  bound {b_ms:.4f} ms by {b_by} "
              f"({100 * b_ms / res['ms']:.1f} % of it)", flush=True)
    return res


def spatial_kernels(rnd, reps):
    """(1) of [spatial]: #1, #2/#4 and #5 in halo mode at the bench
    shapes' slabs. Returns {kernel: its row's 'spatial' entry}."""
    import torch
    out = {}
    N, D, H, W = 1, PATCH[0], PATCH[1] // SPATIAL, PATCH[2]
    l1 = (1, PATCH[0] // 2, PATCH[1] // 2 // SPATIAL, PATCH[2] // 2)
    with torch.inference_mode():
        print(f"[spatial] (1) kernels in halo mode on H slabs of the bench "
              f"shapes (1 x {D} x {H} x {W} and 1 x {l1[1]} x {l1[2]} x "
              f"{l1[3]}), bf16, against their plain versions with the same "
              f"rows and the whole-H kernels' rows", flush=True)
        fwd = {}
        for side in SPATIAL_SIDES:
            fwd[f"l0_48_to48 {side}"] = spatial_fused_case(
                "l0_48_to48", N, D, H, W, [48], [True], 48, rnd,
                reps if side == "both" else 0, side)
        fwd["l0_48+48_to48 both"] = spatial_fused_case(
            "l0_48+48_to48", N, D, H, W, [48, 48], [True, False], 48, rnd,
            reps, "both")
        fwd["l1_96+96+48_to96 both"] = spatial_fused_case(
            "l1_96+96+48_to96", *l1, [96, 96, 48], [True, False, False], 96,
            rnd, reps, "both")
        strided = spatial_strided_case("l0_to_l1_48_to96", N, D, H, W, 48,
                                       96, rnd, reps)
    bwd = {}
    for side in SPATIAL_SIDES:
        bwd[f"l0_48+48_to48 {side}"] = spatial_bwd_case(
            "l0_48+48_to48", 2, D, H, W, [48, 48], [True, False], 48, rnd,
            reps if side == "both" else 0, side)
    bwd["l1_96+96+48_to96 both"] = spatial_bwd_case(
        "l1_96+96+48_to96", 2, *l1[1:], [96, 96, 48], [True, False, False],
        96, rnd, reps, "both")

    def entry(cases, main):
        keys = ("ms", "plain_ms", "slab_ms", "whole_h_ms", "bound_ms",
                "bound_by")
        return dict({k: cases[main][k] for k in keys}, shape=main,
                    max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                    whole_err=max(c["whole_err"] for c in cases.values()),
                    shapes={n: {k: c[k] for k in keys} for n, c in
                            cases.items() if "ms" in c})
    out["fused_shift_conv_block"] = entry(fwd, "l0_48+48_to48 both")
    out["fused_shift_conv_block_bwd"] = entry(bwd, "l0_48+48_to48 both")
    out["strided_fused"] = entry({"l0_to_l1_48_to96 top": strided},
                                 "l0_to_l1_48_to96 top")
    return out


def spatial_step(model, state, weights, batch, ops, grid=None):
    """One train step of model (bench width) from `state` on `batch` (this
    rank's rows and slab with a grid): (loss, params after, kernel
    launches, peak memory in bytes, ms)."""
    import torch
    from e2enet_tpu_torch.training.train_state import (make_sharded_train_step,
                                                       make_train_step)
    step = (make_train_step(model, weights) if grid is None else
            make_sharded_train_step(model, weights, grid=grid))
    data, targets = batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before = {n: op.launches for n, op in ops.items()}
    start.record()
    state, metrics = step(state, data, targets, 0.01)
    end.record()
    torch.cuda.synchronize()
    got = {n: op.launches - before[n] for n, op in ops.items()}
    params = torch.cat([p.detach().flatten().float()
                        for p in state.params.values()]).cpu()
    return (float(metrics["loss"]), params, got,
            torch.cuda.max_memory_allocated(), start.elapsed_time(end))


def spatial_rank(out):
    """One of the 1 x 2 grid's two gloo ranks on cuda:0: (2) one sharded
    train step at the bench width on its slab, (3) Trainer(num_devices=2,
    spatial_parallel=2) on dummy batches, (4) the dry run's rank."""
    import os
    import torch
    from e2enet_tpu_torch.ops import blocks
    from e2enet_tpu_torch.parallel import dryrun, mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    grid = mesh.make_grid(SPATIAL, SPATIAL)
    res = {"backend": torch.distributed.get_backend(grid.world), "s": {}}
    t0 = time.perf_counter()

    def lap(name):
        torch.cuda.synchronize()
        res["s"][name] = round(time.perf_counter() - t0 - sum(
            res["s"].values()), 2)
    # a first step pays the first calls' costs (cuDNN's choices, the
    # group's buffers); the second, from the same initial state, is held
    for i in range(2):
        model, state, weights = parallel_model()
        data, targets = mesh.shard_batch(*parallel_batch(
            PATCH, model.num_ds_outputs()), grid)
        batch = (data.contiguous(), tuple(t.contiguous() for t in targets))
        res["step"] = spatial_step(model, state, weights, batch, ops, grid)
        res["slab"] = tuple(data.shape)
        del model, state, batch, data, targets
        torch.cuda.empty_cache()
        lap(f"step {i + 1}")
    res["trainer"] = parallel_trainer(os.path.join(out, "trainer_grid"),
                                      SPATIAL, ops, SPATIAL)
    lap("trainer")
    before = {n: op.launches for n, op in ops.items()}
    res["dryrun"] = dryrun._rank_run("cuda")
    torch.cuda.synchronize()
    res["dryrun_launches"] = {n: op.launches - before[n]
                              for n, op in ops.items()}
    lap("dryrun")
    return res


def spatial_phase(rnd, reps, ops, counts, smi):
    """[spatial]: (1) the halo-mode kernels; on a 1 x 2 grid of two gloo
    ranks on cuda:0 against one device: (2) make_sharded_train_step at the
    bench width, (3) Trainer(num_devices=2, spatial_parallel=2), (4) the
    dry run. Returns (the kernels' 'spatial' entries, the grid's launches
    summed over the ranks)."""
    import os
    import tempfile
    import torch
    from e2enet_tpu_torch.models.unetpp import kernel_launches_per_train_step
    from e2enet_tpu_torch.parallel import mesh
    t_phase = time.perf_counter()
    kernels = spatial_kernels(rnd, reps)
    t_kernels = time.perf_counter() - t_phase
    total = {k: 0 for k in ops}

    def add(got):
        for k, v in got.items():
            total[k] += v

    # (2)'s reference: one device's step from the same state three times
    # (the last two: the spread of its atomics), and its peak memory
    def per_step(model, spatial):
        per = kernel_launches_per_train_step(model, spatial=spatial)
        return {k: per["forward"].get(k, 0) + per["backward"].get(k, 0)
                for k in ops}
    one = []
    for _ in range(3):
        model, state, weights = parallel_model()
        want, want_one = per_step(model, SPATIAL), per_step(model, 1)
        p0 = torch.cat([v.detach().flatten().float()
                        for v in state.params.values()]).cpu()
        batch = parallel_batch(PATCH, model.num_ds_outputs())
        one.append(spatial_step(model, state, weights, batch, ops))
        del model, state, batch
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        # (3)'s reference: the trainer on one device
        ref = parallel_trainer(os.path.join(tmp, "trainer_one"), None, ops)
        t0 = time.perf_counter()
        ranks = mesh.launch(spatial_rank, SPATIAL, "cuda", tmp,
                            backend="gloo", _shared_device=True)
        t_ranks = time.perf_counter() - t0
    r0, r1 = ranks
    check(all(r["backend"] == "gloo" for r in ranks), "[spatial] backend")
    # the first of one device's three runs pays the first calls' costs
    (l_a, p_a, got_a, mem_one, ms_one), (l_b, p_b, _, _, ms_b) = one[1:]
    change = float((p_a - p0).norm())
    spread = float((p_a - p_b).norm()) / change
    l_g, p_g, _, mem_g, ms_g = r0["step"]
    dist_g = float((p_g - p_a).norm()) / change
    lerr = abs(l_g - l_a) / abs(l_a)
    tol = max(SPATIAL_SPREAD_X * spread, SPATIAL_STEP_FLOOR)
    mems = [r["step"][3] for r in ranks]
    print(f"[spatial] (2) make_sharded_train_step on a 1 x {SPATIAL} grid "
          f"of gloo ranks on cuda:0 (spawned, run and joined in "
          f"{t_ranks:.1f} s; s by part per rank "
          f"{[r['s'] for r in ranks]}), bench width, kernel DSFF "
          f"{PARALLEL_DENSITY}, batch 2 x {PATCH[0]}^3, each rank's slab "
          f"{r0['slab']}: loss {l_g:.6f} against one device's {l_a:.6f} "
          f"(rel {lerr:.2e}); parameters after the step {dist_g:.3e} of "
          f"the step's change from one device's, two runs of one device "
          f"{spread:.3e} apart (tolerance {tol:.3e}); ms per step per rank "
          f"{[round(r['step'][4], 1) for r in ranks]} (two ranks sharing "
          f"the card) against one device's {ms_one:.1f} / {ms_b:.1f}; peak "
          f"memory per rank {[round(m / 2 ** 30, 3) for m in mems]} GiB "
          f"against one device's {mem_one / 2 ** 30:.3f} GiB (share "
          f"{max(mems) / mem_one:.3f}); launches per step and rank "
          f"{r0['step'][2]}  [{smi}]", flush=True)
    check(lerr <= PARALLEL_LOSS_RTOL, "[spatial] (2) the grid's loss")
    check(dist_g <= tol, "[spatial] (2) the grid's parameters")
    check(r0["step"][0] == r1["step"][0]
          and torch.equal(r0["step"][1], r1["step"][1]),
          "[spatial] (2) the ranks' states differ")
    check(max(mems) <= SPATIAL_MEMORY_SHARE * mem_one,
          f"[spatial] (2) per-rank peak memory above "
          f"{SPATIAL_MEMORY_SHARE} of one device's")
    check(got_a == want_one, f"[spatial] (2) one device's launches "
                             f"{got_a} != {want_one}")
    for r in ranks:
        # a rank counts the serving and train kernels (blocks' ops)
        got = r["step"][2]
        want_r = {k: want.get(k, 0) for k in got}
        check(got == want_r and sum(want.values()) == sum(want_r.values()),
              f"[spatial] (2) a rank's launches {got} != {want}")
        add(got)
    t0_, t1_ = (r["trainer"] for r in ranks)
    terr = max(abs(a - b) / abs(b)
               for a, b in zip(t0_["losses"], ref["losses"]))
    print(f"[spatial] (3) Trainer(num_devices={SPATIAL}, spatial_parallel="
          f"{SPATIAL}, dummy_load) at the bench plan: losses "
          f"{[round(v, 6) for v in t0_['losses']]} against one device's "
          f"{[round(v, 6) for v in ref['losses']]} (max rel {terr:.2e}); "
          f"masks and parameters equal on both ranks "
          f"{torch.equal(t0_['masks'], t1_['masks'])} / "
          f"{torch.equal(t0_['params'], t1_['params'])}; launches per step "
          f"and rank {t0_['launches'][0]}", flush=True)
    check(terr <= PARALLEL_LOSS_RTOL, "[spatial] (3) Trainer losses")
    check(t0_["losses"] == t1_["losses"]
          and torch.equal(t0_["masks"], t1_["masks"])
          and torch.equal(t0_["params"], t1_["params"]),
          "[spatial] (3) the ranks' states differ")
    for r in ranks:
        for i, got in enumerate(r["trainer"]["launches"]):
            check(got == r["trainer"]["want"], f"[spatial] (3) a rank's "
                  f"step {i + 1}: launches {got} != {r['trainer']['want']}")
            add(got)
    losses = [r["dryrun"] for r in ranks]
    print(f"[spatial] (4) dryrun._rank_run('cuda') on the two ranks: loss "
          f"{losses}", flush=True)
    check(bool(np.isfinite(losses[0])) and losses[0] == losses[1],
          "[spatial] (4) the dry run's losses")
    t_all = time.perf_counter() - t_phase
    print(f"[spatial] phase {t_all:.1f} s (kernels {t_kernels:.1f} s, the "
          f"grid {t_ranks:.1f} s)  [{smi}]", flush=True)
    return kernels, total


def spatial_only() -> None:
    """--spatial: the build and the [spatial] phase alone (its kernel rows
    and launches printed as JSON)."""
    import torch
    from e2enet_tpu_torch.ops import _native, blocks
    t0 = time.time()
    _native.build_all()
    print(f"[build] ready in {time.time() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    for op in ops.values():
        op.launches = 0
    kernels, got = spatial_phase(Rnd(0), 10, ops, lambda: {
        n: op.launches for n, op in ops.items()}, smi)
    stamp("[spatial]")
    print(json.dumps({"spatial": kernels, "spatial_launches": got}),
          flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    if sys.argv[1:] == ["--host-ms"]:
        host_only()
        return
    if sys.argv[1:] == ["--trainer"]:
        trainer_only()
        return
    if sys.argv[1:] == ["--options"]:
        options_only()
        return
    if sys.argv[1:] == ["--dsff"]:
        dsff_only()
        return
    if sys.argv[1:] == ["--2d"]:
        twod_only()
        return
    if sys.argv[1:] == ["--cascade"]:
        cascade_only()
        return
    if sys.argv[1:] == ["--variants"]:
        variants_only()
        return
    if sys.argv[1:] == ["--ensembles"]:
        ensembles_only()
        return
    if sys.argv[1:] == ["--models"]:
        models_only()
        return
    if sys.argv[1:] == ["--device_augment"]:
        device_augment_only()
        return
    if sys.argv[1:] == ["--formats"]:
        formats_only()
        return
    if sys.argv[1:] == ["--parallel"]:
        parallel_only()
        return
    if sys.argv[1:] == ["--spatial"]:
        spatial_only()
        return
    try:
        from e2enet_tpu_torch.experiments import (exp_cf_fused, exp_int8_mma,
                                                  exp_pipeline_fwd,
                                                  shift_conv)
        from e2enet_tpu_torch.inference.predictor import mirror_apply_fns_for
        from e2enet_tpu_torch.models.masks import attach_masks, masks_density
        from e2enet_tpu_torch.models.sparse_plan import plan_density
        from e2enet_tpu_torch.models.unetpp import (
            ShiftUNetPlusPlus, kernel_launches_per_forward)
        from e2enet_tpu_torch.ops import _native, blocks, qlink
        from e2enet_tpu_torch.ops.sliding import (flip_combinations,
                                                  head_probs,
                                                  predict_volume_tiled)
    except ImportError as e:
        fail(f"e2enet_tpu_torch not importable ({e}); run from the "
             f"repository root")
    check("jax" not in sys.modules, "the port imported jax")
    ops = {name: op for name, (op, _) in list(blocks.KERNEL_OPS.items())
           + list(blocks.BACKWARD_OPS.items())}
    # the experiment kernels: on no serving or train path
    ops.update(fused_shift_conv=shift_conv.fused_shift_conv,
               depth_shift_ring=shift_conv.depth_shift_ring,
               reshape_hwc=exp_cf_fused.reshape_hwc,
               cf_fused_shift_conv=exp_cf_fused.cf_fused_shift_conv,
               pipelined_fused_block=exp_pipeline_fwd.pipelined_fused_block,
               mma_gemm=exp_int8_mma.mma_gemm)

    def reset_counts():
        for op in ops.values():
            op.launches = 0

    def counts():
        return {name: op.launches for name, op in ops.items()}

    # ---- 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}  count={torch.cuda.device_count()}  "
          f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    # ---- 2. build
    t0 = time.time()
    libs = _native.build_all()
    print(f"[build] {', '.join(p.name for p in libs.values())} ready in "
          f"{time.time() - t0:.1f} s", flush=True)
    for path in libs.values():
        log = path.with_name(path.name + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line):
                    print(f"[build] {line.strip()}", flush=True)
    for name in libs:
        _native.library(name)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    stamp("2. build")
    # ---- 3. kernels vs plain
    rnd = Rnd(0)
    R = 20                     # timed calls per kernel, after one warm-up
    res = {}
    with torch.inference_mode():
        print("[kernel] fused_shift_conv_block (#1) vs plain, bf16; "
              "'library' is cuDNN's bf16 conv of the prepared operand",
              flush=True)
        fused = [
            # the main-path shapes, with the main path's pending affines
            ("l0_c1_to48", 1, 128, 128, 128, [1], [False], 48),
            ("l0_48_to48", 1, 128, 128, 128, [48], [True], 48),
            ("l0_48+48_to48", 1, 128, 128, 128, [48, 48], [True, False], 48),
            ("l1_96+96+48_to96", 1, 64, 64, 64, [96, 96, 48],
             [True, False, False], 96),
            ("l1_96_to96", 1, 64, 64, 64, [96], [True], 96),
            # every part pending, and the ragged edges
            ("l1_all_affine", 1, 64, 64, 64, [96, 96, 48], [True, True, True],
             96),
            ("ragged_w13", 2, 6, 8, 13, [5, 3], [True, False], 7),
            ("ragged_d3", 1, 3, 16, 16, [8], [True], 16),
            ("two_co_tiles", 1, 4, 8, 32, [16, 20], [False, True], 112),
            ("w_tiles_w200", 1, 4, 8, 200, [96, 96, 48], [True, False, False],
             96),
        ]
        r1 = {c[0]: fused_case(*c, rnd=rnd, reps=R) for c in fused}
        # W tiles of 144, 160 and 600 columns; K of 200 (parts and groups
        # meeting mid-unit) and 240 at CO 48 (5 K chunks)
        edges1 = [("w144_co96", 1, 2, 8, 144, [96], [True], 96),
                  ("w160", 1, 3, 4, 160, [48, 48], [True, False], 48),
                  ("w600", 1, 2, 2, 600, [8], [True], 16),
                  ("k200_co40", 1, 3, 16, 40, [100, 100], [True, False], 40),
                  ("k240_co48", 1, 3, 16, 32, [96, 96, 48],
                   [True, False, True], 48)]
        errs1 = [fused_case(*c, rnd=rnd, reps=0)["max_abs_err"]
                 for c in edges1]
        for co in (24, 96):
            errs1 += [fused_case("flips", 1, 7, 16, 24, [40, 8], [True, False],
                                 co, rnd=rnd, reps=0, flips=f)["max_abs_err"]
                      for f in FLIPS]
        print(f"[kernel] fused block: W 144/160/600, K 200/240 and all 8 "
              f"mirror combinations at CO 24 and 96 within tolerance (max abs "
              f"err {max(errs1):.3e})", flush=True)
        keys1 = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "mma_ms", "host_ms")
        res["fused_shift_conv_block"] = dict(
            r1["l0_48+48_to48"],
            max_abs_err=max([r["max_abs_err"] for r in r1.values()] + errs1),
            shapes={n: {k: r1[n][k] for k in keys1} for n in FUSED_ON_PATH})

        print("[kernel] lazy_up_fused_block (#3, lazy up-link) vs plain, "
              "bf16; 'library' is cuDNN's bf16 conv of the already "
              "materialised operand", flush=True)
        main3 = lazy_case("l0_48+up96to48_to48", 1, 64, 64, 64, [48], [True],
                          96, 48, 48, rnd, R)
        errs = [main3["max_abs_err"]]
        # odd coarse depth, W not a multiple of 16, 8-channel parts, CO 8
        # and 24; compact groups that start mid-unit at all 8 mirrors
        errs.append(lazy_case("ragged_dc3_w26_c8_co8", 2, 3, 5, 13, [8],
                              [True], 8, 8, 8, rnd, 0)["max_abs_err"])
        errs.append(lazy_case("ragged_w14_co24", 1, 3, 4, 7, [8, 8],
                              [True, False], 16, 8, 24, rnd, 0)["max_abs_err"])
        groups = ((0, 7, -2), (7, 13, -1), (13, 22, 0), (22, 24, 1))
        errs += [lazy_case("flips_compact", 1, 3, 8, 12, [16], [True], 24, 8,
                           16, rnd, 0, f, groups)["max_abs_err"]
                 for f in FLIPS]
        # the tile's edges: H not a multiple of its 16 rows, one coarse
        # depth (D = 2), sparse output widths 10 and 40, three pending parts
        # beside the up-link (MAX_PARTS), W = 144 and 600, up parts wider
        # than one K chunk
        edges = [("h18_tile_ragged", 1, 2, 9, 16, [48], [True], 96, 48, 48),
                 ("dc1_d2", 2, 1, 4, 8, [16], [True], 24, 16, 24),
                 ("co10", 1, 3, 8, 16, [12], [True], 24, 10, 10),
                 ("co40", 1, 3, 8, 16, [24], [True], 48, 24, 40),
                 ("three_parts", 1, 2, 5, 20, [8, 16, 8], [True, False, True],
                  24, 16, 40),
                 ("w144", 1, 2, 3, 72, [48], [True], 96, 48, 48),
                 ("w600", 1, 1, 2, 300, [8], [True], 16, 8, 16),
                 # up parts of more than one staged chunk beside a part
                 ("wide_up64", 1, 2, 4, 16, [64], [True], 128, 64, 48),
                 ("wide_up56", 1, 3, 4, 9, [8], [False], 24, 56, 24)]
        errs += [lazy_case(*c, rnd, 0)["max_abs_err"] for c in edges]
        # compact groups whose up columns read both depth parities at one
        # output depth (shifts 1, -1, 2, 0 side by side)
        both = ((0, 3, -2), (3, 9, 1), (9, 12, -1), (12, 16, 2), (16, 20, 0))
        errs += [lazy_case("both_parities", 1, 3, 6, 16, [8], [True], 24, 12,
                           10, rnd, 0, f, both)["max_abs_err"] for f in FLIPS]
        print(f"[kernel] lazy block: ragged, compact groups, the tile's edges "
              f"and all 8 mirror combinations within tolerance (max abs err "
              f"{max(errs):.3e})", flush=True)
        res["lazy_up_fused_block"] = dict(main3, max_abs_err=max(errs))

        print("[kernel] strided_fused (#5) vs plain; 'library' is cuDNN's "
              "bf16 strided conv of the unnormalised input", flush=True)
        main5 = strided_case("l0_to_l1_48_to96", 1, 128, 128, 128, 48, 96,
                             rnd, R)
        rag5 = strided_case("ragged_d7_w26_c8", 2, 7, 9, 26, 8, 24, rnd, 0)
        # more tiles than blocks, 80 per sample: a block's tiles straddle
        # the two samples, each sample's statistics flushed with the next
        # tile's copies in flight
        errs5 = [strided_case("n2_straddle", 2, 40, 64, 32, 16, 40, rnd, 0,
                              f)["max_abs_err"]
                 for f in (FLIPS[0], FLIPS[-1])]
        # weights too large for two operand buffers: the one-buffer order
        errs5.append(strided_case("one_buffer_c96_co64", 1, 4, 8, 128, 96,
                                  64, rnd, 0)["max_abs_err"])
        errs = [strided_case("flips", 1, 8, 16, 32, 48, 96, rnd, 0, f)[
            "max_abs_err"] for f in FLIPS]
        errs += [strided_case("flips_ragged", 2, 7, 9, 26, 8, 24, rnd, 0,
                              f)["max_abs_err"] for f in FLIPS]
        print(f"[kernel] strided: ragged, N = 2 straddling the samples, one "
              f"operand buffer and all 8 mirror combinations within "
              f"tolerance (max abs err {max(errs + errs5):.3e})", flush=True)
        res["strided_fused"] = dict(main5, max_abs_err=max(
            [main5["max_abs_err"], rag5["max_abs_err"]] + errs + errs5))

        print("[kernel] uplink (#6) vs plain; 'library' is cuDNN's bf16 "
              "transposed conv of the unnormalised input", flush=True)
        main6 = uplink_case("l1_to_l0_96_to48", 1, 64, 64, 64, 96, 48, rnd, R)
        # the train step's batch of two, mirrored as on the data-flip path
        n2_6 = uplink_case("l1_to_l0_n2_flips", 2, 64, 64, 64, 96, 48, rnd, R,
                           (True, False, True))
        errs6 = [uplink_case("ragged_d3_w13_c8", 2, 3, 5, 13, 8, 12, rnd,
                             0)["max_abs_err"],
                 uplink_case("ldg_c12_w70", 1, 3, 4, 70, 12, 8, rnd, 0,
                             (False, True, True), "ldg")["max_abs_err"]]
        keys6 = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "host_ms", "kernel_route")
        res["uplink"] = dict(main6, max_abs_err=max(
            [main6["max_abs_err"], n2_6["max_abs_err"]] + errs6),
            shapes={"l1_to_l0_n2_flips": {k: n2_6[k] for k in keys6}})

        print("[kernel] downlink (#7) vs plain; 'library' is max_pool3d of "
              "the unnormalised input", flush=True)
        main7 = downlink_case("l0_to_l1_48", 1, 128, 128, 128, 48, rnd, R)
        rag7 = downlink_case("ragged_d7_w26_c8", 2, 7, 6, 26, 8, rnd, 0)
        res["downlink"] = dict(main7, max_abs_err=max(main7["max_abs_err"],
                                                      rag7["max_abs_err"]))

        print("[kernel] seghead (#10 probs, #9 logits) vs plain; 'library' "
              "is the bf16 1x1 product alone (F.linear)", flush=True)
        main10 = seghead_case("l0_probs_48_to16", 1, 128, 128, 128, 48, 16,
                              True, rnd, R)
        log9 = seghead_case("l0_logits_48_to16", 1, 128, 128, 128, 48, 16,
                            False, rnd, R)
        # the train step's level-1 head
        l1_9 = seghead_case("l1_logits_n2_96_to16", 2, 64, 64, 64, 96, 16,
                            False, rnd, R)
        # tiles straddling two samples (195 voxels each), a ragged last
        # tile stored element by element (K = 5), and the first design
        rag10 = [seghead_case(*c, p, rnd, 0, r)["max_abs_err"]
                 for c, r in ((("n2_straddle", 2, 3, 5, 13, 48, 16), "bulk"),
                              (("k5_tail", 1, 3, 5, 7, 16, 5), "bulk"),
                              (("ragged_d3_w13_c8", 2, 3, 5, 13, 8, 3),
                               "ldg"))
                 for p in (True, False)]
        keys10 = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "host_ms", "kernel_route")
        res["seghead"] = dict(main10, max_abs_err=max(
            [main10["max_abs_err"], log9["max_abs_err"],
             l1_9["max_abs_err"]] + rag10),
            shapes={n: {k: r[k] for k in keys10} for n, r in (
                ("l0_logits_48_to16", log9), ("l1_logits_n2_96_to16", l1_9))})
        res["seghead"]["logits_mode_ms"] = log9["ms"]

    # ---- the paths' shared parts
    def bench_model(dtype=torch.bfloat16, probs=torch.bfloat16):
        m = ShiftUNetPlusPlus(
            input_channels=1, num_classes=NUM_CLASSES,
            pool_op_kernel_sizes=((2, 2, 2),) * 5, base_num_features=48,
            compute_dtype=dtype, head_probs_dtype=probs, device="cuda")
        m.reset_parameters(seed=0)
        return m.eval()

    vols = [np.random.RandomState(s).randn(1, *VOLUME).astype(np.float32)
            for s in (1, 2, 3)]
    w16, n_tiles = f16_weights()
    # weights >= 2^-10: a class share of 1/16 or more is still a normal
    # float16, so the sum over classes is good to ~1e-3
    normal, zero = w16 >= 2.0 ** -10, w16 == 0
    # one 128^3 patch of the first timed volume
    x = torch.from_numpy(vols[1][0, :128, :128, :128, None]).cuda()[None]

    def unused_apply_fn(v):
        fail("apply_fn called under flip-free TTA")

    def predict(vol, apply_fn=unused_apply_fn, mirror_fns=None):
        return predict_volume_tiled(apply_fn, vol, PATCH, NUM_CLASSES,
                                    device="cuda", step_size=0.5,
                                    mirror_axes=(0, 1, 2),
                                    accum_dtype=torch.float16,
                                    mirror_apply_fns=mirror_fns)

    def timed(fn, *a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn(*a, **k)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def check_probs(tag, probs, ms):
        p = np.asarray(probs, dtype=np.float32)
        check(p.shape == (NUM_CLASSES, *VOLUME), f"shape {p.shape}")
        check(bool(np.isfinite(p).all()), "non-finite probabilities")
        s = p.sum(0)
        dev = float(np.abs(s[normal] - 1.0).max())
        tail = ~normal & ~zero
        print(f"[{tag}] volume: {ms:.1f} ms, "
              f"{n_tiles * TTA / (ms / 1e3):.2f} patches/s, probs "
              f"{probs.dtype}; max |sum_k p - 1| {dev:.2e} over the "
              f"{int(normal.sum())} voxels of weight >= 2^-10; "
              f"{int(tail.sum())} voxels of smaller weight reach "
              f"{float(np.abs(s[tail] - 1.0).max()):.2e}; "
              f"{int(zero.sum())} voxels of zero weight hold p = 0",
              flush=True)
        check(dev <= PROB_SUM_ATOL, f"probs sum off by {dev}")
        check(bool((s[zero] == 0).all()),
              "zero-weight voxels hold probabilities")

    def check_counts(tag, got, n_vols, per):
        check(all(got[k] == 0 for k in got if k not in per),
              f"{tag}: a backward kernel launched")
        got = {k: got[k] for k in per}
        want = {k: n_vols * n_tiles * TTA * v for k, v in per.items()}
        print(f"[{tag}] kernel launches {got} over {n_vols} volume(s) "
              f"(expected {n_vols} x {n_tiles} tiles x {TTA} passes x "
              f"{per})", flush=True)
        check(got == want, f"launch counts {got} != {want}")
        for name, n in per.items():
            if n:
                check(got[name] > 0, f"{tag}: {name} never launched")

    def fast_volumes(tag, model):
        """Warm-up volume, then the two timed volumes with the launch
        counts read around them. Returns (launches, mean ms/volume)."""
        fns = mirror_apply_fns_for(model)
        t0 = time.time()
        predict(vols[0], mirror_fns=fns)
        print(f"[{tag}] warm-up volume {time.time() - t0:.1f} s", flush=True)
        reset_counts()
        outs = [timed(predict, v, mirror_fns=fns) for v in vols[1:]]
        got = counts()
        check_counts(tag, got, len(outs), kernel_launches_per_forward(model))
        for probs, ms in outs:
            check_probs(tag, probs, ms)
        return got, float(np.mean([ms for _, ms in outs]))

    def patch_logits(model):
        """One patch's float32 logits through the kernel path and the plain
        path."""
        model.head_probs_dtype = None
        try:
            k = model(x, do_ds=False).float()
            with blocks.plain_ops():
                p = model(x, do_ds=False).float()
        finally:
            model.head_probs_dtype = torch.bfloat16
        check(bool(torch.isfinite(k).all()), "non-finite logits")
        return k, p

    def against_float32(tag, logits_k, logits_p, logits_32):
        d = (logits_k - logits_p).abs()
        agree = float((logits_k.argmax(-1) == logits_p.argmax(-1))
                      .float().mean())
        print(f"[{tag}] one 128^3 patch, kernel vs plain path: max "
              f"|dlogit| {float(d.max()):.4e} (mean {float(d.mean()):.3e}, "
              f"max |logit| {float(logits_p.abs().max()):.3f}), argmax "
              f"agreement {agree:.6f}", flush=True)
        errs = {}
        for name, lg in (("kernel", logits_k), ("plain", logits_p)):
            e = (lg - logits_32).abs()
            a32 = float((lg.argmax(-1) == logits_32.argmax(-1))
                        .float().mean())
            errs[name] = (float(e.mean()), a32)
            print(f"[{tag}]   {name} path vs float32 model: max |dlogit| "
                  f"{float(e.max()):.4e}, mean {float(e.mean()):.4e}, argmax "
                  f"agreement {a32:.6f}", flush=True)
        check(errs["kernel"][0] <= ERR_RATIO * errs["plain"][0],
              f"{tag}: kernel path further from the float32 model than the "
              f"plain path")
        check(errs["kernel"][1] >= errs["plain"][1] - AGREE_SLACK,
              f"{tag}: kernel path argmax agreement with float32 below the "
              f"plain path's")

    launches = {}
    # the up-link's and the seg head's routes from here on: the paths run
    # the bench's shapes, which the bulk routes must take
    routes_before = {k: dict(op.routes) for k, op in (
        ("uplink", qlink.uplink), ("seghead", qlink.seghead))}

    stamp("3. kernels")
    # ---- 4. sparse: the bench's default serving path
    model = bench_model()
    masks, plan = attach_masks(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[sparse] ShiftUNet++ {n_params / 1e6:.2f}M params; trained row "
          f"masks: {len(masks)} masks, overall density "
          f"{masks_density(masks, model):.4f}; plan: {len(plan)} convs, row "
          f"density {plan_density(plan, masks):.4f}; kernel launches per "
          f"forward {kernel_launches_per_forward(model)}", flush=True)
    with torch.inference_mode():
        launches["sparse"], ms_sparse = fast_volumes("sparse", model)
        # one patch: the lazy calls captured on the way, kernel and plain
        # path against the float32 dense masked model (same masked weights,
        # no plan, plain ops)
        calls = []
        real = blocks.lazy_up_fused_block

        def spy(*a):
            calls.append(a)
            return real(*a)
        blocks.lazy_up_fused_block = spy
        try:
            logits_k, logits_p = patch_logits(model)
        finally:
            blocks.lazy_up_fused_block = real
        model32 = bench_model(torch.float32, None)
        model32.load_state_dict(model.state_dict())
        with blocks.plain_ops():
            logits_32 = model32(x, do_ds=False)
            model32.set_sparse_plan(plan)
            logits_32s = model32(x, do_ds=False)
        del model32
        against_float32("sparse", logits_k, logits_p, logits_32)
        gap = float((logits_32s - logits_32).abs().max())
        big = float(logits_32.abs().max())
        print(f"[sparse] float32: sparse plain path vs dense masked model "
              f"max |dlogit| {gap:.3e} (max |logit| {big:.3f})", flush=True)
        check(gap <= LOGIT_RTOL * big, "the float32 sparse path differs from "
              "the dense masked model")
        print("[kernel] lazy_up_fused_block at the sparse plan's level-0 "
              "shapes (the patch's own inputs, no mirror)", flush=True)
        check(len(calls) == 5, f"{len(calls)} lazy calls per forward")
        sparse3 = [lazy_check(f"sparse_l0_node{i + 1}", *c, R if i == 0
                              else 0) for i, c in enumerate(calls)]
        res["lazy_up_fused_block"]["max_abs_err"] = max(
            [res["lazy_up_fused_block"]["max_abs_err"]]
            + [r["max_abs_err"] for r in sparse3])
        del calls
    del model
    torch.cuda.empty_cache()

    stamp("4. sparse")
    # ---- 5. dense: the bench's --dense path, lazy up-links
    model = bench_model()
    print(f"[dense] kernel launches per forward "
          f"{kernel_launches_per_forward(model)}", flush=True)
    fns = mirror_apply_fns_for(model)
    with torch.inference_mode():
        launches["dense"], ms_dense = fast_volumes("dense", model)
        # plain path: every kernel site swapped for its plain version
        with blocks.plain_ops():
            before = counts()
            _, ms_plain = timed(predict, vols[1], mirror_fns=fns)
            check(counts() == before, "the plain path launched a kernel")
        logits_k, logits_p = patch_logits(model)
        model32 = bench_model(torch.float32, None)
        model32.load_state_dict(model.state_dict())
        with blocks.plain_ops():
            logits_32 = model32(x, do_ds=False)
        against_float32("dense", logits_k, logits_p, logits_32)

        # one tile: flip-free 8-pass mean vs data-flip 8-pass mean (both
        # kernel path, probs head), each against a float32 data-flip run
        def data_flip_mean(net):
            acc = None
            for combo in flip_combinations((0, 1, 2)):
                ax = tuple(a + 1 for a in combo)
                p = head_probs(net(x.flip(ax) if ax else x, do_ds=False))
                p = p.flip(ax) if ax else p
                acc = p if acc is None else acc + p
            return acc / TTA

        p_ff = sum(head_probs(fn(x)) for fn in fns) / TTA
        p_df = data_flip_mean(model)
        with blocks.plain_ops():
            p_32 = data_flip_mean(model32)
        del model32
        d = (p_ff - p_df).abs()
        e_ff = float((p_ff - p_32).abs().mean())
        e_df = float((p_df - p_32).abs().mean())
        a_ff = float((p_ff.argmax(-1) == p_32.argmax(-1)).float().mean())
        a_df = float((p_df.argmax(-1) == p_32.argmax(-1)).float().mean())
        print(f"[dense] one tile, 8-pass mean probs, flip-free vs data-flip: "
              f"max |dp| {float(d.max()):.4e}, mean {float(d.mean()):.3e}; "
              f"against float32 data-flip: mean |dp| {e_ff:.4e} vs "
              f"{e_df:.4e}, argmax agreement {a_ff:.6f} vs {a_df:.6f}",
              flush=True)
        check(e_ff <= ERR_RATIO * e_df, "flip-free TTA further from float32 "
              "than data-flip TTA")
        check(a_ff >= a_df - AGREE_SLACK, "flip-free TTA argmax agreement "
              "below data-flip TTA's")

    stamp("5. dense")
    # ---- 6. data-flip TTA, float32 logits head, materialised up-links
    model.head_probs_dtype = None
    model.lazy_up = False
    per_df = kernel_launches_per_forward(model)
    apply_fn = lambda v: model(v, do_ds=False)  # noqa: E731
    with torch.inference_mode():
        reset_counts()
        probs, ms_df = timed(predict, vols[1], apply_fn, None)
        launches["data-flip"] = counts()
        check_counts("data-flip", launches["data-flip"], 1, per_df)
        check_probs("data-flip", probs, ms_df)

    def rate(ms):
        return f"{ms:.1f} ms/volume ({n_tiles * TTA / (ms / 1e3):.2f} " \
               f"patches/s)"
    print(f"[paths] sparse fast mode {rate(ms_sparse)}; dense fast mode "
          f"{rate(ms_dense)}; dense plain path {rate(ms_plain)}; data-flip "
          f"{rate(ms_df)}  [{smi}]", flush=True)
    del model, fns
    torch.cuda.empty_cache()

    stamp("6. data-flip")
    # ---- 7. predict: the users' entry point on a model folder
    launches["predict"] = predict_phase(bench_model, reset_counts, counts,
                                        smi)

    stamp("7. predict")
    # ---- 8. bench: the port's own bench in a subprocess
    bench_phase(smi)

    stamp("8. bench")
    # ---- 9. train: the backward kernels, then the row-masked trainer
    train = train_phase(rnd, R, ops, reset_counts, counts, smi)
    launches["train"] = train["launches"]
    routes = {k: {r: op.routes[r] - routes_before[k][r] for r in op.routes}
              for k, op in (("uplink", qlink.uplink),
                            ("seghead", qlink.seghead))}
    print(f"[paths] up-link and seg-head calls by route over the sparse, "
          f"dense, data-flip and train phases: {routes}", flush=True)
    check(all(r["ldg"] == 0 and r["bulk"] > 0 for r in routes.values()),
          f"a path's up-link or seg head left the bulk route: {routes}")
    res.update(train["kernels"])

    stamp("9. train")
    # ---- 9b. parallel: data-parallel training and tile-sharded prediction
    reset_counts()
    launches["parallel"] = parallel_phase(ops, counts, smi)
    reset_counts()

    stamp("9b. parallel")
    # ---- 9c. spatial: H-sharded training over a (data x space) grid
    res_spatial, launches["spatial"] = spatial_phase(rnd, 10, ops, counts,
                                                     smi)
    reset_counts()

    stamp("9c. spatial")
    # ---- 10. trainer: the users' training path, train CLI to predict CLI;
    # ---- 11. options: the trainer's options, on the task [trainer] planned
    # ---- 12. dsff: every DSFF engine, on the same task;
    # ---- 13. 2d: its 2D plan, and the shift off;
    # ---- 14. cascade: 3d_lowres -> 3d_cascade_fullres on its cases;
    # ---- 15. variants: the variants' knobs and the region trainers;
    # ---- 16. ensembles: model selection, ensembles, consolidation, amos2022
    # ---- 17. models: the architecture switches and the remaining networks
    # ---- 18. device_augment: the training batches augmented on the card
    def options(paths, trainer_ms, trainer_info):
        stamp("10. trainer")
        reset_counts()
        options_phase(ops, counts, smi, paths)
        launches["options"] = counts()
        stamp("11. options")
        reset_counts()
        dsff_phase(ops, counts, smi, paths)
        launches["dsff"] = counts()
        stamp("12. dsff")
        reset_counts()
        res2d.update(twod_phase(rnd, R, ops, counts, smi, paths))
        launches["2d"] = counts()
        stamp("13. 2d")
        reset_counts()
        res_cascade.update(cascade_phase(rnd, R, ops, counts, smi, paths))
        launches["cascade"] = counts()
        stamp("14. cascade")
        reset_counts()
        res_variants.update(variants_phase(rnd, R, ops, counts, smi, paths,
                                           trainer_ms))
        launches["variants"] = counts()
        stamp("15. variants")
        reset_counts()
        ensembles_phase(ops, counts, smi, paths)
        launches["ensembles"] = counts()
        stamp("16. ensembles")
        reset_counts()
        res_models.update(models_phase(rnd, MODELS_R, ops, counts, smi,
                                       paths))
        launches["models"] = counts()
        stamp("17. models")
        reset_counts()
        device_augment_phase(ops, counts, smi, paths, trainer_info)
        launches["device_augment"] = counts()
    res2d, res_cascade, res_variants, res_models = {}, {}, {}, {}
    launches["trainer"] = trainer_phase(ops, reset_counts, counts, smi,
                                        then=options)

    stamp("10-18. trainer, options, dsff, 2d, cascade, variants, "
          "ensembles, models, device_augment")
    # ---- 19. formats: conversion, reorientation, packaging; host only
    import tempfile
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_") as tmp:
        formats_phase(tmp, smi)
    check(not any(counts().values()), "[formats] a kernel launched")

    stamp("19. formats")
    # ---- 20. experiments: the experiment kernels, then their mains
    exp = experiments_phase(rnd, R, reset_counts, counts, smi)
    launches["experiments"] = exp["launches"]
    res.update(exp["kernels"])

    stamp("20. experiments")
    # ---- 21. report
    sources = {"fused_shift_conv_block": ("fused_block.cu",
                                          "e2enet_tpu/ops/fused_block.py:85"),
               "fused_shift_conv_block_bwd": (
                   "fused_block_bwd.cu", "e2enet_tpu/ops/fused_block.py:349"),
               "downlink_bwd": ("qlink.cu", "e2enet_tpu/ops/qlink.py:278"),
               "lazy_up_fused_block": ("qfused.cu",
                                       "e2enet_tpu/ops/qfused.py:505"),
               "strided_fused": ("qstride.cu",
                                 "e2enet_tpu/ops/qstride.py:158"),
               "uplink": ("qlink.cu", "e2enet_tpu/ops/qlink.py:104"),
               "downlink": ("qlink.cu", "e2enet_tpu/ops/qlink.py:188"),
               "seghead": ("qlink.cu", "e2enet_tpu/ops/qlink.py:445"),
               "fused_shift_conv": ("shift_conv_ring.cu",
                                    "experiments/shift_conv_pallas.py:61"),
               "depth_shift_ring": ("shift_conv_ring.cu",
                                    "experiments/shift_conv_pallas.py:328"),
               "reshape_hwc": ("cf_fused.cu",
                               "experiments/exp_cf_fused.py:55"),
               "cf_fused_shift_conv": ("cf_fused.cu",
                                       "experiments/exp_cf_fused.py:218"),
               "pipelined_fused_block": (
                   "fused_block_pipe.cu",
                   "experiments/exp_pipeline_fwd.py:37"),
               "mma_gemm": ("mma_gemm.cu", "experiments/exp_int8_mxu.py:69")}
    also = {"fused_shift_conv_block_bwd": "e2enet_tpu/ops/qfused.py:796",
            "fused_shift_conv": "experiments/shift_conv_pallas.py:189",
            "cf_fused_shift_conv": "experiments/exp_cf_fused.py:82"}
    print("[report] ms, plain_ms, bound_ms and library_ms are per call at "
          "the dense main-path shape (fused block: l0_48+48_to48, every "
          "on-path shape under 'shapes'; lazy "
          "block: l0_48+up96to48_to48, its first sparse level-0 shape under "
          "'sparse_shape'; seg head: probs mode, logits under 'shapes'; "
          "up-link: N = 1, N = 2 mirrored under 'shapes'; block backward: "
          "the level-0 "
          "lazy node's, batch 2, other shapes under 'shapes'; down-link "
          "backward: batch 2 at 128^3; experiment kernels: 1 x 128^3 x 48 "
          "-> 48 bf16, the pipelined block at l0_48+48_to48 with both "
          "affines, the product at 4096^3 in bf16, int8 under 'int8'); "
          "kernel_route: the route the up-link's and the seg head's "
          "shape took (bulk or ldg); max_abs_err over every case; launches from the sparse path's two "
          "volumes, the up-link's from the data-flip path's volume, the "
          "backward kernels' from the train path's steps, the experiment "
          "kernels' from the experiments' mains (launches_by_path: all "
          "thirteen, 'predict' over the folder run A's two cases, 'trainer' "
          "over the [trainer] phase: train steps, validation batches, the "
          "validations and the predict CLI; 'options' over the [options] "
          "phase: train, gradient and loss steps, the CLI run's "
          "validation batches; 'dsff' over the [dsff] phase: train and "
          "gradient steps of every DSFF engine, the CLI runs' validation "
          "batches and one predicted case; '2d' over the [2d] phase: the "
          "2D CLI runs' and the shiftConvPP_noshift run's train steps, "
          "validation batches and validations, one predicted case; the "
          "'2d' entry: the kernel at the 2D plan's shapes with one group "
          "of shift 0, #3 and #4 with that group at the main path's; "
          "'cascade' over the [cascade] phase: both CLI runs' train steps, "
          "validation batches and validations, predict_next_stage, the "
          "gradient check and one predicted case through both stages; the "
          "'cascade' entry: #1 and the block backward at the cascade's "
          "first block (16 and 3 input channels), the seg head at 3 "
          "classes; 'variants' over the [variants] phase: the "
          "noDeepSupervision, DA5 and fullEvals runs' train steps and "
          "validation batches, the region fold's three validations and "
          "the gradient check; the 'variants' entry: #1 and the block "
          "backward's wgrad at the region model's first block (4 input "
          "channels), #9 at 3 regions; 'ensembles' over the [ensembles] "
          "phase: the two folds' validations, the one predict -z run and "
          "the amos2022 case; 'models' over the [models] phase, its "
          "base-24 kernel checks included: the kernel-route networks' "
          "forwards, the three presets' train steps (none off the kernel "
          "route) and the reference checkpoint's kernel-path predictions; "
          "'device_augment' over the [device_augment] phase: the "
          "--device_augment CLI run's train steps and validation batches; "
          "'parallel' over the [parallel] phase: the one-rank NCCL "
          "world's sharded steps and both gloo ranks' Trainer steps, "
          "predict_case and predict_from_folder, summed over the ranks; "
          "'spatial' over the [spatial] phase: the 1 x 2 grid's train "
          "step, Trainer steps and dry run, summed over the ranks; the "
          "'spatial' entry: the kernel in halo mode on an H slab (ms) "
          "beside the same kernel on the slab alone (slab_ms) and on the "
          "whole H of two slabs (whole_h_ms), every shape under 'shapes'; "
          "the 'models' entry: #1-#10 at base 24, every shape under "
          "'shapes')",
          flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lines = []
    for name, (src, rep) in sources.items():
        path = ("sparse" if launches["sparse"][name] else
                "data-flip" if launches["data-flip"][name] else
                "train" if launches["train"][name] else "experiments")
        line = {"name": name, "route": "cuda",
                "source": f"e2enet_tpu_torch/csrc/{src}", "replaces": rep,
                "launches": launches[path][name],
                "max_abs_err": res[name]["max_abs_err"],
                **{k: res[name][k] for k in keys},
                "launches_by_path": {k: v[name] for k, v in launches.items()}}
        if name == "lazy_up_fused_block":
            line["materialised_ms"] = res[name]["materialised_ms"]
            line["sparse_shape"] = {k: sparse3[0][k] for k in
                                    keys + ("materialised_ms", "kernel1_ms",
                                            "mma_ms", "host_ms")}
        if name in also:
            line["also_replaces"] = also[name]
        if name in res2d:
            line["2d"] = res2d[name]
        if name in res_cascade:
            line["cascade"] = res_cascade[name]
        if name in res_variants:
            line["variants"] = res_variants[name]
        if name in res_models:
            line["models"] = res_models[name]
        if name in res_spatial:
            line["spatial"] = res_spatial[name]
        for extra in ("shapes", "int8", "kernel1_ms", "mma_ms", "control_ms",
                      "serial_ms",
                      "turns_ms", "affine_stats_ms", "gemm_route",
                      "copy_ms", "kernel_route", "host_ms", "logits_mode_ms"):
            if extra in res[name]:
                line[extra] = res[name][extra]
        lines.append(line)
    stamp("21. report: the script")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

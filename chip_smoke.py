"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Run from the repository root:  python3 chip_smoke.py

Phases, in order (any failure raises and the script exits nonzero):
  1. print the card's name and power limit (nvidia-smi);
  2. build every csrc/*.cu with nvcc for sm_90a (one process per source) and,
     beside them, the native host runtime (native/*.cpp) with g++;
  3. per exact-path kernel, at the main path's shapes (1280x720, D=128,
     4 frames): the CUDA wrapper against its plain PyTorch form on the
     card, exact equality; CUDA-event times of both and the kernel's
     bound; the unpacked LR kernel also at min_disparity 16, ndisp 64;
  4. the pipeline at 240x320, D=64, 2 frames on CUDA and on the CPU:
     disparity exactly equal, points within float32 rtol 1e-6;
  5. the main path, batched_stereo_pipeline(matcher="sgbm") at 1280x720,
     4 frames, the bench's exact8 parameters: every kernel's launch count
     (cost, vertical, horizontal, wta4, LR, speckle) must move; valid share
     and within-1px share against the scene's true disparity must clear
     floors; ms per 4-frame call and Mpx/s, plus a per-stage breakdown;
     one more call recorded (see 7) gives the LR and speckle kernels'
     arguments, on which each is held to its plain form (S=100, uncapped);
  6. the hier main path, batched_stereo_pipeline(matcher="sgbm_hier") at
     1280x720, 32 frames, HIER4_FAST with the bench's p3 parameters: every
     hier kernel's launch count must move; the same quality floors; ms per
     32-frame call, Mpx/s and frames/s;
  7. two more such calls with their stages recorded (CUDA events around
     the path's own functions, swapped for recording wrappers): the first
     gives the per-stage breakdown, the second keeps the arguments each
     kernel wrapper was given;
  8. per hier kernel (the pyramid, banded cost, vertical, horizontal, wta,
     LR check, speckle cap 4) on those arguments, at the three levels of
     the path (coarse 180x320 K=32, mid 360x640 K=8, full 720x1280 K=4):
     the kernel on all 32 frames against its plain form on the first 4,
     exact; a 6-stat WTA case at K=16; CUDA-event times (kernel at 32
     frames, plain at 4) and bounds;
  9. the hier4x8 main path: the same with num_paths=8 (the full level
     runs the diagonal vertical kernel, both horizontals and a 4-volume
     WTA): launch counts, floors, ms per call, a recorded breakdown, and
     every hier kernel on the arguments of a recorded call against its
     plain form as in 8 (one row each in the kernels line); the diagonal
     kernel also on per-pixel random shift maps (deltas 0, +-G, +-2G and
     beyond);
 10. batched_stereo_pipeline(matcher="sgbm_hier") at 64x256, D=128,
     32 frames (HIER4_FAST) on CUDA and on the CPU, at 3 paths, at
     StereoSGBMParams() (8 paths) and at 8 paths with the bench's speckle
     and LR settings: disparity exactly equal, points within float32
     rtol 1e-6;
 11. the bench's agreement gate: hier4x3 and hier4x8 (32 copies of a scene
     per call) against exact8 on the first frame of three scenes, >= 0.98
     each;
 12. the exact8 main path with sgm_cuda._FUSED_RL_WTA set (the R->L scan
     fused with the WTA): launch counts (horizontal_rl_wta 1, wta4 0), its
     disparity equal to the unfused call's, the fused kernel on a recorded
     call's arguments against its plain form, and ms per call of both forms
     in turns (unfused, fused, fused, unfused);
 13. aggregate_8 (the aggregate_8_pallas sites) at 8 and 4 paths and
     wta_stats (wta_stats_pallas) on one 1280x720, D=128 exact8 cost volume
     against their plain forms, exact, then one counted two-stage call
     (aggregate_8, then wta_stats) whose maps must equal sgm_reduce's;
 14. the BM kernel against its plain form at BASELINE config #1 (640x480,
     StereoBMParams()) and at min_disparity 16; the BM pipeline at 240x320,
     2 frames, on CUDA and on the CPU: disparity exactly equal;
 15. the BM main path, batched_stereo_pipeline(matcher="bm") at 1920x1080,
     8 frames, D=128, block 5 (`stream --matcher bm` at BASELINE config #5):
     the BM kernel's launch count (1), valid and within-1px floors, ms per
     call, Mpx/s and frames/s; two recorded calls: the stage breakdown
     (remap + round, prefilter, kernel, paste, reproject), then the kernel
     on the call's arguments (8 frames) against its plain form (2 frames).
Between 9 and 10 (numbers by the order they were added):
 16. geometry: stereo_rectify and init_undistort_rectify_map of a distorted
     1920x1080 rig (alpha -1 and 0, float64) on the card and on the CPU,
     R1/R2/P1/P2/Q within rtol 1e-9 and the maps within 1e-3 px, and 10^5
     synthetic matches triangulated on both;
 17. the hier16x3 main path: batched_stereo_pipeline(matcher="sgbm_hier") at
     1280x720, 8 frames (seeds 0-7; HIER_FAST, picked by batch size, with
     p3), its maps and Q from stereo_rectify + init_undistort_rectify_map
     of an undistorted parallel rig on the card. Unfused (launch counts,
     floors, ms per call, a recorded breakdown, every kernel on a recorded
     call's arguments), then with hier._FUSED_STATS set: the fused WTA
     (#19) launches once and the 6-stat WTA only at the coarse level, the
     disparity equals the unfused one, the fused kernel on a recorded
     call's arguments against its plain form; ms per call of both forms in
     turns (unfused, fused, fused, unfused);
 18. the per-frame stereo_sgbm_hier at 64x256 on the card and on the CPU
     (HIER_FAST, HIER4_FAST, coarse_stride 2), exact, and the strided banded
     cost kernel at the hier16x3 coarse shape against its plain form.
Phase 11 also gates hier16x3, unfused and fused (8 copies a call): hier4x3
and both hier16x3 forms must equal BENCH_r05.json's per-scene values.
After 18:
 19. the banded horizontal scan (#18) on per-pixel random shift maps at every
     band it takes (K = 4, 8, ..., 64), int16 and int32, both directions,
     exact against its plain form; its int16 and int32 forms timed at the
     hier16x3 full level's shape, and on fewer frames at K=16 and K=4;
 20. settings the card once refused, CUDA against CPU, exact: the exact
     pipeline at 240x320 at block 11 with 8 paths (int32 volumes) and at
     min_disparity -8, and the per-frame stereo_sgbm_hier at band 12;
 21. the banded cost kernel (#13 with #15/#16) at the five level shapes of
     the main paths (hier4x3 coarse, mid and full at 32 frames, hier16x3
     full and coarse at 8) on per-pixel random shift maps: exact against
     its plain form on 2 frames, ms over 5 runs at the full shape, bound;
 22. bands above 64 (K = 68, 128, 256 at D = 256), int16 and int32: the
     cost kernel (stride 1 and 2), the vertical scan with and without
     diagonals, both horizontals and the WTA (6-stat and sub) against their
     plain forms, exact; the per-frame stereo_sgbm_hier at band 128, D=256,
     card against CPU;
 23. the union-find speckle kernel (#12): on the arguments each SGBM main
     path's recorded call gave it (exact8 R = 99, hier4x3 and hier4x8 cap 4,
     hier16x3 cap 8; held to the plain form there in 5, 8, 9 and 17) its
     device launches a call (graph_kernels; 5 whatever R is, else it
     fails), CUDA-event ms, bound and device ms by launch (torch.profiler,
     "not measured" where it records no device time); then on adversarial 720p
     maps (snakes, a U, a spiral, blobs whose least-index pixel is not their
     top-left corner, combs over many tiles, a constant frame, a
     checkerboard, random blobs), capped and uncapped, against its plain
     form, exact;
 24. disparity ranges and bands above 256 (ROADMAP C.3), card against CPU,
     exact: stereo_sgbm at D = 320 on 48x480, the per-frame stereo_sgbm_hier
     at D = 512, band 320, G = 8 on 32x640, the banded cost at band 256,
     block 21 (rings in device scratch), BM at ndisp 320, 1024 and 1040,
     band 1028 through every banded kernel (int16 and int32), and the exact8
     pipeline at D = 512 on 240x640 (2 frames), at D = 1040 on 240x1280
     with the LR check and at D = 2064 on 96x2304 without it, with its
     launch counts;
 25. (run right after 5) the exact cost kernel (#1): on the arguments the
     recorded exact8 call gave it, exact against its plain form, five timed
     runs, its bound, its tile and the ptxas registers and spills of its
     instantiations; then its grid (blocks 1-51, D = 16-1040, min_disparity
     -8, 0 and 16, x_offset 0 and D, int16 and int32, 5-row frames of
     D + 53 columns), card against plain;
 26. (run right after 15) the BM kernel (#11): five timed runs on the
     recorded bm1080 call's arguments, then its row form's settings (across
     the 16-bit packing bound: blocks 31 / 33 at cap 31, 21 / 23 at cap 63,
     cap 150; odd D, negative and positive min_disparity, ragged and narrow
     frames, H = block, rejecting thresholds, constant frames whose every
     disparity ties), card against plain, with the form each takes;
 27. (run right after 25) the vertical scan (#2): its cluster plan on the
     exact8 cost volume the recorded call made (cluster size, columns and
     warps a block, carries, clusters resident), one device launch,
     exact on the first frame, five timed runs; then its grid (D = 16, 128,
     200, 1000; one column to 16 blocks of a cluster; H = 1 to 9; B = 1, 2,
     5; int16 and int32; with and without diagonals), card against plain.
 28. (run last, after 23) the banded vertical scan (#17): on the arguments
     each hier main path's recorded call gave it (hier4x3's coarse, mid and
     full levels, hier16x3's coarse and full, hier4x8's full level with
     diagonals) its plan (banded_cuda.vertical_plan: form, threads, columns,
     cluster, ring, shared memory), exact against its plain form on the
     first frame, one device launch a call (the kernel nodes of a CUDA
     graph captured from the call), five timed runs of 5 calls and the
     bound; then its grid (K = 4, 8, 12, 16, 32, 64 with their G; 1, 33,
     1152 and 4097 columns; 1 and 17 rows; int16 and int32; with and
     without diagonals), card against plain.
 29. (run after 28) the banded WTA (#20) on the arguments each hier main
     path's recorded call gave it (hier4x3's three levels, hier16x3's two,
     hier4x8's full level) and the packed LR check (#10) on hier4x3's and
     hier16x3's: exact against the plain form on the first frame, one
     device launch a call, five timed runs of 5 calls, the bound and the
     time of torch's copy of the same bytes (also on the kernels line's
     rows, "copy_ms"); then #20's grid (K = 1, 2, 3, 4, 8, 12, 16, 20, 32,
     36, 64; int16 and int32; 2-4 volumes; both forms; 1, 31-33, 255-257
     and 1007 pixels; random, tied, end and boundary
     lanes, int32 sums near 2^31) and #10's (widths 17 to 20000, ranges 16
     to 2047, 1, 7 and 23,040 rows, max_diff 0-2, random maps, rows at one
     disparity, d16 < 0, lookups at and past the shifts -1 and ndisp),
     card against plain.
 30. (run after 29) the fused R->L scan + WTA (#5) on the arguments the
     exact8 fused call (12) gave it and the fused banded WTA (#19) on the
     hier16x3 fused call's (17): exact against the plain form on the first
     frame, one device launch a call and no other, five timed runs of 5
     calls, the bound, torch's copy of the same bytes, and what each
     replaces on the unfused path timed on the same arguments (#5: #3's R->L
     launch then #4, whose maps must equal #5's; #19: #20 on the same
     volumes; on the kernels line's rows as "copy_ms", "replaced" and
     "replaced_ms"); then
     #5's grid (D = 3, 4, 31, 32, 128, 129, 1024, int16 and int32, uniq 0
     and 10, widths 1, 2, 31 and 1152, 5 and 9 rows; every other row's costs
     zero, so that adversarial lanes from synth.scenes.wta_volumes survive
     in the sum) and #19's (2-4 volumes, int16 and int32, 1-1007 pixels,
     shifts at 0, at ndisp - 16 and random, adversarial lanes), card
     against plain.
 31. (run after 30) the box-downsample pyramid (#14) on the arguments each
     hier main path's recorded call gave it (hier4x3's and hier4x8's levels
     (4, 4) and (2, 2), hier16x3's (4, 4)) and the unpacked LR check (#9) on
     the exact8 call's: exact against the plain form (run on the card) on
     the first frame, one device launch a call (graph_kernels), five timed
     runs of 5 calls of the wrapper and of its C entry alone, the bound of
     the work (every input read once, every output written once), torch's
     copy of the same bytes; beside #14 the parent's form (downsample_box
     once a level and image, as hier called it before) and avg_pool2d, and
     the bound of the parent's work (each launch reading a whole image set);
     on the kernels line's rows as "copy_ms", "entry_ms", "parent_form_ms"
     and "parent_work_bound_ms"; then #14's grid (nesting and other factor
     sets, odd and unaligned widths, one frame, pixels at 0 and 255, frames
     off 16 bytes) and #9's (widths 17-20000, ndisp 8-2031, min_disparity 0
     and 16, valid regions off 16 bytes, 1 to 2,881 rows, maps from
     synth.scenes.lr_maps with winners outside the range), card against
     plain.
 32. (run last) the CLI's chain intrinsic -> extrinsic -> rectify -> sync ->
     stream on the card: both cameras of parallel_rig's 1280x720 rig
     calibrated from 20 views of a 9x6, 100 mm board (synth.boards,
     0.1 px noise) and the rig by calibrate_stereo, on the card and on the
     CPU (equal within tests/test_torch_calib.py's tolerances; the card
     also against the truth: fx, fy within 0.5%, cx, cy within 8 px, rms
     < 0.3 px, baseline within 1%; seconds a call); stereo_rectify and
     the maps on the card; two 67-frame streams 3 frames apart with a
     flash (synth.scenes.flash_streams): synchronize_streams and
     find_best_offset_by_content on 32 frames, card against CPU (offset 3
     both ways, PSNR within 0.05 dB); then StereoStreamProcessor windows
     of pairs (left i, right i + 3) with the calibrated maps and Q: two
     hier4x3 (32 pairs, p3), one exact8 (4) and one BM (8), each drained
     window bit-equal to batched_stereo_pipeline's with the path's launch
     counts equal (set to 0 before, read after; none 0), the caller's
     arrays rewritten right after submit; ms per window of the closure
     (make_sharded_pipeline, maps on the card), batched_stereo_pipeline
     (host maps) and submit + drain; valid and within-1px shares printed.
 33. (run after 32) detection at the CLI's frame sizes: the CLI's default
     board (7x4 inner corners, 100 mm squares) rendered without OpenCV
     (synth.boards.render_board_view, 4x4 samples a pixel, on the card) in
     20 views for each camera of a 1920x1080 rig (f = 1500 px, 100 mm
     baseline); find_chessboard_corners on the card and on the CPU (ok
     flags equal, corners within 5e-3 px, every view within 0.5 px of the
     render's truth), then calibrate_camera and calibrate_stereo on the card
     from the detected corners, held to phase 32's truth limits; 4 views
     each under noise, glare, low contrast, motion blur, an occluding disk
     and perspective foreshortening (synth.boards' OpenCV-free forms), the success
     share and mean error against the truth, card and CPU (ok flags
     equal); validate-distance on the card (a board 2500 mm away seen by
     both cameras: detect -> undistort_points with R1/P1, R2/P2 from
     stereo_rectify of the calibrated rig -> triangulate_points ->
     track.validate_distance, passing at 10% and within 1% of the truth;
     the geometry on the CPU from the same corners within rtol 1e-6);
     rgb_to_gray (256 levels, 10^5 triples) and Otsu (50 images) card ==
     CPU bit for bit; a 1280x720 frame with a drawn ball
     (synth.scenes.ball_frame): hough_circles on the card at full frame and
     on a 240x240 crop on the card and the CPU (equal; the accumulator card
     == CPU), rescore_detections and HostedDetectorClient with a stub
     transport (card against CPU, centres within 1 px of the truth),
     largest_component_mask at 1920x1080 card == CPU; seconds per call of
     find_chessboard_corners (1920x1080) and hough_circles (1280x720), card
     and CPU, with the card's name and power limit.
 34. (run after 33) the CLI's ball-drop and pose chains at 1920x1080 on the
     rig of tests/test_e2e_detectors.py with its field of view scaled to
     1920 px (f = 2100 px, 500 mm baseline): both in-repo networks loaded
     from the JAX package's npz files (297 and 156 leaves); a ball drop
     (synth.scenes.render_ball_drop_stereo without OpenCV, 120 frames a
     camera at 240 fps, 80 mm ball held 25 frames) through
     detect_balls_in_frames on the card, analyze_ball_drop and drop_report
     (found in > 90% of frames, gravity within 5% of 9800 mm/s^2), 8 frames
     a camera card against CPU (the same frames found, centres and radii
     within 1e-2 px, confidences 1e-4, the same kept detections); a stick
     figure (render_pose_stereo, 60 frames a camera) through
     pose_landmarks_in_frames on the card and run_pose_workflow into a
     temporary directory (> 90% of joints fused, median 3D error < 30 mm,
     > 90% of angles finite, median angle error < 4 degrees, the six
     artifacts), 8 frames a camera card against CPU (landmarks within
     2e-2 px, z and visibility 1e-4), fuse_pose_sequence card against CPU
     on the whole sequence (the same joints, within 1e-3 mm); the hosted
     client over local_transport on one frame, card against CPU; seconds
     per call on the card of detect_balls_in_frames (240 frames),
     pose_landmarks_in_frames (120), fuse_pose_sequence (60) and
     smooth_pose_sequence, and the two detectors split into their stages
     with CUDA events, with the card's name and power limit.
 35. (run after 34) training both detectors on the card at the trainers'
     defaults (batch 16; YOLOv8n at 128x128, PoseNet w32 at 256x256;
     AdamW under the warmup-cosine schedule): one batch of each rendered by
     the port (synth.scenes.ball_training_batch / pose_training_batch, seed
     35); parity: each trainer's step (models.pretrained._make_bn_train_step)
     twice from the in-repo weights on the card and on the CPU (the loss
     within rtol 1e-4, every gradient within TRAIN_GRAD_NET of the
     network's largest and each leaf within TRAIN_GRAD_LEAF of its own
     largest (TRAIN_GRAD_FLOOR of the network's where that is more), the
     running statistics within 1e-4 of each leaf's largest, the parameters
     unmoved by step 1 (lr 0) and within
     TRAIN_PARAM_LRS x lr of each other after step 2); then
     train_ball_detector (TRAIN_BALL_STEPS steps) and train_pose_net
     (TRAIN_POSE_STEPS, scan_chunk 25) from flax's initialisation on the
     card into a temporary directory, the batches' pixels rendered on a
     pool of processes (synth.scenes.render_pool; one pool for both,
     spawned at the phase's start): the mean loss of the last tenth of
     the steps below that of the first tenth, the saved npz read back by
     convert.load_tree giving the trained model's forward bit for bit, its
     arrays as many and shaped as the in-repo npz's; CUDA-event ms of a
     step split into forward + loss, backward and the optimizer, host ms to
     render a batch, steps/s and images/s of each trainer, with the card's
     name and power limit.
 36. (run after 35) several devices, on meshes of logical shards of the card
     (the same torch.device named at every position: every band boundary,
     carry exchange, split and gather runs, but nothing runs in parallel)
     and, where torch.cuda.device_count() >= 2, again on distinct cards; an
     earlier line says which and the device count: sgm_aggregate_sharded on
     4 bands of 2 frames of exact8's cost volume (cost_volume in int32,
     720x1152, D=128) at 8 and 4 paths bit-equal to sgm_cuda.aggregate_8;
     stereo_sgbm_sharded on 4 bands of 2 frames at 1280x720 with exact8's
     parameters bit-equal to stereo_sgbm, the horizontal (#3), WTA (#8), LR
     (#9) and speckle (#12) kernels' launches asserted (16, 4, 4, 1); each
     beside the same call on a 1x1 mesh (host ms, band-ticks run);
     make_sharded_pipeline on 2x1 and 4x1 for exact8 (4 frames a device),
     hier16x3 (8) and bm1080 (8), every share bit-equal to
     batched_stereo_pipeline on its frames (points within rtol 1e-6), host
     ms beside the shares run one after another through a 1x1 closure;
     StereoStreamProcessor on 2x1, three hier16x3 windows, the drained last
     one equal to the batched pipeline's shares; make_train_step with
     PoseNet w32 (in-repo weights, eval mode, Adam 1e-3, 256x256, batch 16)
     on 2x2 against 1x1, two steps: losses within rtol 1e-5, parameters
     within 1e-4 of the largest, the Dense kernel's shards its output rows
     on the space devices; host ms a step; the 1x1 step's host ms with its
     TorchFunctionMode and without, in turns (the same losses); then ROADMAP
     C.9's repair: a forward pass in train() mode (PoseNet w32 at 128x128,
     batch 8, and torch's Linear -> BatchNorm1d -> Linear), three steps at
     lr 0 on 2x1 and 2x2 against 1x1 (cuDNN deterministic): loss within rtol
     1e-5, every gradient within 1e-5 of its leaf's largest + 1e-6, batch
     statistics unmoved; host ms a step (the first on 2x1 and 2x2 probes).
 37. (run after 36) two video files to disparity and 3D through
     stream_video_pair on the card: the machine's decoders listed (ffmpeg,
     ffprobe, the av / cv2 / torchvision modules, NVDEC's library), both
     native modules built by g++ and the frame ring the native one (else it
     fails); for the stream CLI's default matcher (sgbm_hier at window 32,
     hier4x3 with p3, 1280x720, 67 RGBA frames a camera) and BASELINE config
     #5's BM (window 8, 1920x1080, 19 Y800 frames), each pair written by the
     port's raw-AVI writer to a temporary directory and read back equal to
     the frames written; three streams of it (full output, stats_only, full
     output kept), each with the path's kernel counts set to 0 before and
     read after (a window's launches equal batched_stereo_pipeline's, none
     0), every window's disparity and points bit-equal to
     batched_stereo_pipeline on the same gray frames (the ring's 8.8 pack),
     stats_only equal to _frame_stats, seqs and n_valid (the tail window
     padded); frames/s end to end and steady (after the first window) of
     both outputs, decode + pack alone (StereoPairLoader) and the pipeline
     alone (make_sharded_pipeline on card-resident frames, ms a window),
     with the card's name and power limit.
 38. (run after 37) the CLI on the card: pipeline.cli.main in process, at
     its default --device cuda, through one temporary test directory (see
     CLI_*): whether matplotlib imports here (printed); intrinsic ->
     extrinsic -> rectify on raw AVI videos of 12 rendered 1920x1080 views a
     camera (phase 33's rig, the CLI's default 7x4 board), held to
     find_chessboard_corners + calibrate_camera / calibrate_stereo /
     stereo_rectify + init_undistort_rectify_map on the card (phase 32's
     tolerances, maps within 1e-3 px, phase 32's truth limits); sync on a
     1280x720 pair (the command samples every 15th frame, as the
     reference's: a 15-frame lag is an offset of 1) equal to
     synchronize_streams; stream at its default windows for sgbm_hier (32),
     sgbm (8, with --video-out) at 1280x720 and bm (8) at 1920x1080, D =
     128, two windows each: the per-frame stats (and sgbm's --video-out
     frames) equal to stream_video_pair's and the path's kernel launches
     equal to its (counts set to 0 before each, some kernel launched); disparity (sgbm and bm, D = 64) on a 1280x720
     PNG pair bit-equal to stereo_sgbm / stereo_bm, launches equal;
     validate-distance on a rendered board pair (within 1% of the truth),
     ball-drop and pose on 1920x1080 renders equal to the library calls,
     smooth equal to MotionSmoother, measure equal to measure_clicks;
     ball-drop --animate, animate and analyze draw with matplotlib, and
     where it is missing must raise the documented ImportError; each
     command's host seconds with the card's name and power limit.
Phase 20 also holds ROADMAP C.1-C.4's and C.7's settings card against CPU: a
frame no wider than its range (stereo_sgbm, no kernel launched; the
per-frame and batched hier at 32x64), BM on frames smaller than the block
(no kernel launched), blocks 4 and 6 through both cost kernels and through
stereo_sgbm and the per-frame hier, hier_params ignored by matcher="sgbm" /
"bm", and the per-frame hier with 1, 2 and 3 coarse lanes (and its refusal
at 5 and 6, before any launch).
The exact8 main path (5) and the two-stage call (13) assert one device launch
of the vertical scan and print its cluster size; the bm phases (14, 15)
assert the packed row form.
The pyramid's rows carry a library time: torch's avg_pool2d, rounded half to
even, a level and image, on the same arguments (equal to the kernel's output).
Every row of the kernels line names the storage type its volumes ran in
("storage"; null for a kernel without a volume) and its ms per level of the
path ("ms_by_level"); every main path stores int16.
The next-to-last line is the kernels' JSON, the last the device JSON.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import ctypes.util
import dataclasses
import importlib.util
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_vision_tpu_torch import _build, calib, detect, native, ops, sync, track
from stereo_vision_tpu_torch.io import video as io_video
from stereo_vision_tpu_torch.io.loader import FrameRing, StereoPairLoader
from stereo_vision_tpu_torch.models import convert, layers, pose, pretrained, yolov8
from stereo_vision_tpu_torch.models import train as train_models
from stereo_vision_tpu_torch.ops.remap import remap_bilinear
from stereo_vision_tpu_torch.parallel import sgm_sharded, streaming
from stereo_vision_tpu_torch.parallel.mesh import ShardedTensor, create_mesh
from stereo_vision_tpu_torch.parallel.streaming import (StereoStreamProcessor, batched_stereo_pipeline,
                                                         make_sharded_pipeline, stream_video_pair)
from stereo_vision_tpu_torch.stereo import (banded_cuda, bm, bm_cuda, cost_cuda, hier, lr_cuda, postprocess, sgbm,
                                            sgm_cuda, speckle_cuda)
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams
from stereo_vision_tpu_torch.stereo.depth import reproject_disparity_to_3d
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, stereo_sgbm, subpixel_disp16
from stereo_vision_tpu_torch.synth.boards import (add_glare, add_noise, board_views, low_contrast, motion_blur, occlude,
                                                  render_board_view, warp_perspective)
from stereo_vision_tpu_torch.synth.scenes import (LR_MODES, WTA_MODES, agreement, ball_frame, ball_training_batch,
                                                  draw_ball, flash_streams, lr_maps, pose_training_batch,
                                                  render_ball_drop_stereo, render_pose_stereo, render_pool, scene,
                                                  scene_occ, scene_truth, speckle_patterns, wta_volumes)
from stereo_vision_tpu_torch.track.pose_pipeline import run_pose_workflow

H, W, D, B = 720, 1280, 128, 4
# bench.py's exact8 mode (BASELINE config #2).
PARAMS = StereoSGBMParams(num_disparities=D, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                          speckle_window_size=100, speckle_range=2)
# Floors for the ramp+box scene, from a CPU run of the plain forms at
# 240x480 with these parameters and rig() maps (valid 0.9672, within-1px
# 0.9994 over the columns x >= min_x), lowered by a margin for the larger frame.
VALID_FLOOR, WITHIN1_FLOOR = 0.90, 0.98
# H100 SXM data-sheet peaks: HBM bytes/s, and 32-bit integer operations/s
# counted against the 67 T/s non-tensor float32 rate (the data sheet gives
# no int32 rate; int32 issues at most that fast, so the bound stays a bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SOURCES = {name: f"stereo_vision_tpu_torch/csrc/{name}.cu"
           for name in ("cost", "sgm", "banded", "banded_cost", "banded_wta", "downsample", "lr", "speckle", "bm")}
# The hier main path: bench.py's hier4x3 mode (HIER4_FAST with p3, 32 frames
# per call, bench.py:162-188).
HIER_P, HP = 32, hier.HIER4_FAST
P3 = PARAMS._replace(num_paths=3)
P8 = PARAMS  # hier4x8: the same parameters at num_paths=8
PLAIN_FRAMES = 4  # frames the plain forms run on beside the 32-frame kernel calls
# The BM main path: `stream --matcher bm`'s defaults (D 128, block 5, windows
# of 8 frames; stereo_vision_tpu/pipeline/cli.py:292, 311-314) at BASELINE
# config #5's 1080p; the other StereoBMParams at their defaults.
BM_H, BM_W, BM_B = 1080, 1920, 8
BM_PARAMS = StereoBMParams(num_disparities=128, block_size=5)
BM_PLAIN_FRAMES = 2  # frames the plain form runs on beside the 8-frame kernel call
# Floors for the ramp+box scene, from a CPU run of the plain forms at 240x480
# with these parameters and rig() maps (valid 0.8739, within-1px 0.9089 over
# the window centres that see the full disparity range), lowered by a margin.
BM_VALID_FLOOR, BM_WITHIN1_FLOOR = 0.80, 0.85
# BENCH_r05.json's agreement against exact8 (the round-5 run of bench.py), per scene.
BENCH_R05_AGREEMENT = {"hier4x3": {"rampbox": 0.9952, "occl": 0.9966, "jump110": 0.9923},
                       "hier16x3": {"rampbox": 0.9953, "occl": 0.9974, "jump110": 0.9935}}
# The hier16x3 path: bench.py's hier16x3 mode (HIER_FAST with p3, 8 frames a
# call, bench.py:185-186), which matcher="sgbm_hier" picks for 8 frames.
H16_P, H16_HP = 8, hier.HIER_FAST
# The distorted 1920x1080 rig of tests/test_rectify_remap.py.
RIG_K1 = np.array([[1400.0, 0, 960], [0, 1410.0, 540], [0, 0, 1]])
RIG_K2 = np.array([[1390.0, 0, 955], [0, 1402.0, 545], [0, 0, 1]])
RIG_D1 = np.array([-0.28, 0.09, 1.2e-3, -8e-4, -0.012])
RIG_D2 = np.array([-0.25, 0.07, -9e-4, 6e-4, -0.010])
RIG_RVEC, RIG_T, RIG_SIZE = [0.02, -0.35, 0.015], [-3500.0, 25.0, 120.0], (1920, 1080)
GEOMETRY_MATCHES = 100_000  # synthetic matches triangulated on the card and on the CPU
# The kernels checked on recorded main-path arguments: wrapper, source, the
# TPU kernel it replaces. banded_vertical_diag is banded_vertical called with
# with_diagonals=True.
KERNELS = {
    "downsample_pyramid": (banded_cuda.downsample_pyramid, SOURCES["downsample"],
                           "stereo_vision_tpu/stereo/banded_pallas.py:395 _downsample_kernel (downsample_box_pack:416, "
                           "pallas_call :435)"),
    "banded_cost": (banded_cuda.banded_cost, SOURCES["banded_cost"],
                    "stereo_vision_tpu/stereo/banded_pallas.py:152 _pix_kernel + :512 _aligned_box_kernel_srows"),
    "banded_vertical": (banded_cuda.banded_vertical, SOURCES["banded"],
                        "stereo_vision_tpu/stereo/banded_pallas.py:666 _vert_kernel"),
    "banded_horizontal": (banded_cuda.banded_horizontal, SOURCES["banded"],
                          "stereo_vision_tpu/stereo/banded_pallas.py:759 _horiz_kernel"),
    "banded_wta": (banded_cuda.banded_wta, SOURCES["banded_wta"],
                   "stereo_vision_tpu/stereo/banded_pallas.py:815 _wta_kernel"),
    "lr_fail_packed": (lr_cuda.lr_fail_packed, SOURCES["lr"], "stereo_vision_tpu/stereo/lr_pallas.py:30 _lr_kernel"),
    "speckle_filter": (speckle_cuda.speckle_filter, SOURCES["speckle"],
                       "stereo_vision_tpu/stereo/speckle_pallas.py:81 _speckle_kernel"),
    "lr_fail": (lr_cuda.lr_fail, SOURCES["lr"],
                "stereo_vision_tpu/stereo/lr_pallas.py:30 _lr_kernel (lr_fail_pallas:137)"),
    "banded_vertical_diag": (banded_cuda.banded_vertical, "stereo_vision_tpu_torch/csrc/banded_diag.cuh",
                             "stereo_vision_tpu/stereo/banded_pallas.py:666 _vert_kernel (with_diag)"),
    "horizontal_rl_wta": (sgm_cuda.horizontal_rl_wta, SOURCES["sgm"],
                          "stereo_vision_tpu/stereo/sgm_pallas.py:538 _horizontal_rl_wta_kernel:360"),
    "bm_disparity": (bm_cuda.bm_disparity, SOURCES["bm"],
                     "stereo_vision_tpu/stereo/bm_pallas.py:183 bm_stats_pallas:135 (_bm_kernel:27)"),
    "banded_wta_fused": (banded_cuda.banded_wta_fused, SOURCES["banded_wta"],
                         "stereo_vision_tpu/stereo/banded_pallas.py:1204 _wta_fused_kernel:888"),
}
HIER_KERNEL_NAMES = ("downsample_pyramid", "banded_cost", "banded_vertical", "banded_horizontal", "banded_wta",
                     "lr_fail_packed", "speckle_filter")
RECORDED_HIER_KERNELS = HIER_KERNEL_NAMES + ("banded_wta_fused",)
# One PyTorch call computing a kernel's function, timed beside it on its
# recorded arguments (the port never calls it): the pyramid's box means are
# avg_pool2d's a level and image, rounded half to even; its factors are
# powers of two, so the float32 mean is exact as the reference's division.
LIBRARY = {
    "downsample_pyramid": lambda left, right, factors: tuple(
        tuple(torch.round(torch.nn.functional.avg_pool2d(img.float()[:, None], f))[:, 0].to(torch.int32)
              for img in (left, right)) for f in factors),
}
# Each kernel's plain form, called with the wrapper's arguments.
PLAIN = {
    "downsample_pyramid": banded_cuda.downsample_pyramid_plain,
    "banded_cost": banded_cuda.banded_cost_plain,
    "banded_vertical": lambda C, s, G, P1, P2, *, cost_bound, with_diagonals=False:
        banded_cuda.vertical_plain(C, s, G, P1, P2, with_diagonals),
    "banded_horizontal": lambda C, s, G, P1, P2, *, cost_bound, reverse=False:
        banded_cuda.horizontal_plain(C, s, G, P1, P2, reverse),
    "banded_wta": banded_cuda.banded_wta_plain,
    "lr_fail_packed": lr_cuda.lr_fail_packed_plain,
    "speckle_filter": speckle_cuda.speckle_filter_plain,
    "lr_fail": sgbm.lr_fail,
    "horizontal_rl_wta": sgm_cuda.horizontal_rl_wta_plain,
    "bm_disparity": bm.valid_disparity_plain,
    "banded_wta_fused": lambda volumes, s, uniq, **_: banded_cuda.banded_wta_fused_plain(volumes, s, uniq),
}
PLAIN["banded_vertical_diag"] = PLAIN["banded_vertical"]


def rig(h: int, w: int):
    """Smooth non-identity rectification maps (same sub-pixel warp for both
    views, so the scene's disparity survives within a fraction of a pixel)
    and the Q of a rectified rig (f = 1000 px, baseline 0.1 m)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = xx + 0.3 * np.sin(2 * np.pi * yy / h)
    my = yy + 0.25 * np.cos(2 * np.pi * xx / w)
    maps = tuple(a.astype(np.float32) for a in (mx, my, mx, my))
    Q = np.array([[1, 0, 0, -w / 2], [0, 1, 0, -h / 2], [0, 0, 0, 1000.0], [0, 0, 10.0, 0]], np.float32)
    return maps, Q


def quality(disp: np.ndarray, truth: np.ndarray, min_x: int) -> tuple[float, float]:
    """(valid share, within-1px share of the valid pixels) over x >= min_x."""
    d, t = disp[..., min_x:], np.broadcast_to(truth, disp.shape)[..., min_x:]
    valid = d > PARAMS.min_disparity - 1
    return float(valid.mean()), float((np.abs(d - t)[valid] <= 1.0).mean())


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(out, ref) -> float:
    """Largest |out - ref| over the tensors, in float64 (exact for the
    int32 maps and volumes and for float32 disparities)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) for a, b in zip(outs, refs))


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def host_ms(fn, reps: int = 3) -> float:
    """Host-clock ms per call of ``fn()`` over ``reps`` calls ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_kernel(name, src, replaces, kern, plain, nbytes, nops, reps: int, path: str, storage=None):
    """``kern()`` against ``plain()``: exact, same shapes. Then CUDA-event ms
    of both (``reps`` kernel runs, one plain run) and the bound. Returns a
    kernels-line row (launches 0 until a path's count is read) and the
    kernel's output. ``storage``: the dtype of the kernel's volumes (None: it
    has none)."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    outs, refs = (out if isinstance(out, tuple) else (out,)), (ref if isinstance(ref, tuple) else (ref,))
    err = max_abs_err(outs, refs)
    if err != 0 or len(outs) != len(refs) or any(a.shape != b.shape for a, b in zip(outs, refs)):
        raise AssertionError(f"{name} ({path}): kernel differs from its plain form (max abs err {err})")
    del ref, refs
    ms, plain_ms = event_ms(kern, reps), event_ms(plain, 1)
    b_ms, b_by = bound_ms(nbytes, nops)
    print(f"kernel {name} ({path}): exact, {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})",
          flush=True)
    storage = None if storage is None else str(storage).removeprefix("torch.")
    return dict(name=name, route="cuda", source=src, replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, path=path, storage=storage,
                ms_by_level={path: ms}), out


def phase_kernels(dev) -> list[dict]:
    """Each kernel against its plain form at the main path's shapes."""
    frames = [scene(seed=s) for s in range(B)]
    left = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    right = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    p = PARAMS
    minX1 = p.min_disparity + D
    Wv = W - minX1
    n = B * H * Wv * D  # elements of one volume
    vol = n * 2  # bytes of one int16 volume
    ckw = dict(ndisp=D, mindisp=p.min_disparity, block_size=p.block_size, ftzero=p.ftzero, x_offset=minX1)
    P1, P2, bound = p.P1, p.P2, p.cost_bound
    st = sgm_cuda.storage_dtype(bound, P2, 3)  # what the main path stores
    if st != torch.int16:
        raise AssertionError(f"the exact8 main path would store {st}, not int16")
    rows = []

    def check(name, src, replaces, kern, plain, nbytes, nops, reps, storage=None):
        row, out = check_kernel(name, src, replaces, kern, plain, nbytes, nops, reps, "exact8", storage)
        rows.append(row)
        return out

    # Operation counts per element, 32-bit integer ops: BT cost of two
    # channels (2 x 9) + shift/add (2) + separable box (2 (bs-1)); one SGM
    # direction step ~8 (3 min, 2 add, add/sub, min-reduce); WTA ~10.
    C = check("cost", SOURCES["cost"], "stereo_vision_tpu/stereo/cost_pallas.py:107 _cost_kernel",
              lambda: cost_cuda.cost_volume(left, right, **ckw),
              lambda: cost_cuda.cost_volume_plain(left, right, **ckw),
              2 * B * H * W * 4 + vol, n * (20 + 2 * (p.block_size - 1)), 10, st)
    vols = list(check("vertical", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:70 _vertical_kernel",
                      lambda: sgm_cuda.vertical(C, P1, P2, True, bound),
                      lambda: sgm_cuda.vertical_plain(C, P1, P2, True),
                      3 * vol, n * (6 * 8 + 4), 5, st))
    vols.append(check("horizontal", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:143 _horizontal_kernel",
                      lambda: sgm_cuda.horizontal(C, P1, P2, False, bound),
                      lambda: sgm_cuda.horizontal_plain(C, P1, P2, False),
                      2 * vol, n * 8, 10, st))
    rl = sgm_cuda.horizontal(C, P1, P2, True, bound)
    if max_abs_err(rl, sgm_cuda.horizontal_plain(C, P1, P2, True)) != 0:
        raise AssertionError("horizontal R->L differs from its plain form")
    vols.append(rl)
    check("wta4", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:331 _wta4_kernel",
          lambda: sgm_cuda.wta4(vols, p.uniqueness_ratio),
          lambda: sgm_cuda.wta4_plain(vols, p.uniqueness_ratio),
          4 * vol + B * H * Wv * (5 * 4 + 1), n * 10, 10, st)

    # The unpacked LR kernel at min_disparity 16, ndisp 64 (the main path runs
    # min_disparity 0; it is checked on the path's own arguments later).
    rng = np.random.default_rng(16)
    nd, md = 64, 16
    shape = (B, H, W - nd - md)
    best = rng.integers(0, nd, shape)
    disp = (best * 16 + rng.integers(-8, 9, shape)) / 16.0 + md
    disp[rng.random(shape) < 0.05] = md - 1
    minS, best, disp = (torch.from_numpy(a).to(dev) for a in (rng.integers(0, 60, shape).astype(np.int32),
                                                               best.astype(np.int32), disp.astype(np.float32)))
    kw = dict(W=W, min_x=nd + md, ndisp=nd, mindisp=md, max_diff=1)
    out, ref = lr_cuda.lr_fail(minS, best, disp, **kw), sgbm.lr_fail(minS, best, disp, **kw)
    if not torch.equal(out, ref) or not ref.any():
        raise AssertionError("lr_fail at min_disparity 16 differs from its plain form")
    print(f"kernel lr_fail min_disparity {md}, ndisp {nd}, {B}x{H}x{shape[-1]}: exact", flush=True)
    return rows


def phase_small_pipeline(dev) -> None:
    h, w, b = 240, 320, 2
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(b)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    p = PARAMS._replace(num_disparities=64)
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device=dev)
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
    if not torch.equal(d_gpu.cpu(), d_cpu):
        raise AssertionError("CUDA and CPU disparities differ at 240x320")
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
    print(f"pipeline 240x320 D=64 B=2: CUDA == CPU (valid share {float((d_cpu > -1).float().mean()):.4f})",
          flush=True)


def phase_main_path(dev, rows: list[dict]) -> tuple[dict, dict, torch.Tensor]:
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    wrappers = {"cost": cost_cuda.cost_volume, "vertical": sgm_cuda.vertical, "horizontal": sgm_cuda.horizontal,
                "wta4": sgm_cuda.wta4, "lr_fail": lr_cuda.lr_fail, "speckle_filter": speckle_cuda.speckle_filter}
    for fn in wrappers.values():
        fn.launches = 0
    sgm_cuda.vertical.device_launches = 0
    disp, pts = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    plan = sgm_cuda.vertical.plan
    print("main path launches:", json.dumps(counts), f"(vertical: {sgm_cuda.vertical.device_launches} device "
          f"launch, clusters of {plan['cluster']} blocks of {plan['columns']} columns)", flush=True)
    if sgm_cuda.vertical.device_launches != 1:
        raise AssertionError(f"the exact8 vertical scan made {sgm_cuda.vertical.device_launches} device launches")
    for row in rows:
        row["launches"] = counts[row["name"]]
        if row["name"] == "vertical":
            row.update(device_launches=sgm_cuda.vertical.device_launches, cluster=plan["cluster"])
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")

    d = disp.cpu().numpy()
    pz = pts[..., 2].cpu().numpy()
    if d.shape != (B, H, W) or pts.shape != (B, H, W, 3) or not np.isfinite(d).all():
        raise AssertionError(f"bad output: disparity {d.shape}, points {tuple(pts.shape)}")
    valid_share, within1 = quality(d, scene_truth(H, W), PARAMS.min_disparity + D)
    good = d > 0
    if not np.isfinite(pz[good]).all():
        raise AssertionError("non-finite depth at a positive disparity")
    print(f"main path quality: valid share {valid_share:.4f} (floor {VALID_FLOOR}), "
          f"within 1 px {within1:.4f} (floor {WITHIN1_FLOOR})", flush=True)
    if valid_share < VALID_FLOOR or within1 < WITHIN1_FLOOR:
        raise AssertionError("main path quality below its floor")

    lt, rt = torch.from_numpy(lb).to(dev), torch.from_numpy(rb).to(dev)
    ms = host_ms(lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm", params=PARAMS, device=dev))
    return dict(ms_per_call=ms, frames_per_call=B, mpx_per_s=B * H * W / ms / 1e3,
                frames_per_s=B / ms * 1e3, valid_share=valid_share, within1_share=within1), counts, disp


def record_exact_call(dev, disp_main: torch.Tensor) -> list[dict]:
    """One more exact main-path call with the cost, LR and speckle kernels'
    arguments recorded; its disparity must equal the main path's."""
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    targets = {"cost": (sgbm, "cost_volume"), "lr_fail": (lr_cuda, "lr_fail"),
               "speckle_filter": (sgbm, "speckle_filter")}
    with Recorder(targets, ("exact8",), keep=True) as rec:
        disp, _ = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(disp, disp_main):
        raise AssertionError("the recorded exact call differs from the main path")
    return rec.calls


# The exact cost kernel's grid (phase 25): blocks, disparity ranges (several
# chunks of 128 and a partial last one above 128), min_disparity, x_offset
# 0 and D, both storage types; frames of 5 rows (shorter than most blocks)
# and D + 53 columns (no tile divides them), 2 frames.
COST_GRID_BLOCKS = (1, 3, 5, 11, 21, 51)
COST_GRID_RANGES = (16, 48, 128, 256, 1024, 1040)


def phase_cost_kernel(dev, record: dict, reports: dict) -> dict:
    """The exact cost kernel (#1): on the arguments the recorded exact8 call
    gave it (4 frames of 1280x720, D=128, block 5), exact against its plain
    form and against the main path's own output, then five timed runs of 10
    launches, its bound and the tile it took; the registers and spills of
    its instantiations from the build's ptxas report; then the grid of
    COST_GRID_BLOCKS x COST_GRID_RANGES x min_disparity -8, 0, 16 x
    x_offset 0 and D x int16 and int32, card against plain."""
    args, kwargs = record["args"], record["kwargs"]
    plain_kw = {k: v for k, v in kwargs.items() if k != "dtype"}
    kern = lambda: cost_cuda.cost_volume(*args, **kwargs)
    got = kern()
    ref = cost_cuda.cost_volume_plain(*args, **plain_kw).to(got.dtype)
    if got.dtype != torch.int16 or not torch.equal(got, ref) or not torch.equal(got, record["out"]):
        raise AssertionError("the cost kernel differs from its plain form on the exact8 main path's arguments")
    del ref
    runs = [event_ms(kern, 10) for _ in range(5)]
    left = args[0]
    nbytes = 2 * left.numel() * 4 + got.numel() * 2
    b_ms, b_by = bound_ms(nbytes, got.numel() * (20 + 2 * (kwargs["block_size"] - 1)))
    dev_index = left.device.index or 0
    tile = cost_cuda._lib().svt_cost_volume_tile(kwargs["ndisp"], kwargs["block_size"], dev_index)
    ptxas = [line.strip() for line in reports.get("cost", "").splitlines() if "Used" in line or "spill" in line]
    print(f"kernel cost (exact8 recorded): exact, runs {[round(r, 4) for r in runs]} ms, bound {b_ms:.4f} ms by "
          f"{b_by}, tile {tile} columns", flush=True)
    del got
    t0 = time.perf_counter()
    cases = 0
    for bs in COST_GRID_BLOCKS:
        for nd in COST_GRID_RANGES:
            rng = np.random.default_rng(nd + bs)
            l, r = (torch.from_numpy(rng.integers(0, 256, (2, 5, nd + 53)).astype(np.int32)) for _ in range(2))
            ld, rd = l.to(dev), r.to(dev)
            for md in (-8, 0, 16):
                full = cost_cuda.cost_volume_plain(l, r, ndisp=nd, mindisp=md, block_size=bs)
                for x_off in (0, nd):
                    for dtype in (torch.int16, torch.int32):
                        if dtype == torch.int16 and cost_cuda.window_bound(bs, 15) >= 1 << 15:
                            continue
                        out = cost_cuda.cost_volume(ld, rd, ndisp=nd, mindisp=md, block_size=bs, x_offset=x_off,
                                                    dtype=dtype)
                        if not torch.equal(out.cpu(), full[:, :, x_off:].to(dtype)):
                            raise AssertionError(f"cost kernel grid: block {bs}, D={nd}, min_disparity {md}, "
                                                 f"x_offset {x_off}, {dtype} differs from its plain form")
                        cases += 1
    grid_s = time.perf_counter() - t0
    print(f"kernel cost grid: {cases} cases exact ({grid_s:.1f} s)", flush=True)
    return dict(runs_ms=runs, bound_ms=b_ms, bound_by=b_by, tile=tile, ptxas=ptxas, grid_cases=cases)


def phase_breakdown(dev) -> dict:
    """CUDA-event ms of each stage of one 4-frame main-path call."""
    maps, Q = rig(H, W)
    mx, my = (torch.from_numpy(m).to(dev) for m in maps[:2])
    Qt = torch.from_numpy(Q).to(dev)
    frames = [scene(seed=s) for s in range(B)]
    lt = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    rt = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    p = PARAMS
    minX1 = p.min_disparity + D
    st = {}

    def stage(name, fn):
        out = fn()  # warm-up
        st[name] = event_ms(fn, 1)
        return out

    li = stage("remap", lambda: torch.round(remap_bilinear(lt.float(), mx, my)).to(torch.int32))
    ri = torch.round(remap_bilinear(rt.float(), mx, my)).to(torch.int32)
    C = stage("cost", lambda: cost_cuda.cost_volume(li, ri, ndisp=D, block_size=p.block_size, ftzero=p.ftzero,
                                                    x_offset=minX1))
    vols = list(stage("vertical", lambda: sgm_cuda.vertical(C, p.P1, p.P2, True, p.cost_bound)))
    vols += [stage("horizontal x2", lambda: (sgm_cuda.horizontal(C, p.P1, p.P2, False, p.cost_bound),
                                             sgm_cuda.horizontal(C, p.P1, p.P2, True, p.cost_bound)))]
    vols = vols[:2] + list(vols[2])
    minS, best, sm, s0, sp, uok = stage("wta4", lambda: sgm_cuda.wta4(vols, p.uniqueness_ratio))
    disp = stage("subpixel", lambda: subpixel_disp16(best, sm, s0, sp, D).float() / 16.0)
    fail = stage("lr_check", lambda: lr_cuda.lr_fail(minS, best, disp, W=W, min_x=minX1, ndisp=D, mindisp=0,
                                                     max_diff=p.disp12_max_diff))
    full = torch.full((B, H, W), -1.0, device=dev)
    full[..., minX1:] = torch.where(uok & ~fail, disp, -1.0)
    out = stage("speckle", lambda: speckle_cuda.speckle_filter(full, 2.0, 100, -1.0))
    stage("reproject", lambda: reproject_disparity_to_3d(out, Qt))
    return {k: round(v, 4) for k, v in st.items()}


def hier_frames(dev):
    """The hier main path's 32 frames (ramp+box scene, seeds 0-31), on the card."""
    frames = [scene(seed=s) for s in range(HIER_P)]
    return (torch.from_numpy(np.stack([f[0] for f in frames])).to(dev),
            torch.from_numpy(np.stack([f[1] for f in frames])).to(dev))


class Recorder:
    """Swaps functions of the port's modules for wrappers that record each
    call's arguments, result and CUDA events around it, for one real call
    of the path; restores the functions on exit. ``targets`` maps a stage
    name to (module, attribute). The first pyramid or banded core call
    after a level's core (``core``) starts the next level, so every record
    carries the level it ran in. With ``keep`` False a record holds no
    tensor, so that the caching allocator reuses memory as in an
    unrecorded call."""

    def __init__(self, targets: dict, levels: tuple[str, ...], keep: bool):
        self.targets, self.levels, self.keep, self.calls = targets, levels, keep, []
        self.level, self.core_done = 0, False

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            if name in ("downsample_pyramid", "core") and self.core_done:
                self.level, self.core_done = self.level + 1, False
            level = self.levels[self.level]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.core_done |= name == "core"
            self.calls.append(dict(name=name, level=level, fn=fn, start=start, end=end))
            if self.keep:
                self.calls[-1].update(args=args, kwargs=kwargs, out=out)
            return out

        # The wrapped kernel wrappers count their launches on the name they are
        # bound to, which is this wrapper while it is swapped in.
        for k, v in vars(fn).items():
            if isinstance(v, int):
                setattr(wrapper, k, 0)
            elif isinstance(v, dict):
                setattr(wrapper, k, dict.fromkeys(v, 0))
        return wrapper

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr)) for mod, attr in self.targets.values()]
        for (name, (mod, attr)), (_, _, fn) in zip(self.targets.items(), self.saved):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def record_hier_call(dev, lt, rt, disp_main: torch.Tensor, keep: bool, params: StereoSGBMParams = P3,
                     maps_q=None, levels=("coarse", "mid", "full")) -> tuple[dict, list[dict]]:
    """One hier main-path call with its stages recorded: the per-stage
    CUDA-event ms (summed per stage and level) and the records of every
    kernel wrapper's calls, with (``keep``) the arguments the kernel checks
    reuse. The call's disparity must equal the main path's. ``maps_q``:
    the (maps, Q) of the call (default: :func:`rig`)."""
    maps, Q = maps_q or rig(H, W)
    targets = {
        "matcher": (streaming, "stereo_sgbm_hier_batch"), "reproject": (streaming, "reproject_disparity_to_3d"),
        "downsample_pyramid": (hier, "downsample_pyramid"), "core": (hier, "banded_stats_pack"),
        "shift maps (plain)": (hier, "shift_map"), "splice (plain)": (hier, "_splice_coarse"),
        "assemble (plain, with the LR kernel)": (hier, "_assemble_disparity"),
        "assemble fused (plain, with the LR kernel)": (hier, "_assemble_fused"),
        "lr_fail_packed": (hier, "lr_fail_packed"), "speckle_filter": (hier, "speckle_filter"),
        **{k: (banded_cuda, k) for k in ("banded_cost", "banded_vertical", "banded_horizontal", "banded_wta",
                                         "banded_wta_fused")},
    }
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with Recorder(targets, levels, keep) as rec:
        start.record()
        disp, _ = batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm_hier", params=params, device=dev)
        end.record()
    torch.cuda.synchronize()
    if not torch.equal(disp, disp_main):
        raise AssertionError("the recorded hier call differs from the main path")
    st = {"call": start.elapsed_time(end)}
    for c in rec.calls:
        key = f"{c['level']} {c['name']}" if c["name"] in RECORDED_HIER_KERNELS + ("core",) else c["name"]
        st[key] = st.get(key, 0.0) + c["start"].elapsed_time(c["end"])
    matcher = next(c for c in rec.calls if c["name"] == "matcher")
    st["remap + round (with the maps' upload)"] = start.elapsed_time(matcher["start"])
    return {k: round(v, 4) for k, v in st.items()}, [c for c in rec.calls if c["name"] in RECORDED_HIER_KERNELS]


def _head(x, n: int):
    """The first n frames of every tensor in x (tensors, lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        return x[:n]
    if isinstance(x, (list, tuple)):
        return type(x)(_head(e, n) for e in x)
    if isinstance(x, dict):
        return {k: _head(v, n) for k, v in x.items()}
    return x


def _flat(x) -> tuple:
    """The tensors of x (a tensor, or tuples and lists of them), in order."""
    if isinstance(x, torch.Tensor):
        return (x,)
    return tuple(t for e in x for t in _flat(e))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(e) for e in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _ops(name: str, args, kwargs, elems: int) -> int:
    """32-bit operations of one kernel call (``elems``: its first output's
    elements): BM ~8 per (valid pixel, disparity) (an absolute difference,
    vertical and horizontal running sums, min and argmin), the fused R->L
    scan + WTA ~21 per (pixel, disparity), banded cost ~20 + 4 bs per lane,
    a scan step ~10 per lane and carry (two directions; three carries each
    with diagonals), WTA ~10
    per lane, LR ~20 per pixel, the pyramid one add per input pixel, speckle
    ~30 per pixel (a union-find labelling's O(1) work a pixel; the capped
    form's walks over the few small components are held to the same count,
    which can only lower its bound)."""
    if name == "banded_cost":
        return elems * (20 + 4 * kwargs["block_size"])
    if name == "banded_vertical":
        return 2 * elems * 10
    if name == "banded_vertical_diag":
        return 6 * elems * 10
    if name == "speckle_filter":
        return elems * 30
    if name in ("banded_wta", "banded_wta_fused"):
        return args[0][0].numel() * 10
    if name == "downsample_pyramid":
        return 2 * args[0].numel()
    if name == "horizontal_rl_wta":  # per (pixel, d): scan step ~8, three adds, WTA ~10
        return args[0].numel() * 21
    if name == "bm_disparity":  # per (valid pixel, d), with running sums both ways
        return elems * kwargs["ndisp"] * 8
    return elems * (20 if name in ("lr_fail_packed", "lr_fail") else 10)


def _storage(name: str, args, out) -> torch.dtype | None:
    """The dtype a kernel call's volumes are stored in (None: it has none)."""
    if name in ("banded_cost", "cost"):
        return out.dtype
    if name in ("banded_vertical", "banded_vertical_diag", "banded_horizontal", "horizontal_rl_wta"):
        return args[0].dtype
    if name in ("banded_wta", "banded_wta_fused"):
        return args[0][0].dtype
    return None


def _kernel_name(call: dict) -> str:
    """A record's kernel: banded_vertical with diagonals is its own kernel."""
    if call["name"] == "banded_vertical" and call["kwargs"].get("with_diagonals"):
        return "banded_vertical_diag"
    return call["name"]


def phase_recorded_kernels(records: list[dict], counts: dict, n: int, path: str) -> list[dict]:
    """Each kernel on the arguments a recorded main-path call gave it: the
    kernel on all frames against its plain form on the first ``n``, exact;
    kernel ms, plain ms and bound summed over the call's launches. Bound:
    the bytes of every input and output once over the HBM rate, or the
    operations (:func:`_ops`) over the peak rate. One row per kernel, with
    the launches of the main path's run (``counts``), the storage type of its
    volumes (int16 on every main path) and its ms per level."""
    acc = {}
    for c in records:
        name, fn, args, kwargs = _kernel_name(c), c["fn"], c["args"], c["kwargs"]
        plain = PLAIN[name]
        out, ref = fn(*args, **kwargs), plain(*_head(args, n), **_head(kwargs, n))
        torch.cuda.synchronize()
        outs, refs = _flat(out), _flat(ref)
        head = _head(outs, n)
        err = max_abs_err(head, refs)
        if err != 0 or len(head) != len(refs) or any(a.shape != b.shape for a, b in zip(head, refs)):
            raise AssertionError(f"{name} ({c['level']}): kernel differs from its plain form (max abs err {err})")
        if not all(torch.equal(a, b) for a, b in zip(outs, _flat(c["out"]))):
            raise AssertionError(f"{name} ({c['level']}): a second launch differs from the main path's")
        ms = event_ms(lambda: fn(*args, **kwargs), 5)
        plain_ms = event_ms(lambda: plain(*_head(args, n), **_head(kwargs, n)), 1)
        lib_ms = None
        if name in LIBRARY:
            lib = LIBRARY[name]
            if not all(torch.equal(a, b) for a, b in zip(_flat(lib(*args, **kwargs)), outs)):
                raise AssertionError(f"{name} ({c['level']}): the library call differs from the kernel")
            lib_ms = event_ms(lambda: lib(*args, **kwargs), 5)
        nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(outs)
        nops = _ops(name, args, kwargs, outs[0].numel())
        storage = _storage(name, args, outs[0])
        if storage not in (None, torch.int16):
            raise AssertionError(f"{name} ({c['level']}) ran in {storage} on the {path} main path, not int16")
        a = acc.setdefault(name, dict(ms=0.0, plain_ms=0.0, nbytes=0.0, nops=0.0, frames=outs[0].shape[0],
                                      storage=storage, levels={}, library_ms=None))
        a["levels"][c["level"]] = a["levels"].get(c["level"], 0.0) + ms
        if lib_ms is not None:
            a["library_ms"] = (a["library_ms"] or 0.0) + lib_ms
        a["ms"] += ms
        a["plain_ms"] += plain_ms
        a["nbytes"] += nbytes
        a["nops"] += nops
        lib_note = "" if lib_ms is None else f", library {lib_ms:.3f} ms"
        print(f"kernel {name} {c['level']}: exact, {ms:.3f} ms at {outs[0].shape[0]} frames "
              f"(plain {plain_ms:.3f} ms at {n} frames, bound {bound_ms(nbytes, nops)[0]:.3f} ms{lib_note})", flush=True)
        if name == "speckle_filter":
            SPECKLE_RECORDS.setdefault(path, dict(args=args, kwargs=kwargs))
        if name in ("banded_vertical", "banded_vertical_diag") and path in VERTICAL_PATHS:
            VERTICAL_RECORDS.setdefault(path, []).append(dict(level=c["level"], args=args, kwargs=kwargs))
        if name in ("banded_wta", "lr_fail_packed") and f"{path} {c['level']}" in WTA_LR_LEVELS[name]:
            WTA_LR_RECORDS[name].setdefault(f"{path} {c['level']}", dict(args=args, kwargs=kwargs))
        if name in ("horizontal_rl_wta", "banded_wta_fused"):
            FUSED_RECORDS.setdefault(name, dict(args=args, kwargs=kwargs, path=path))
        if name in ("downsample_pyramid", "lr_fail"):
            PYRAMID_LR_RECORDS.setdefault(f"{name} ({path})", dict(name=name, path=path, args=args, kwargs=kwargs))

    rows = []
    for name, a in acc.items():
        b_ms, b_by = bound_ms(a["nbytes"], a["nops"])
        src, replaces = KERNELS[name][1:]
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces, launches=counts[name],
                         max_abs_err=0, ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                         library_ms=a["library_ms"], path=path, frames=a["frames"], plain_frames=n,
                         storage=None if a["storage"] is None else str(a["storage"]).removeprefix("torch."),
                         ms_by_level=a["levels"]))
    return rows


# The speckle kernel's arguments on each main path's recorded call, kept by
# phase_recorded_kernels for phase 23.
SPECKLE_RECORDS: dict[str, dict] = {}
# The vertical scan's (#17) arguments on the hier main paths' recorded calls,
# by level, kept by phase_recorded_kernels for phase 28.
VERTICAL_PATHS = ("hier4x3", "hier4x8", "hier16x3")
VERTICAL_RECORDS: dict[str, list[dict]] = {}
# The WTA's (#20) and the packed LR check's (#10) arguments on the hier main
# paths' recorded calls, by path and level, kept by phase_recorded_kernels for
# phase 29.
WTA_LR_LEVELS = {"banded_wta": ("hier4x3 coarse", "hier4x3 mid", "hier4x3 full", "hier16x3 coarse", "hier16x3 full",
                                "hier4x8 full"),
                 "lr_fail_packed": ("hier4x3 full", "hier16x3 full")}
WTA_LR_RECORDS: dict[str, dict[str, dict]] = {"banded_wta": {}, "lr_fail_packed": {}}
# The fused R->L WTA's (#5) arguments on the exact8 fused call and the fused
# banded WTA's (#19) on the hier16x3 fused call, kept by
# phase_recorded_kernels for phase 30.
FUSED_RECORDS: dict[str, dict] = {}
# The pyramid's (#14) arguments on the hier main paths' recorded calls and
# the unpacked LR check's (#9) on the exact8 call's, by "name (path)", kept by
# phase_recorded_kernels for phase 31.
PYRAMID_LR_RECORDS: dict[str, dict] = {}


def check_wta16(records: list[dict]) -> None:
    """The 6-stat WTA at K=16 (HIER_FAST's and HierParams()'s full-res form),
    on 4 frames of the full level's images; on no timed path."""
    full = next(c for c in records if c["name"] == "banded_cost" and c["level"] == "full")
    l, r, s = _head(full["args"], PLAIN_FRAMES)
    p, mx = P3, full["kwargs"]["min_x"]
    kw = dict(full["kwargs"], band=16, G=8)
    s16 = torch.div(s, 8, rounding_mode="floor").mul(8).clamp(max=p.num_disparities - 16)
    C16 = banded_cuda.banded_cost(l, r, s16, **kw)
    sv = s16[:, :, mx:].contiguous()
    v16 = list(banded_cuda.banded_vertical(C16, sv, 8, p.P1, p.P2, cost_bound=p.cost_bound))
    v16.append(banded_cuda.banded_horizontal(C16, sv, 8, p.P1, p.P2, cost_bound=p.cost_bound))
    err = max_abs_err(banded_cuda.banded_wta(v16, p.uniqueness_ratio),
                      banded_cuda.banded_wta_plain(v16, p.uniqueness_ratio))
    if err != 0:
        raise AssertionError(f"banded_wta 6-stat K=16 differs from its plain form (max abs err {err})")
    print("kernel banded_wta 6-stat K=16 (4 frames, 720x1152): exact", flush=True)


def check_diag_random(dev) -> None:
    """The diagonal vertical kernel on per-pixel random shift maps (deltas
    0, +-G, +-2G and beyond, on the G grid and off it): at the full level's
    shape (K=4, G=2, where +-2G resets) and at K=8, G=2 (where +-2G shifts)."""
    p = P8
    for K, G, P, h in ((4, 2, PLAIN_FRAMES, H), (8, 2, 2, 64)):
        rng = np.random.default_rng(K)
        Wv = W - D
        C = torch.from_numpy(rng.integers(0, p.cost_bound + 1, (P, h, Wv, K)).astype(np.int16)).to(dev)
        s = rng.integers(0, 6, (P, h, Wv)) * G + (rng.random((P, h, Wv)) < 0.1) * rng.integers(1, 3, (P, h, Wv))
        s = torch.from_numpy(s.astype(np.int32)).to(dev)
        out = banded_cuda.banded_vertical(C, s, G, p.P1, p.P2, cost_bound=p.cost_bound, with_diagonals=True)
        ref = banded_cuda.vertical_plain(C, s, G, p.P1, p.P2, True)
        err = max_abs_err(out, ref)
        if err != 0:
            raise AssertionError(f"banded_vertical_diag K={K} on random shift maps: max abs err {err}")
        print(f"kernel banded_vertical_diag K={K} G={G}, {P}x{h}x{Wv}, per-pixel random shifts: exact", flush=True)


def phase_hier_small_pipeline(dev) -> None:
    """CUDA == CPU for the hier pipeline at 64x256, 32 frames: the bench's
    p3 (3 paths), StereoSGBMParams() (8 paths; no LR, no speckle) and the
    bench's parameters at 8 paths."""
    h, w = 64, 256
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(HIER_P)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    for label, params in (("p3", P3), ("StereoSGBMParams()", StereoSGBMParams()), ("p3 at 8 paths", P8)):
        d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=params, device=dev)
        d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=params, device="cpu")
        if not torch.equal(d_gpu.cpu(), d_cpu):
            raise AssertionError(f"CUDA and CPU hier disparities differ at 64x256 ({label})")
        torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
        print(f"hier pipeline 64x256 D=128 P=32, {label}: CUDA == CPU "
              f"(valid share {float((d_cpu > -1).float().mean()):.4f})", flush=True)


def phase_hier_main_path(dev, lt, rt, params: StereoSGBMParams, label: str, maps_q=None,
                         names: tuple[str, ...] = HIER_KERNEL_NAMES) -> tuple[dict, dict, torch.Tensor]:
    """One hier main-path call of ``lt.shape[0]`` frames with the counts of
    the kernels ``names`` set to 0 before it and read after it (each must
    have launched), its output's shape and quality floors, then ms per call
    over 3 calls. ``maps_q``: the (maps, Q) of the call (default: :func:`rig`)."""
    maps, Q = maps_q or rig(H, W)
    P = lt.shape[0]
    wrappers = {name: KERNELS[name][0] for name in names}
    for fn in wrappers.values():
        fn.launches = 0
    banded_cuda.banded_vertical.diagonal_launches = 0
    disp, pts = batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm_hier", params=params, device=dev)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    if params.num_paths == 8:  # banded_vertical counts both kernels: split them
        counts["banded_vertical_diag"] = banded_cuda.banded_vertical.diagonal_launches
        counts["banded_vertical"] -= counts["banded_vertical_diag"]
    print(f"{label} main path launches:", json.dumps(counts), flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the {label} main path never launched: {counts}")
    if counts["downsample_pyramid"] != 1:
        raise AssertionError(f"the {label} pyramid took {counts['downsample_pyramid']} launches, not 1")

    d = disp.cpu().numpy()
    if d.shape != (P, H, W) or pts.shape != (P, H, W, 3) or not np.isfinite(d).all():
        raise AssertionError(f"bad {label} output: disparity {d.shape}, points {tuple(pts.shape)}")
    if not np.isfinite(pts[..., 2].cpu().numpy()[d > 0]).all():
        raise AssertionError("non-finite depth at a positive disparity")
    valid_share, within1 = quality(d, scene_truth(H, W), D)
    print(f"{label} main path quality: valid share {valid_share:.4f} (floor {VALID_FLOOR}), "
          f"within 1 px {within1:.4f} (floor {WITHIN1_FLOOR})", flush=True)
    if valid_share < VALID_FLOOR or within1 < WITHIN1_FLOOR:
        raise AssertionError(f"{label} main path quality below its floor")

    ms = host_ms(lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm_hier", params=params, device=dev))
    print(f"{label} main path 1280x720 D={D} P={P}: {ms:.2f} ms per call, {P * H * W / ms / 1e3:.2f} "
          f"Mpx/s, {P / ms * 1e3:.2f} frames/s", flush=True)
    return dict(ms_per_call=ms, frames_per_call=P, mpx_per_s=P * H * W / ms / 1e3,
                frames_per_s=P / ms * 1e3, valid_share=valid_share, within1_share=within1), counts, disp


def phase_agreement(dev) -> dict:
    """bench.py's gate: hier4x3 and hier4x8 (32 copies per call) and
    hier16x3 (8 copies, unfused and with ``hier._FUSED_STATS`` set) against
    exact8 on the first frame of each scene, straight to the matchers (no
    remap). hier4x3 and both hier16x3 forms must equal BENCH_r05.json's
    values to its four decimals."""
    scenes = {"rampbox": scene(0), "occl": scene_occ(2), "jump110": scene(3, box_disp=110.0)}
    modes = {"hier4x3": (P3, HP, HIER_P, False), "hier4x8": (P8, HP, HIER_P, False),
             "hier16x3": (P3, H16_HP, H16_P, False), "hier16x3 fused": (P3, H16_HP, H16_P, True)}
    out = {mode: {} for mode in modes}
    prev = hier._FUSED_STATS
    try:
        for name, (l, r) in scenes.items():
            lt, rt = torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev)
            exact = stereo_sgbm(lt[None], rt[None], PARAMS)[0].cpu().numpy()
            for mode, (params, hp, n, fused) in modes.items():
                hier._FUSED_STATS = fused
                disp = hier.stereo_sgbm_hier_batch(lt.expand(n, -1, -1), rt.expand(n, -1, -1), params, hp)[0]
                out[mode][name] = agreement(disp.cpu().numpy(), exact)
            print(f"agreement vs exact8, {name}: " + ", ".join(f"{m} {a[name]:.4f}" for m, a in out.items())
                  + f" (BENCH_r05.json hier4x3 {BENCH_R05_AGREEMENT['hier4x3'][name]}, hier16x3 "
                  f"{BENCH_R05_AGREEMENT['hier16x3'][name]})", flush=True)
    finally:
        hier._FUSED_STATS = prev
    for mode, agree in out.items():
        if min(agree.values()) < 0.98:
            raise AssertionError(f"{mode} agreement below the bench gate 0.98: {agree}")
        want = BENCH_R05_AGREEMENT.get(mode.split()[0]) if mode != "hier4x8" else None
        if want and {k: round(v, 4) for k, v in agree.items()} != want:
            raise AssertionError(f"{mode} agreement {agree} differs from BENCH_r05.json's {want}")
    return out


def phase_fused_rl(dev, disp_main: torch.Tensor) -> tuple[dict, list[dict]]:
    """The exact8 main path with ``sgm_cuda._FUSED_RL_WTA`` set: its launch
    counts, its disparity against the unfused main path's, the fused kernel
    on a recorded call's arguments against its plain form, and ms per call
    of both forms in turns (5 calls each, frames on the card as in
    :func:`phase_main_path`'s timing). The flag is restored."""
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    run = lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    wrappers = {"vertical": sgm_cuda.vertical, "horizontal": sgm_cuda.horizontal, "wta4": sgm_cuda.wta4,
                "horizontal_rl_wta": sgm_cuda.horizontal_rl_wta}
    prev = sgm_cuda._FUSED_RL_WTA
    try:
        sgm_cuda._FUSED_RL_WTA = True
        for fn in wrappers.values():
            fn.launches = 0
        disp, _ = run()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        print("exact8 fused main path launches:", json.dumps(counts), flush=True)
        if counts["horizontal_rl_wta"] != 1 or counts["horizontal"] != 1 or counts["wta4"] != 0:
            raise AssertionError(f"the fused exact8 call did not take the fused R->L kernel: {counts}")
        if not torch.equal(disp.cpu(), disp_main):
            raise AssertionError("the fused exact8 disparity differs from the unfused one")
        with Recorder({"horizontal_rl_wta": (sgm_cuda, "horizontal_rl_wta")}, ("exact8 fused",), keep=True) as rec:
            run()
        rows = phase_recorded_kernels(rec.calls, counts, B, "exact8 fused")
        del rec
        torch.cuda.empty_cache()
        timings = {"unfused": [], "fused": []}
        for fused in (False, True, True, False):
            sgm_cuda._FUSED_RL_WTA = fused
            timings["fused" if fused else "unfused"].append(host_ms(run, reps=5))
    finally:
        sgm_cuda._FUSED_RL_WTA = prev
    out = {k: sum(v) / len(v) for k, v in timings.items()}
    print(f"exact8 ms per {B}-frame call: unfused {timings['unfused']}, fused {timings['fused']}", flush=True)
    return {**out, "runs": timings}, rows


def phase_sgm_sites(dev) -> tuple[dict, list[dict]]:
    """aggregate_8 (8 and 4 paths) and wta_stats on one 1280x720, D=128
    exact8 cost volume, each against its plain form, exact; then one
    two-stage call (aggregate_8 then wta_stats) with the counts set to 0
    before it, whose maps must equal sgm_reduce's. The 4-path row goes to
    the summary: the two-stage call runs 8 paths."""
    left, right = (torch.from_numpy(a)[None].to(dev) for a in scene(seed=0))
    p = PARAMS
    C = cost_cuda.cost_volume(left, right, ndisp=D, block_size=p.block_size, ftzero=p.ftzero, x_offset=D)
    n = C.numel()
    agg = {}
    for paths in (8, 4):
        # Bytes: the int16 cost in, the int32 volume out; operations: ~8 a
        # direction step and the adds of the directions, per element.
        agg[paths], _ = check_kernel(
            "aggregate_8", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:202 + :240 aggregate_8_pallas:171 "
            "(_vertical_kernel:70, _horizontal_kernel:143)",
            lambda: sgm_cuda.aggregate_8(C, p.P1, p.P2, paths, cost_bound=p.cost_bound),
            lambda: sgm_cuda._aggregate_8(C, p.P1, p.P2, paths), n * 6, n * (9 * paths - 1), 3, f"{paths} paths",
            C.dtype)
        torch.cuda.empty_cache()
    S = sgm_cuda.aggregate_8(C, p.P1, p.P2, 8, cost_bound=p.cost_bound)
    wta, _ = check_kernel("wta_stats", SOURCES["sgm"],
                          "stereo_vision_tpu/stereo/sgm_pallas.py:320 wta_stats_pallas:296 (_wta_kernel:265)",
                          lambda: sgm_cuda.wta_stats(S, p.uniqueness_ratio),
                          lambda: sgm_cuda.wta_scan(S, D, p.uniqueness_ratio), n * 4 + (n // D) * (5 * 4 + 1),
                          n * 10, 10, "two-stage", S.dtype)
    del S
    rows = [dict(agg[8], path="two-stage"), wta]

    counted = (sgm_cuda.aggregate_8, sgm_cuda.wta_stats)
    for fn in counted:
        fn.launches = 0
    sgm_cuda.vertical.device_launches = 0
    maps = sgm_cuda.wta_stats(sgm_cuda.aggregate_8(C, p.P1, p.P2, 8, cost_bound=p.cost_bound), p.uniqueness_ratio)
    torch.cuda.synchronize()
    counts = {"aggregate_8": counted[0].launches, "wta_stats": counted[1].launches}
    if sgm_cuda.vertical.device_launches != 1:
        raise AssertionError(f"aggregate_8 made {sgm_cuda.vertical.device_launches} device launches of the "
                             "vertical scan, not 1")
    print("two-stage reduce launches:", json.dumps(counts), flush=True)
    for row in rows:
        row["launches"] = counts[row["name"]]
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the two-stage reduce never launched: {counts}")
    fused = sgm_cuda.sgm_reduce(C, p.P1, p.P2, p.uniqueness_ratio, cost_bound=p.cost_bound)
    if not all(torch.equal(a, b) for a, b in zip(maps, fused)):
        raise AssertionError("the two-stage reduce differs from sgm_reduce")
    print("two-stage reduce (aggregate_8, wta_stats) == sgm_reduce", flush=True)
    return {"aggregate_8 (4 paths)": {k: agg[4][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}, rows


def check_bm_kernel(dev) -> dict:
    """The BM kernel against its plain form on one 640x480 frame: BASELINE
    config #1 (StereoBMParams(): D 64, block 15) and min_disparity 16."""
    out = {}
    for label, p in (("bm480", StereoBMParams()), ("bm480 min_disparity 16", StereoBMParams(min_disparity=16))):
        lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a)[None].to(dev), p.prefilter_cap)
                  for a in scene(seed=0, H=480, W=640))
        kw = dict(ndisp=p.num_disparities, mindisp=p.min_disparity, block_size=p.block_size, cap=p.prefilter_cap,
                  uniq=p.uniqueness_ratio, tex_thr=p.texture_threshold)
        npix = (480 - p.block_size + 1) * (640 - p.block_size + 1)
        form = bm_cuda.kernel_form(ndisp=p.num_disparities, mindisp=p.min_disparity, block_size=p.block_size,
                                   cap=p.prefilter_cap)
        if form != "packed16":
            raise AssertionError(f"{label} takes the {form} form of the BM kernel, not packed16")
        row, res = check_kernel("bm_disparity", SOURCES["bm"], KERNELS["bm_disparity"][2],
                                lambda: bm_cuda.bm_disparity(lp, rp, **kw),
                                lambda: bm.valid_disparity_plain(lp, rp, **kw), 2 * lp.numel() * 4 + npix * 4,
                                npix * p.num_disparities * 8, 10, label)
        out[label] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        out[label]["valid_share"] = float((res > p.min_disparity - 1).float().mean())
    return out


def phase_bm_small_pipeline(dev) -> None:
    h, w, b = 240, 320, 2
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(b)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    p = StereoBMParams()
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="bm", params=p, device=dev)
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="bm", params=p, device="cpu")
    if not torch.equal(d_gpu.cpu(), d_cpu):
        raise AssertionError("CUDA and CPU BM disparities differ at 240x320")
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
    print(f"bm pipeline 240x320 StereoBMParams() B=2: CUDA == CPU "
          f"(valid share {float((d_cpu > -1).float().mean()):.4f})", flush=True)


def phase_bm_main_path(dev, lt, rt) -> tuple[dict, dict, torch.Tensor]:
    maps, Q = rig(BM_H, BM_W)
    bm_cuda.bm_disparity.launches = 0
    bm_cuda.bm_disparity.launches_by_form = dict.fromkeys(bm_cuda.FORMS, 0)
    disp, pts = batched_stereo_pipeline(lt, rt, maps, Q, matcher="bm", params=BM_PARAMS, device=dev)
    torch.cuda.synchronize()
    counts = {"bm_disparity": bm_cuda.bm_disparity.launches}
    forms = bm_cuda.bm_disparity.launches_by_form
    print("bm1080 main path launches:", json.dumps(counts), "by form", json.dumps(forms), flush=True)
    if counts["bm_disparity"] != 1 or forms["packed16"] != 1:
        raise AssertionError(f"the BM main path did not launch the packed row form once: {counts}, {forms}")
    d = disp.cpu().numpy()
    if d.shape != (BM_B, BM_H, BM_W) or pts.shape != (BM_B, BM_H, BM_W, 3) or not np.isfinite(d).all():
        raise AssertionError(f"bad bm output: disparity {d.shape}, points {tuple(pts.shape)}")
    if not np.isfinite(pts[..., 2].cpu().numpy()[d > 0]).all():
        raise AssertionError("non-finite depth at a positive disparity")
    # Over the window centres that see the full disparity range.
    r = BM_PARAMS.block_size // 2
    valid_share, within1 = quality(d[:, r : BM_H - r], scene_truth(BM_H, BM_W)[r : BM_H - r],
                                   r + BM_PARAMS.min_disparity + BM_PARAMS.num_disparities - 1)
    print(f"bm1080 main path quality: valid share {valid_share:.4f} (floor {BM_VALID_FLOOR}), "
          f"within 1 px {within1:.4f} (floor {BM_WITHIN1_FLOOR})", flush=True)
    if valid_share < BM_VALID_FLOOR or within1 < BM_WITHIN1_FLOOR:
        raise AssertionError("bm1080 main path quality below its floor")
    ms = host_ms(lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="bm", params=BM_PARAMS, device=dev))
    px = BM_B * BM_H * BM_W
    print(f"bm1080 main path {BM_W}x{BM_H} D={BM_PARAMS.num_disparities} block {BM_PARAMS.block_size} B={BM_B}: "
          f"{ms:.2f} ms per call, {px / ms / 1e3:.2f} Mpx/s, {BM_B / ms * 1e3:.2f} frames/s", flush=True)
    return dict(ms_per_call=ms, frames_per_call=BM_B, mpx_per_s=px / ms / 1e3, frames_per_s=BM_B / ms * 1e3,
                valid_share=valid_share, within1_share=within1), counts, disp


def record_bm_call(dev, lt, rt, disp_main: torch.Tensor, keep: bool) -> tuple[dict, list[dict]]:
    """One BM main-path call with its stages recorded: CUDA-event ms of
    remap + round, prefilter (both views), the kernel, the paste (the
    matcher less the two) and reproject, and the kernel call's record."""
    maps, Q = rig(BM_H, BM_W)
    targets = {"matcher": (streaming, "stereo_bm"), "reproject": (streaming, "reproject_disparity_to_3d"),
               "prefilter": (bm, "prefilter_xsobel"), "bm_disparity": (bm_cuda, "bm_disparity")}
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with Recorder(targets, ("bm1080",), keep) as rec:
        start.record()
        disp, _ = batched_stereo_pipeline(lt, rt, maps, Q, matcher="bm", params=BM_PARAMS, device=dev)
        end.record()
    torch.cuda.synchronize()
    if not torch.equal(disp, disp_main):
        raise AssertionError("the recorded BM call differs from the main path")
    st = {"call": start.elapsed_time(end)}
    for c in rec.calls:
        st[c["name"]] = st.get(c["name"], 0.0) + c["start"].elapsed_time(c["end"])
    matcher = next(c for c in rec.calls if c["name"] == "matcher")
    st["remap + round (with the maps' upload)"] = start.elapsed_time(matcher["start"])
    st["paste (matcher less prefilter and kernel)"] = st["matcher"] - st["prefilter"] - st["bm_disparity"]
    return {k: round(v, 4) for k, v in st.items()}, [c for c in rec.calls if c["name"] == "bm_disparity"]


def phase_geometry(dev) -> dict:
    """stereo_rectify and init_undistort_rectify_map of the distorted
    1920x1080 rig (float64, alpha -1 and 0) on the card and on the CPU:
    R1/R2/P1/P2/Q within rtol 1e-9, the float32 maps within 1e-3 px; then
    ``GEOMETRY_MATCHES`` synthetic matches triangulated on both, rtol 1e-9."""
    cpu = [torch.tensor(a, dtype=torch.float64) for a in (RIG_K1, RIG_D1, RIG_K2, RIG_D2, RIG_T)]
    R = ops.rodrigues(torch.tensor(RIG_RVEC, dtype=torch.float64))
    out = {}
    for alpha in (-1.0, 0.0):
        ref = ops.stereo_rectify(*cpu[:4], RIG_SIZE, R, cpu[4], alpha=alpha)
        res = ops.stereo_rectify(*(a.to(dev) for a in cpu[:4]), RIG_SIZE, R.to(dev), cpu[4].to(dev), alpha=alpha)
        for name, a, b in zip(ref._fields, res, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-9, msg=f"stereo_rectify {name}")
        err = 0.0
        for K, dist, Rk, Pk in ((cpu[0], cpu[1], ref.R1, ref.P1), (cpu[2], cpu[3], ref.R2, ref.P2)):
            maps = ops.init_undistort_rectify_map(K.to(dev), dist.to(dev), Rk.to(dev), Pk.to(dev), RIG_SIZE)
            for a, b in zip(maps, ops.init_undistort_rectify_map(K, dist, Rk, Pk, RIG_SIZE)):
                if a.dtype != torch.float32 or a.shape != (RIG_SIZE[1], RIG_SIZE[0]):
                    raise AssertionError(f"bad map {a.dtype} {tuple(a.shape)}")
                err = max(err, float((a.cpu() - b).abs().max()))
        if err > 1e-3:
            raise AssertionError(f"rectification maps differ by {err} px between the card and the CPU")
        out[f"maps alpha {alpha} max px err"] = err
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform([-800, -500, 1800], [800, 500, 4000], (GEOMETRY_MATCHES, 3)))
    p1, p2 = (ops.project_homogeneous(P, X) + torch.from_numpy(rng.normal(0, 0.3, (GEOMETRY_MATCHES, 2)))
              for P in (ref.P1, ref.P2))
    Xc = ops.triangulate_points(ref.P1, ref.P2, p1, p2)
    Xg = ops.triangulate_points(ref.P1.to(dev), ref.P2.to(dev), p1.to(dev), p2.to(dev))
    torch.testing.assert_close(Xg.cpu(), Xc, rtol=1e-9, atol=1e-9, msg="triangulate_points")
    out["triangulation max mm err vs truth"] = float((Xc - X).abs().max())
    print(f"geometry 1920x1080 rig: card == CPU (rtol 1e-9; maps {out}); {GEOMETRY_MATCHES} matches triangulated",
          flush=True)
    return out


def parallel_rig(h: int, w: int, dev):
    """Maps and Q of an undistorted parallel rig (K1 = K2, f = 1000 px, zero
    distortion, R = I, a 0.1 m baseline along x) through stereo_rectify and
    init_undistort_rectify_map on the card, as the stream command builds
    its maps: the rectification is the identity up to rounding, so the
    scene's true disparity survives. The maps stay on the card."""
    K = torch.tensor([[1000.0, 0, (w - 1) / 2], [0, 1000.0, (h - 1) / 2], [0, 0, 1]], dtype=torch.float64)
    zero = torch.zeros(5, dtype=torch.float64)
    eye = torch.eye(3, dtype=torch.float64)
    res = ops.stereo_rectify(K, zero, K, zero, (w, h), eye, torch.tensor([-0.1, 0.0, 0.0], dtype=torch.float64),
                             device=dev)
    if res.Q.device.type != torch.device(dev).type:
        raise AssertionError("stereo_rectify left the card")
    maps = (*ops.init_undistort_rectify_map(K, zero, res.R1, res.P1, (w, h), device=dev),
            *ops.init_undistort_rectify_map(K, zero, res.R2, res.P2, (w, h), device=dev))
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    err = max(float((m - g).abs().max()) for m, g in zip(maps, (xx, yy, xx, yy)))
    if err > 1e-3:
        raise AssertionError(f"the parallel rig's maps are {err} px off the identity")
    return maps, res.Q.to(torch.float32)


def phase_hier16(dev) -> tuple[dict, list[dict]]:
    """The hier16x3 main path (bench.py's hier16x3: 8 frames, HIER_FAST
    picked by batch size, p3) with the parallel rig's maps: unfused, then
    with ``hier._FUSED_STATS`` set (the fused WTA #19 at the full level).
    Each: launch counts (fused: banded_wta_fused 1, banded_wta 1 for the
    coarse level only), floors, ms per call; a recorded breakdown and every
    kernel on a recorded call's arguments, 8 frames against the plain form
    on ``PLAIN_FRAMES``. The two forms' disparities must be equal; then ms
    per call in turns (unfused, fused, fused, unfused; 5 calls each). The
    flag is restored."""
    maps_q = parallel_rig(H, W, dev)
    frames = [scene(seed=s) for s in range(H16_P)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    levels = ("coarse", "full")
    out, rows = {}, []
    prev = hier._FUSED_STATS
    try:
        hier._FUSED_STATS = False
        out["unfused"], counts, disp = phase_hier_main_path(dev, lt, rt, P3, "hier16x3", maps_q)
        out["unfused breakdown"], _ = record_hier_call(dev, lt, rt, disp, False, P3, maps_q, levels)
        print(f"hier16x3 breakdown ms per {H16_P}-frame call:", json.dumps(out["unfused breakdown"]), flush=True)
        _, records = record_hier_call(dev, lt, rt, disp, True, P3, maps_q, levels)
        rows += phase_recorded_kernels(records, counts, PLAIN_FRAMES, "hier16x3")
        del records
        torch.cuda.empty_cache()

        hier._FUSED_STATS = True
        out["fused"], counts, disp_f = phase_hier_main_path(dev, lt, rt, P3, "hier16x3 fused", maps_q,
                                                             RECORDED_HIER_KERNELS)
        if counts["banded_wta_fused"] != 1 or counts["banded_wta"] != 1:
            raise AssertionError(f"the fused hier16x3 call did not take the fused WTA at its full level: {counts}")
        if not torch.equal(disp_f, disp):
            raise AssertionError("the fused hier16x3 disparity differs from the unfused one")
        out["fused breakdown"], _ = record_hier_call(dev, lt, rt, disp, False, P3, maps_q, levels)
        print(f"hier16x3 fused breakdown ms per {H16_P}-frame call:", json.dumps(out["fused breakdown"]), flush=True)
        _, records = record_hier_call(dev, lt, rt, disp, True, P3, maps_q, levels)
        rows += phase_recorded_kernels([c for c in records if c["name"] == "banded_wta_fused"], counts,
                                       PLAIN_FRAMES, "hier16x3 fused")
        del records, disp_f
        torch.cuda.empty_cache()

        run = lambda: batched_stereo_pipeline(lt, rt, *maps_q, matcher="sgbm_hier", params=P3, device=dev)
        timings = {"unfused": [], "fused": []}
        for fused in (False, True, True, False):
            hier._FUSED_STATS = fused
            timings["fused" if fused else "unfused"].append(host_ms(run, reps=5))
    finally:
        hier._FUSED_STATS = prev
    out["turns"] = {**{k: sum(v) / len(v) for k, v in timings.items()}, "runs": timings}
    print(f"hier16x3 ms per {H16_P}-frame call in turns: unfused {timings['unfused']}, fused {timings['fused']}",
          flush=True)
    return out, rows


def phase_hier_per_frame(dev) -> None:
    """The per-frame stereo_sgbm_hier on the card against the CPU at 64x256
    (HIER_FAST, HIER4_FAST, HIER_FAST at coarse_stride 2 with a coarse LR
    check), exact; then the strided banded cost kernel at the hier16x3
    coarse level's shape (8 x 180x320, 16 lanes, stride 2) against its plain
    form on 2 frames, exact."""
    left, right = (torch.from_numpy(a) for a in scene(seed=1, H=64, W=256))
    for label, hp in (("HIER_FAST", hier.HIER_FAST), ("HIER4_FAST", hier.HIER4_FAST),
                      ("HIER_FAST coarse_stride 2", hier.HIER_FAST._replace(coarse_stride=2, coarse_lr=1))):
        ref = hier.stereo_sgbm_hier(left, right, P3, hp)
        got = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), P3, hp)
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"per-frame stereo_sgbm_hier ({label}) differs between the card and the CPU")
        print(f"per-frame stereo_sgbm_hier 64x256 {label}: CUDA == CPU (valid share "
              f"{float((ref > -1).float().mean()):.4f})", flush=True)
    frames = [scene(seed=s) for s in range(H16_P)]
    lc, rc = (banded_cuda.downsample_box(torch.from_numpy(np.stack([f[i] for f in frames])).to(dev).to(torch.int32),
                                         4) for i in (0, 1))
    s0 = torch.zeros_like(lc)
    kw = dict(band=16, G=8, ndisp=D // 4, ftzero=P3.ftzero, block_size=P3.block_size, min_x=D // 4, stride=2)
    err = max_abs_err(_head(banded_cuda.banded_cost(lc, rc, s0, **kw), 2),
                      banded_cuda.banded_cost_plain(lc[:2], rc[:2], s0[:2], **kw))
    if err != 0:
        raise AssertionError(f"the strided banded cost kernel differs from its plain form (max abs err {err})")
    print(f"kernel banded_cost stride 2 ({H16_P}x{lc.shape[1]}x{lc.shape[2]}, K=16): exact", flush=True)


def phase_horizontal_bands(dev) -> dict:
    """The banded horizontal scan (#18) on per-pixel random shift maps at
    every band it takes (K = 4, 8, ..., 64; G varying with K), int16 and
    int32, both directions, against its plain form on the card, exact. Rows
    that leave a warp's last groups empty and columns that leave the last
    prefetched chunk short are in the shape. Then ms and bounds at the full
    level's shape (720 rows x 1152 columns, a shift map constant on 4-px
    tiles): K=16 int16 and int32 at hier16x3's 8 frames and int16 on 1
    frame, K=4 at hier4x3's 32 frames and on 4 (how the time grows with the
    rows)."""
    P, h, Wv = 2, 9, 203
    P1, P2 = P3.P1, P3.P2
    for K in range(4, 65, 4):
        G = K // 2 if (K // 4) % 2 else K // 4
        rng = np.random.default_rng(K)
        s = rng.integers(0, 6, (P, h, Wv)) * G + (rng.random((P, h, Wv)) < 0.1) * rng.integers(1, 3, (P, h, Wv))
        s = torch.from_numpy(s.astype(np.int32)).to(dev)
        for dtype, bound in ((torch.int16, 2325), (torch.int32, 40000)):
            C = torch.from_numpy(rng.integers(0, bound + 1, (P, h, Wv, K))).to(dtype).to(dev)
            for rev in (False, True):
                out = banded_cuda.banded_horizontal(C, s, G, P1, P2, cost_bound=bound, reverse=rev)
                err = max_abs_err(out, banded_cuda.horizontal_plain(C, s, G, P1, P2, rev))
                if out.dtype != dtype or err != 0:
                    raise AssertionError(f"banded_horizontal K={K} G={G} {dtype} reverse={rev}: {out.dtype}, "
                                         f"max abs err {err}")
    print(f"kernel banded_horizontal K=4..64, int16 and int32, both directions, {P}x{h}x{Wv}, per-pixel random "
          "shifts: exact", flush=True)
    out = {}
    Wf = W - D
    for K, G, dtype, frames in ((16, 8, torch.int16, H16_P), (16, 8, torch.int32, H16_P), (16, 8, torch.int16, 1),
                                (4, 2, torch.int16, HIER_P), (4, 2, torch.int16, 4)):
        rng = np.random.default_rng(K)
        tiles = rng.integers(0, (D - K) // G + 1, (frames, H // 4, Wf // 4)) * G
        s = torch.from_numpy(np.repeat(np.repeat(tiles, 4, 1), 4, 2).astype(np.int32)).to(dev)
        bound = P3.cost_bound if dtype == torch.int16 else 40000
        C = torch.randint(0, bound + 1, (frames, H, Wf, K), device=dev, dtype=torch.int32).to(dtype)
        ms = event_ms(lambda: banded_cuda.banded_horizontal(C, s, G, P1, P2, cost_bound=bound), 10)
        b_ms, b_by = bound_ms(2 * C.numel() * C.element_size() + s.numel() * 4, C.numel() * 10)
        out[f"K={K} {str(dtype).removeprefix('torch.')} {frames} frames"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
        del C, s
    print(f"banded_horizontal at {H} rows x {Wf} columns, 4-px tiles: {json.dumps(out)}", flush=True)
    return out


def phase_settings(dev) -> dict:
    """Settings the card once refused, CUDA against CPU, exact: the exact
    pipeline at 240x320, D=64, 2 frames at block 11 with 8 paths (whose
    direction sums leave int16) and at min_disparity -8 (no LR check: the
    reference asserts min_disparity >= 0 there), points within float32
    rtol 1e-6; then the per-frame stereo_sgbm_hier at band 12 (64x256)."""
    h, w, b = 240, 320, 2
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(b)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    out = {}
    cases = {"block 11, 8 paths": PARAMS._replace(num_disparities=64, block_size=11),
             "min_disparity -8": PARAMS._replace(num_disparities=64, min_disparity=-8, disp12_max_diff=-1)}
    for label, p in cases.items():
        storage = sgm_cuda.storage_dtype(p.cost_bound, p.P2, 3)
        n = cost_cuda.cost_volume.launches
        d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device=dev)
        d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
        if cost_cuda.cost_volume.launches != n + 1 or not torch.equal(d_gpu.cpu(), d_cpu):
            raise AssertionError(f"CUDA and CPU disparities differ at 240x320 ({label})")
        torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
        valid = float((d_cpu > p.min_disparity - 1).float().mean())
        out[label] = dict(storage=str(storage).removeprefix("torch."), valid_share=valid)
        print(f"pipeline 240x320 D=64 B=2, {label}: CUDA == CPU ({storage}, valid share {valid:.4f})", flush=True)
    if out["block 11, 8 paths"]["storage"] != "int32":
        raise AssertionError("block 11 at 8 paths did not take the int32 kernels")
    left, right = (torch.from_numpy(a) for a in scene(seed=1, H=64, W=256))
    hp = hier.HierParams(band=12, granularity=4)
    ref = hier.stereo_sgbm_hier(left, right, P3, hp)
    n = banded_cuda.banded_horizontal.launches
    got = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), P3, hp)
    if banded_cuda.banded_horizontal.launches == n or not torch.equal(got.cpu(), ref):
        raise AssertionError("per-frame stereo_sgbm_hier at band 12 differs between the card and the CPU")
    out["hier band 12 valid share"] = float((ref > -1).float().mean())
    print(f"per-frame stereo_sgbm_hier 64x256 band 12: CUDA == CPU (valid share "
          f"{out['hier band 12 valid share']:.4f})", flush=True)
    out.update(settings_repaired(dev))
    return out


def settings_repaired(dev) -> dict:
    """The settings ROADMAP C.1-C.4 and C.7 logged (the reference computes
    them; the card once refused them), card against CPU, exact: a frame no
    wider than its range (stereo_sgbm, no kernel launched; the per-frame and
    batched hier at 32x64, D=64); BM on frames smaller than the block (no
    kernel launched); even blocks 4 and 6 through both cost kernels against
    their plain forms and through stereo_sgbm and the per-frame hier;
    hier_params with matcher="sgbm" and "bm" ignored; the per-frame
    stereo_sgbm_hier with 1, 2 and 3 coarse lanes (and a refusal where the
    reference raises, before any launch)."""
    out = {}
    rng = np.random.default_rng(0)
    for h, w, d, md in ((8, 16, 16, 0), (8, 12, 16, 0), (8, 16, 8, 8)):
        l, r = (torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32)) for _ in range(2))
        p = StereoSGBMParams(num_disparities=d, min_disparity=md, block_size=3)
        n = cost_cuda.cost_volume.launches
        got = stereo_sgbm(l.to(dev), r.to(dev), p)
        if cost_cuda.cost_volume.launches != n or not torch.equal(got.cpu(), stereo_sgbm(l, r, p)):
            raise AssertionError(f"stereo_sgbm at {h}x{w}, D={d}, min_disparity {md}: card != CPU or a kernel ran")
    hp = hier.HierParams(band=16, granularity=8, tile=1, local_window=1)
    frames = [scene(seed=s, H=32, W=64, box_disp=20) for s in range(8)]
    L, R = (torch.from_numpy(np.stack([f[i] for f in frames]).astype(np.int32)) for i in (0, 1))
    p = P3._replace(num_disparities=64)
    if not torch.equal(hier.stereo_sgbm_hier(L[0].to(dev), R[0].to(dev), p, hp).cpu(),
                       hier.stereo_sgbm_hier(L[0], R[0], p, hp)):
        raise AssertionError("per-frame stereo_sgbm_hier at 32x64, D=64: card != CPU")
    if not torch.equal(hier.stereo_sgbm_hier_batch(L.to(dev), R.to(dev), p, hp).cpu(),
                       hier.stereo_sgbm_hier_batch(L, R, p, hp)):
        raise AssertionError("stereo_sgbm_hier_batch at 8 x 32x64, D=64: card != CPU")
    out["no wider than the range"] = "card == CPU"
    for h, w in ((4, 20), (20, 4)):
        l, r = (torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32)) for _ in range(2))
        p = StereoBMParams(num_disparities=8, block_size=5)
        n = bm_cuda.bm_disparity.launches
        got = bm.stereo_bm(l.to(dev), r.to(dev), p)
        if bm_cuda.bm_disparity.launches != n or not torch.equal(got.cpu(), bm.stereo_bm(l, r, p)):
            raise AssertionError(f"stereo_bm at {h}x{w}, block 5: card != CPU or a kernel ran")
    out["BM smaller than the block"] = "card == CPU"
    l, r = (torch.from_numpy(a.astype(np.int32)) for a in scene(seed=2, H=48, W=256))
    for bs in (4, 6):
        for d, md, xo, dtype in ((64, 0, 64, torch.int16), (200, 3, 0, torch.int32)):
            kw = dict(ndisp=d, mindisp=md, block_size=bs, x_offset=xo)
            ref = cost_cuda.cost_volume_plain(l[None], r[None], **kw).to(torch.int32)
            if not torch.equal(cost_cuda.cost_volume(l[None].to(dev), r[None].to(dev), dtype=dtype, **kw).cpu()
                               .to(torch.int32), ref):
                raise AssertionError(f"cost kernel at block {bs}, D={d}: differs from its plain form")
        for K, G, dtype in ((4, 2, torch.int16), (16, 8, torch.int32)):
            sh = torch.from_numpy((rng.integers(0, (64 - K) // G + 1, (1, 48, 256)) * G).astype(np.int32))
            kw = dict(band=K, G=G, ndisp=64, block_size=bs, min_x=64, dtype=dtype)
            if not torch.equal(banded_cuda.banded_cost(l[None].to(dev), r[None].to(dev), sh.to(dev), **kw).cpu(),
                               banded_cuda.banded_cost_plain(l[None], r[None], sh, ftzero=15, **kw)):
                raise AssertionError(f"banded cost kernel at block {bs}, K={K}: differs from its plain form")
        p = PARAMS._replace(num_disparities=64, block_size=bs)
        if not torch.equal(stereo_sgbm(l.to(dev), r.to(dev), p).cpu(), stereo_sgbm(l, r, p)):
            raise AssertionError(f"stereo_sgbm at block {bs}: card != CPU")
        p = P3._replace(num_disparities=64, block_size=bs)
        if not torch.equal(hier.stereo_sgbm_hier(l.to(dev), r.to(dev), p, hp).cpu(),
                           hier.stereo_sgbm_hier(l, r, p, hp)):
            raise AssertionError(f"per-frame stereo_sgbm_hier at block {bs}: card != CPU")
    out["even blocks 4 and 6"] = "kernels == plain, card == CPU"
    maps, Q = rig(48, 256)
    lb, rb = (np.stack([scene(seed=s, H=48, W=256)[i] for s in range(2)]) for i in (0, 1))
    for matcher, p in (("sgbm", PARAMS._replace(num_disparities=64)), ("bm", StereoBMParams(num_disparities=64))):
        d0, _ = batched_stereo_pipeline(lb, rb, maps, Q, matcher=matcher, params=p, device=dev)
        d1, _ = batched_stereo_pipeline(lb, rb, maps, Q, matcher=matcher, params=p, hier_params=hier.HIER_FAST,
                                        device=dev)
        if not torch.equal(d0, d1):
            raise AssertionError(f"matcher={matcher!r} does not ignore hier_params")
    out["hier_params with sgbm and bm"] = "ignored"
    # C.7: the per-frame strided coarse search at Kc = 1, 2, 3 lanes, and the
    # refusal where the reference raises (Kc = 5 and 6 at G = 8).
    rng = np.random.default_rng(0)
    for d, stride, w in ((64, 16, 128), (64, 8, 128), (192, 16, 256)):
        l = torch.from_numpy(rng.integers(0, 256, (16, w)).astype(np.int32))
        r = torch.roll(l, -8 if d == 64 else -40, 1)
        p, hp = StereoSGBMParams(num_disparities=d, block_size=3), hier.HierParams(band=16, granularity=8,
                                                                                  coarse_stride=stride)
        n = banded_cuda.banded_wta.launches
        got = hier.stereo_sgbm_hier(l.to(dev), r.to(dev), p, hp)
        if banded_cuda.banded_wta.launches != n + 2 or not torch.equal(got.cpu(), hier.stereo_sgbm_hier(l, r, p, hp)):
            raise AssertionError(f"per-frame stereo_sgbm_hier at D={d}, coarse_stride {stride}: card != CPU")
    for d, stride in ((64, 3), (192, 8)):
        n = banded_cuda.downsample_pyramid.launches
        try:
            hier.stereo_sgbm_hier(l.to(dev), r.to(dev), StereoSGBMParams(num_disparities=d, block_size=3),
                                  hier.HierParams(band=16, granularity=8, coarse_stride=stride))
        except ValueError as e:
            if "lanes at granularity 8" not in str(e) or banded_cuda.downsample_pyramid.launches != n:
                raise
        else:
            raise AssertionError(f"per-frame stereo_sgbm_hier at D={d}, coarse_stride {stride} did not refuse")
    out["C.7 coarse lanes 1-3"] = "card == CPU; Kc 5 and 6 refused"
    print(f"settings ROADMAP C.1-C.4, C.7: {json.dumps(out)}", flush=True)
    return out


# The banded cost kernel (#13 with #15/#16) at the five level shapes of the
# main paths: label, frames, rows, columns, band, G, ndisp (= min_x).
COST_LEVELS = (("hier4x3 coarse", HIER_P, H // 4, W // 4, 32, 2, D // 4),
               ("hier4x3 mid", HIER_P, H // 2, W // 2, 8, 4, D // 2),
               ("hier4x3 full", HIER_P, H, W, 4, 2, D),
               ("hier16x3 full", H16_P, H, W, 16, 8, D),
               ("hier16x3 coarse", H16_P, H // 4, W // 4, 32, 8, D // 4))
COST_PLAIN_FRAMES = 2  # frames the plain form runs on beside the kernel's call
WIDE_BANDS = ((68, 4), (128, 8), (256, 16))  # (K, G) of the wide-band phase, D = 256


def cost_shift_map(rng, P: int, h: int, w: int, K: int, G: int, ndisp: int, stride: int = 1) -> np.ndarray:
    """Per-pixel random shifts in the band's range [0, ndisp - stride (K - 1)
    - 1]: on the G grid, 15% of them 1-2 off it (neighbour deltas 0, +-G,
    beyond G, off the grid), the top and bottom rows at the range's top and
    the first and last columns at 0. At a coarse level (K == ndisp) the
    range is s == 0."""
    top = max(ndisp - stride * (K - 1) - 1, 0)
    s = rng.integers(0, top // G + 1, (P, h, w)) * G + (rng.random((P, h, w)) < 0.15) * rng.integers(1, 3, (P, h, w))
    s[:, 0, :] = s[:, -1, :] = top
    s[:, :, 0] = s[:, :, -1] = 0
    return np.minimum(s, top).astype(np.int32)


def phase_banded_cost(dev) -> dict:
    """The banded cost kernel at the five level shapes of the main paths
    (hier4x3: coarse K=32 at s = 0, mid K=8 G=4, full K=4 G=2, 32 frames;
    hier16x3: full K=16 G=8 and coarse K=32, 8 frames) on the scene's frames
    (box-downsampled for the coarse and mid levels) and per-pixel random
    shift maps (:func:`cost_shift_map`): the kernel on every frame against
    its plain form on the first 2, exact; then CUDA-event ms over 5 runs
    and the bound (the int32 images and shift map read once, the int16
    volume written once; ~20 + 4 bs operations a lane)."""
    lt, rt = hier_frames(dev)
    lt, rt = lt.to(torch.int32), rt.to(torch.int32)
    out = {}
    for label, P, h, w, K, G, ndisp in COST_LEVELS:
        f = H // h
        l, r = ((x[:P] if f == 1 else banded_cuda.downsample_box(x[:P], f)).contiguous() for x in (lt, rt))
        s = torch.from_numpy(cost_shift_map(np.random.default_rng(K + G), P, h, w, K, G, ndisp)).to(dev)
        kw = dict(band=K, G=G, ndisp=ndisp, ftzero=P3.ftzero, block_size=P3.block_size, min_x=ndisp)
        got = banded_cuda.banded_cost(l, r, s, **kw)
        n = COST_PLAIN_FRAMES
        err = max_abs_err(got[:n], banded_cuda.banded_cost_plain(l[:n], r[:n], s[:n], **kw))
        if err != 0 or got.dtype != torch.int16:
            raise AssertionError(f"banded_cost at {label}: {got.dtype}, max abs err {err} against its plain form")
        ms = event_ms(lambda: banded_cuda.banded_cost(l, r, s, **kw), 5)
        b_ms, b_by = bound_ms(3 * l.numel() * 4 + got.numel() * 2, got.numel() * (20 + 4 * P3.block_size))
        out[label] = dict(frames=P, ms=ms, bound_ms=b_ms, bound_by=b_by)
        print(f"kernel banded_cost {label} ({P}x{h}x{w}, K={K}, G={G}), random shifts: exact on {n} frames, "
              f"{ms:.3f} ms (bound {b_ms:.4f} ms by {b_by})", flush=True)
        del l, r, s, got
    return out


def phase_wide_bands(dev) -> dict:
    """Bands above 64 (K = 68, 128, 256; D = 256), int16 and int32, against
    their plain forms on the card, exact: the cost kernel (block 5, stride
    1 and 2), the vertical scan with and without diagonals (carry rows in
    shared memory at 45 columns, in device scratch at 300), the horizontal
    scan in both directions and the WTA in its 6-stat and sub forms, on
    per-pixel random shift maps; then the per-frame stereo_sgbm_hier at
    band 128, D=256 on a 32x320 pair, card against CPU."""
    ndisp, P1, P2 = 256, P3.P1, P3.P2
    out = {}
    for K, G in WIDE_BANDS:
        rng = np.random.default_rng(K)
        for dtype, bound in ((torch.int16, 2325), (torch.int32, 40000)):
            name = str(dtype).removeprefix("torch.")
            l, r = (torch.from_numpy(rng.integers(0, 256, (2, 37, ndisp + 90)).astype(np.int32)).to(dev)
                    for _ in range(2))
            for stride in (1, 2):
                s = torch.from_numpy(cost_shift_map(rng, 2, 37, ndisp + 90, K, G, ndisp, stride)).to(dev)
                kw = dict(band=K, G=G, ndisp=ndisp, ftzero=P3.ftzero, block_size=P3.block_size, min_x=3,
                          stride=stride, dtype=dtype)
                got = banded_cuda.banded_cost(l, r, s, **kw)
                err = max_abs_err(got, banded_cuda.banded_cost_plain(l, r, s, **kw))
                if err != 0 or got.dtype != dtype:
                    raise AssertionError(f"banded_cost K={K} {name} stride {stride}: max abs err {err}")
            for Wv in (45, 300):
                C = torch.from_numpy(rng.integers(0, bound + 1, (2, 11, Wv, K))).to(dtype).to(dev)
                sv = torch.from_numpy(rng.integers(0, 6, (2, 11, Wv)) * G
                                      + (rng.random((2, 11, Wv)) < 0.1) * rng.integers(1, 3, (2, 11, Wv)))
                sv = sv.to(torch.int32).to(dev)
                for diag in (False, True):
                    got = banded_cuda.banded_vertical(C, sv, G, P1, P2, cost_bound=bound, with_diagonals=diag)
                    err = max_abs_err(got, banded_cuda.vertical_plain(C, sv, G, P1, P2, diag))
                    if err != 0 or got[0].dtype != dtype:
                        raise AssertionError(f"banded_vertical K={K} {name} Wv={Wv} diagonals={diag}: {err}")
                for rev in (False, True):
                    got = banded_cuda.banded_horizontal(C, sv, G, P1, P2, cost_bound=bound, reverse=rev)
                    err = max_abs_err(got, banded_cuda.horizontal_plain(C, sv, G, P1, P2, rev))
                    if err != 0 or got.dtype != dtype:
                        raise AssertionError(f"banded_horizontal K={K} {name} Wv={Wv} reverse={rev}: {err}")
                vols = [torch.from_numpy(rng.integers(0, 9000, (2, 11, Wv, K))).to(dtype).to(dev) for _ in range(3)]
                for sub in (False, True):
                    err = max_abs_err(banded_cuda.banded_wta(vols, P3.uniqueness_ratio, sub),
                                      banded_cuda.banded_wta_plain(vols, P3.uniqueness_ratio, sub))
                    if err != 0:
                        raise AssertionError(f"banded_wta K={K} {name} Wv={Wv} sub={sub}: max abs err {err}")
            out[f"K={K} {name}"] = "exact"
            print(f"wide band K={K} G={G} {name}: cost (stride 1, 2), vertical (with and without diagonals, 45 and "
                  "300 columns), horizontal (both directions), WTA (6-stat, sub): exact", flush=True)
    p = P3._replace(num_disparities=ndisp)
    hp = hier.HierParams(band=128, granularity=8)
    left, right = (torch.from_numpy(a) for a in scene(seed=6, H=32, W=320))
    ref = hier.stereo_sgbm_hier(left, right, p, hp)
    n = banded_cuda.banded_wta.launches
    got = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp)
    if banded_cuda.banded_wta.launches == n or not torch.equal(got.cpu(), ref):
        raise AssertionError("per-frame stereo_sgbm_hier at band 128, D=256 differs between the card and the CPU")
    out["hier band 128 valid share"] = float((ref[:, ndisp:] > -1).float().mean())
    print(f"per-frame stereo_sgbm_hier 32x320 band 128 D=256: CUDA == CPU (valid share over x >= D "
          f"{out['hier band 128 valid share']:.4f})", flush=True)
    return out


def launch_ms(fn, calls: int = 3) -> dict | str:
    """Device ms a call of ``fn()`` by kernel name, from torch.profiler over
    ``calls`` calls; "not measured" where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    name = lambda key: key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    ms = {name(e.key): e.device_time_total / calls / 1e3 for e in prof.key_averages()
          if e.device_time_total > 0 and "::" in e.key}
    return ms or "not measured"


def phase_speckle(dev) -> dict:
    """The union-find speckle kernel (#12). On each main path's recorded
    arguments (``SPECKLE_RECORDS``; exact there against the plain form):
    device launches a call (the speckle kernels' nodes of a CUDA graph
    captured from the call, graph_kernels: 5, whatever R is), CUDA-event ms
    over 10 calls and the bound (one float32 map read, one written). Then 8 adversarial 720p frames (the 7
    maps of ``synth.scenes.speckle_patterns`` tiled over the frame, and random
    quantised blobs) at S = 100 uncapped and capped at 4 and 8, and S = 20
    capped at 2, against the plain form, exact, with ms."""
    out = {}
    for path, rec in SPECKLE_RECORDS.items():
        disp, kw = rec["args"][0], dict(zip(("max_diff", "max_speckle_size", "invalid_value"), rec["args"][1:]))
        kw.update(rec["kwargs"])
        launches = device_launches(lambda: speckle_cuda.speckle_filter(disp, **kw), "speckle_")
        if launches != 5:
            raise AssertionError(f"the speckle kernel made {launches} device launches on {path}'s arguments, not 5")
        ms = event_ms(lambda: speckle_cuda.speckle_filter(disp, **kw), 10)
        b_ms, b_by = bound_ms(2 * disp.numel() * 4, disp.numel() * 30)
        R = postprocess.speckle_rounds(kw.get("max_speckle_size", 100), kw.get("max_diameter"))
        out[path] = dict(frames=disp.shape[0], R=R, device_launches=launches, ms=ms, bound_ms=b_ms, bound_by=b_by,
                         ms_by_launch=launch_ms(lambda: speckle_cuda.speckle_filter(disp, **kw)))
        print(f"kernel speckle_filter ({path}, {tuple(disp.shape)}, R={R}): {launches} device launches a call, "
              f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}); by launch {json.dumps(out[path]['ms_by_launch'])}",
              flush=True)
    reps = np.tile(speckle_patterns(), (1, H // 72 + 1, W // 100 + 1))[:, :H, :W]
    rng = np.random.default_rng(12)
    blobs = rng.integers(0, 4, (1, H, W)).astype(np.float32) * 3
    blobs[rng.random(blobs.shape) < 0.2] = -1.0
    disp = torch.from_numpy(np.concatenate([reps, blobs])).to(dev)
    for S, cap in ((100, None), (100, 4), (100, 8), (20, 2)):
        kw = dict(max_diff=1.0, max_speckle_size=S, invalid_value=-1.0, max_diameter=cap)
        got, ref = speckle_cuda.speckle_filter(disp, **kw), speckle_cuda.speckle_filter_plain(disp, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        if err != 0:
            raise AssertionError(f"speckle_filter on adversarial 720p maps (S={S}, cap={cap}): max abs err {err}")
        ms = event_ms(lambda: speckle_cuda.speckle_filter(disp, **kw), 10)
        removed = float((ref != disp).float().mean())
        out[f"adversarial S={S} cap={cap}"] = dict(ms=ms, removed_share=removed)
        print(f"kernel speckle_filter adversarial {tuple(disp.shape)} S={S} cap={cap}: exact ({removed:.4f} of the "
              f"pixels removed), {ms:.4f} ms", flush=True)
    return out


def phase_wide_range(dev) -> dict:
    """Disparity ranges and bands above 256 (ROADMAP C.3), card against
    CPU, exact: stereo_sgbm at D = 320 on 48x480 (8 paths, LR and speckle
    on); the per-frame stereo_sgbm_hier at D = 512, band 320, G = 8 on
    32x640 (p3); the banded cost at band 256, G = 8, ndisp 256, block 21 on
    (1, 8, 300), where its rings take device scratch; BM at ndisp 320, 1024
    and 1040; band 1028 (ndisp 1040) through every banded kernel in int16
    and int32; then the exact8 pipeline at D = 512 on 240x640 (2 frames),
    at D = 1040 on 240x1280 with the LR check and at D = 2064 on 96x2304
    without it (1 frame each), its kernels' launch counts moved."""
    out = {}
    left, right = (torch.from_numpy(a) for a in scene(seed=2, H=48, W=480))
    p = PARAMS._replace(num_disparities=320)
    n = cost_cuda.cost_volume.launches
    got, ref = stereo_sgbm(left.to(dev), right.to(dev), p), stereo_sgbm(left, right, p)
    if cost_cuda.cost_volume.launches != n + 1 or not torch.equal(got.cpu(), ref):
        raise AssertionError("stereo_sgbm at D=320 differs between the card and the CPU")
    out["sgbm D=320 valid share"] = float((ref[:, 320:] > -1).float().mean())
    left, right = (torch.from_numpy(a) for a in scene(seed=3, H=32, W=640))
    p, hp = P3._replace(num_disparities=512), hier.HierParams(band=320, granularity=8)
    n = banded_cuda.banded_wta.launches
    got, ref = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp), hier.stereo_sgbm_hier(left, right, p, hp)
    if banded_cuda.banded_wta.launches == n or not torch.equal(got.cpu(), ref):
        raise AssertionError("per-frame stereo_sgbm_hier at D=512, band 320 differs between the card and the CPU")
    out["hier D=512 band 320 valid share"] = float((ref[:, 512:] > -1).float().mean())
    rng = np.random.default_rng(21)
    l, r = (torch.from_numpy(rng.integers(0, 256, (1, 8, 300)).astype(np.int32)) for _ in range(2))
    s = torch.zeros((1, 8, 300), dtype=torch.int32)
    kw = dict(band=256, G=8, ndisp=256, ftzero=15, block_size=21, min_x=0)
    err = max_abs_err(banded_cuda.banded_cost(l.to(dev), r.to(dev), s.to(dev), **kw).cpu(),
                      banded_cuda.banded_cost_plain(l, r, s, **kw))
    if err != 0:
        raise AssertionError(f"banded_cost at band 256, block 21 (device scratch): max abs err {err}")
    for nd in (320, 1024, 1040):
        base = rng.integers(0, 256, (2, 24, 2 * nd + 60))
        lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a.astype(np.int32)))
                  for a in (base[..., : nd + 60], base[..., nd - 40: 2 * nd + 20]))
        bkw = dict(ndisp=nd, mindisp=0, block_size=7, cap=31, uniq=15, tex_thr=10)
        got, ref = bm_cuda.bm_disparity(lp.to(dev), rp.to(dev), **bkw), bm_cuda.bm_disparity(lp, rp, **bkw)
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"bm_disparity at ndisp {nd} differs between the card and the CPU")
        out[f"bm ndisp={nd} valid share"] = float((ref > -1).float().mean())
    K, G, nd = 1028, 4, 1040
    P1, P2 = P3.P1, P3.P2
    for dtype, bound in ((torch.int16, 2325), (torch.int32, 40000)):
        name = str(dtype).removeprefix("torch.")
        l, r = (torch.from_numpy(rng.integers(0, 256, (2, 9, nd + 60)).astype(np.int32)).to(dev) for _ in range(2))
        s = torch.from_numpy(cost_shift_map(rng, 2, 9, nd + 60, K, G, nd, 1)).to(dev)
        kw = dict(band=K, G=G, ndisp=nd, ftzero=P3.ftzero, block_size=P3.block_size, min_x=40, dtype=dtype)
        err = max_abs_err(banded_cuda.banded_cost(l, r, s, **kw), banded_cuda.banded_cost_plain(l, r, s, **kw))
        C = torch.from_numpy(rng.integers(0, bound + 1, (2, 7, 45, K))).to(dtype).to(dev)
        sv = torch.from_numpy(rng.integers(0, 4, (2, 7, 45)) * G + (rng.random((2, 7, 45)) < 0.1)).to(torch.int32)
        sv = sv.to(dev)
        for diag in (False, True):
            err = max(err, max_abs_err(banded_cuda.banded_vertical(C, sv, G, P1, P2, cost_bound=bound,
                                                                   with_diagonals=diag),
                                       banded_cuda.vertical_plain(C, sv, G, P1, P2, diag)))
        for rev in (False, True):
            err = max(err, max_abs_err(banded_cuda.banded_horizontal(C, sv, G, P1, P2, cost_bound=bound, reverse=rev),
                                       banded_cuda.horizontal_plain(C, sv, G, P1, P2, rev)))
        vols = [torch.from_numpy(rng.integers(0, 9000, (2, 7, 45, K))).to(dtype).to(dev) for _ in range(3)]
        for sub in (False, True):
            err = max(err, max_abs_err(banded_cuda.banded_wta(vols, P3.uniqueness_ratio, sub),
                                       banded_cuda.banded_wta_plain(vols, P3.uniqueness_ratio, sub)))
        if err != 0:
            raise AssertionError(f"band {K} {name}: a banded kernel differs from its plain form (max abs err {err})")
        out[f"band {K} {name}"] = "exact"
    wrappers = {"cost": cost_cuda.cost_volume, "vertical": sgm_cuda.vertical, "horizontal": sgm_cuda.horizontal,
                "wta4": sgm_cuda.wta4, "lr_fail": lr_cuda.lr_fail, "speckle_filter": speckle_cuda.speckle_filter}
    for (h, w, b), p in (((240, 640, 2), PARAMS._replace(num_disparities=512)),
                         ((240, 1280, 1), PARAMS._replace(num_disparities=1040)),
                         ((96, 2304, 1), PARAMS._replace(num_disparities=2064, disp12_max_diff=-1))):
        maps, Q = rig(h, w)
        frames = [scene(seed=s, H=h, W=w) for s in range(b)]
        lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
        before = {k: fn.launches for k, fn in wrappers.items()}
        d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device=dev)
        counts = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
        if p.disp12_max_diff < 0:
            counts.pop("lr_fail")
        label = f"exact8 D={p.num_disparities} {h}x{w}{'' if p.disp12_max_diff >= 0 else ' (LR check off)'}"
        if min(counts.values()) == 0 or not torch.equal(d_gpu.cpu(), d_cpu):
            raise AssertionError(f"{label} differs between the card and the CPU ({counts})")
        torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
        valid = float((d_cpu[..., p.num_disparities:] > -1).float().mean())
        out[label] = dict(launches=counts, valid_share=valid)
        del d_gpu, p_gpu, d_cpu, p_cpu
    print(f"wide ranges, card == CPU: {json.dumps(out)}", flush=True)
    return out


# Phase 26: the BM row form's settings (the cuda tests'): (W, H, D, block,
# min_disparity, cap, uniqueness, texture, the form it takes) across the
# 16-bit packing bound (bs^2 * 2 cap < 2^16) and beside it.
BM_GRID = ((300, 40, 13, 31, 0, 31, 15, 10, "packed16"), (300, 40, 13, 33, 0, 31, 15, 10, "int32"),
           (200, 30, 22, 21, 0, 63, 15, 10, "packed16"), (200, 30, 22, 23, 0, 63, 15, 10, "int32"),
           (130, 12, 7, 5, 3, 31, 40, 60, "packed16"), (260, 9, 37, 5, -9, 31, 15, 10, "packed16"),
           (60, 7, 30, 7, 16, 31, 15, 10, "packed16"), (500, 5, 64, 5, 0, 31, 15, 10, "packed16"),
           (301, 11, 33, 3, -1, 31, 0, 0, "packed16"), (250, 9, 48, 9, -4, 150, 15, 10, "int32"),
           (400, 16, 128, 5, 0, 31, 15, 10, "packed16"))


def phase_bm_rows(dev, record: dict) -> dict:
    """The BM kernel (#11): five timed runs of 5 launches on the arguments the
    recorded bm1080 call gave it (the packed row form), then BM_GRID, each
    setting on random frames and on constant ones (every disparity ties), card
    against the plain form, with the form each took."""
    args, kwargs = record["args"], record["kwargs"]
    kern = lambda: bm_cuda.bm_disparity(*args, **kwargs)
    if not torch.equal(kern(), record["out"]):
        raise AssertionError("a second launch of the BM kernel differs from the bm1080 main path's")
    runs = [event_ms(kern, 5) for _ in range(5)]
    form = bm_cuda.kernel_form(ndisp=kwargs["ndisp"], mindisp=kwargs["mindisp"], block_size=kwargs["block_size"],
                               cap=kwargs["cap"])
    print(f"kernel bm_disparity (bm1080 recorded, {form}): runs {[round(r, 4) for r in runs]} ms", flush=True)
    t0 = time.perf_counter()
    cases = 0
    for W_, H_, D_, bs, md, cap, uniq, tex, want in BM_GRID:
        rng = np.random.default_rng(W_ + D_ + bs)
        base = rng.integers(0, 256, (2, H_, W_ + 40))
        left, right = base[..., 20: 20 + W_], base[..., 13: 13 + W_] + rng.integers(-3, 4, (2, H_, W_))
        lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a.astype(np.int32)), cap) for a in (left, right))
        flat = torch.full((1, H_, W_), cap, dtype=torch.int32)
        kw = dict(ndisp=D_, mindisp=md, block_size=bs, cap=cap, uniq=uniq, tex_thr=tex)
        got_form = bm_cuda.kernel_form(ndisp=D_, mindisp=md, block_size=bs, cap=cap)
        for lt, rt in ((lp, rp), (flat, flat)):
            n = bm_cuda.bm_disparity.launches_by_form[want]
            out = bm_cuda.bm_disparity(lt.to(dev), rt.to(dev), **kw)
            if (got_form != want or bm_cuda.bm_disparity.launches_by_form[want] != n + 1
                    or not torch.equal(out.cpu(), bm.valid_disparity_plain(lt, rt, **kw))):
                raise AssertionError(f"BM grid {W_}x{H_} D={D_} block {bs} min_disparity {md} cap {cap}: the "
                                     f"{got_form} form (want {want}) differs from the plain form")
            cases += 1
    print(f"kernel bm_disparity grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(form=form, runs_ms=runs, grid_cases=cases)


# Phase 27: the cluster vertical scan's settings (the cuda tests'): D at 1,
# 4, 8 and 32 values a lane, (B, H, W) from one column to 16 blocks of a
# cluster, int16 and int32, with and without diagonals.
VERTICAL_GRID_D = (16, 128, 200, 1000)
VERTICAL_GRID_SHAPES = ((1, 1, 1), (5, 2, 2), (1, 7, 37), (2, 9, 300), (1, 3, 1152))


def phase_vertical_cluster(dev, C: torch.Tensor) -> dict:
    """The vertical scan (#2) on the exact8 cost volume the recorded call
    made: its plan (cluster size, columns and warps a block, where the
    carries are, clusters resident), exact against its plain form on the
    first frame, one device launch a call, five timed runs of 5 calls; then
    the grid, card against plain."""
    p = PARAMS
    plan = sgm_cuda.vertical_plan(C)
    kern = lambda: sgm_cuda.vertical(C, p.P1, p.P2, True, p.cost_bound)
    n = sgm_cuda.vertical.device_launches
    got = kern()
    torch.cuda.synchronize()
    if sgm_cuda.vertical.device_launches != n + 1:
        raise AssertionError(f"the vertical scan made {sgm_cuda.vertical.device_launches - n} device launches")
    ref = sgm_cuda.vertical_plain(C[:1], p.P1, p.P2, True)
    if any(max_abs_err(a[:1], r) != 0 for a, r in zip(got, ref)):
        raise AssertionError("the cluster vertical scan differs from its plain form on exact8's cost volume")
    del got, ref
    runs = [event_ms(kern, 5) for _ in range(5)]
    print(f"kernel vertical (exact8 recorded): plan {json.dumps(plan)}, runs {[round(r, 4) for r in runs]} ms",
          flush=True)
    t0 = time.perf_counter()
    cases = 0
    for D_ in VERTICAL_GRID_D:
        for B_, H_, W_ in VERTICAL_GRID_SHAPES:
            for dtype in (torch.int16, torch.int32):
                rng = np.random.default_rng(D_ + W_ + H_)
                bound, (P1, P2) = (2325, (200, 800)) if dtype == torch.int16 else (40000, (8, 32000))
                Cc = torch.from_numpy(rng.integers(0, bound + 1, (B_, H_, W_, D_))).to(dtype)
                Cd = Cc.to(dev)
                for diag in (True, False):
                    n = sgm_cuda.vertical.device_launches
                    out = sgm_cuda.vertical(Cd, P1, P2, diag, bound)
                    ok = sgm_cuda.vertical.device_launches == n + 1 and all(
                        torch.equal(a.cpu().to(torch.int32), r)
                        for a, r in zip(out, sgm_cuda.vertical_plain(Cc, P1, P2, diag)))
                    if not ok:
                        raise AssertionError(f"vertical grid B={B_} H={H_} W={W_} D={D_} {dtype} diagonals={diag} "
                                             f"(plan {sgm_cuda.vertical_plan(Cd)}) differs from its plain form")
                    cases += 1
    print(f"kernel vertical grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(plan=plan, runs_ms=runs, grid_cases=cases)


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of libcuda's graph API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(fn) -> list[str]:
    """The (mangled) names of the kernels one call of ``fn()`` launches: the
    kernel nodes of a CUDA graph captured from the call (captured, not run),
    read through libcuda's graph API. Raises where a name cannot be read."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise AssertionError(f"{what} failed (CUresult {rc})")

    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams_v2")
        name, rc = ctypes.c_char_p(), -1
        if params.func:
            rc = cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func))
        for handle in (params.kern, params.func):  # a kernel launched by its library handle
            if rc != 0 and handle:
                rc = cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(handle))
        check(rc, "cuFuncGetName / cuKernelGetName")
        names.append(name.value.decode())
    g.reset()
    return names


def device_launches(fn, match: str) -> int:
    """Device launches of kernels whose name holds ``match`` in one call of
    ``fn()`` (:func:`graph_kernels`)."""
    return sum(match in k for k in graph_kernels(fn))


# Phase 28: the vertical scan's settings: bands, granularities, widths across
# warp, block and cluster edges, one row and more rows than a ring holds,
# both storage types, with and without diagonals.
VERTICAL_KERNEL_NAMES = {"ring": "banded_vertical_kernel", "group": "banded_line_kernel",
                         "cluster": "banded_diag_cluster_kernel", "strips": "banded_diag_strips_kernel"}
VERTICAL17_GRID = dict(K_G=((4, 2), (8, 4), (12, 4), (16, 8), (32, 8), (64, 16)), Wv=(1, 33, 1152, 4097),
                       H=(1, 17))


def phase_banded_vertical(dev) -> dict:
    """The banded vertical scan (#17), both forms, on the arguments each hier
    main path's recorded call gave it (hier4x3's three levels, hier16x3's
    two, hier4x8's full level with diagonals; ``VERTICAL_RECORDS``): its plan
    (``banded_cuda.vertical_plan``), exact against its plain form on the
    first frame, one device launch a call (graph_kernels), five timed runs
    of 5 calls (CUDA events) and the bound (the volume read, two written,
    the shift map read); then its grid, card against plain."""
    out = {}
    for path in VERTICAL_PATHS:
        for rec in VERTICAL_RECORDS.get(path, []):
            C, s, G, P1, P2 = rec["args"]
            kw = rec["kwargs"]
            diag = bool(kw.get("with_diagonals"))
            if diag != (path == "hier4x8" and rec["level"] == "full"):
                continue  # hier4x8's coarse and mid levels run the form hier4x3 times
            kern = lambda: banded_cuda.banded_vertical(C, s, G, P1, P2, **kw)
            got = kern()
            torch.cuda.synchronize()
            plan = dict(banded_cuda.banded_vertical.plan)
            ref = banded_cuda.vertical_plain(C[:1], s[:1], G, P1, P2, diag)
            if any(max_abs_err(a[:1], r) != 0 for a, r in zip(got, ref)):
                raise AssertionError(f"banded_vertical ({path} {rec['level']}) differs from its plain form")
            del got, ref
            launches = device_launches(kern, VERTICAL_KERNEL_NAMES[plan["form"]])
            if launches != 1 or plan["device_launches"] != 1:
                raise AssertionError(f"banded_vertical ({path} {rec['level']}) made {launches} device launches")
            runs = [event_ms(kern, 5) for _ in range(5)]
            b_ms, b_by = bound_ms(3 * C.numel() * C.element_size() + s.numel() * 4,
                                  (6 if diag else 2) * C.numel() * 10)
            key = f"{path} {rec['level']}"
            out[key] = dict(shape=list(C.shape), storage=str(C.dtype).removeprefix("torch."), plan=plan,
                            device_launches=launches, runs_ms=runs, ms=min(runs), bound_ms=b_ms, bound_by=b_by)
            print(f"kernel banded_vertical{'_diag' if diag else ''} ({key}, {tuple(C.shape)}): plan "
                  f"{json.dumps(plan)}, {launches} device launch(es), runs {[round(r, 4) for r in runs]} ms, "
                  f"bound {b_ms:.4f} ms by {b_by}", flush=True)
    for want in ("hier4x3 full", "hier4x3 mid", "hier4x3 coarse", "hier16x3 full", "hier16x3 coarse",
                 "hier4x8 full"):
        if want not in out:
            raise AssertionError(f"no recorded call of the vertical scan at {want}")
    t0 = time.perf_counter()
    cases = 0
    for K, G in VERTICAL17_GRID["K_G"]:
        for Wv in VERTICAL17_GRID["Wv"]:
            for H_ in VERTICAL17_GRID["H"]:
                for dtype in (torch.int16, torch.int32):
                    rng = np.random.default_rng(K + Wv + H_)
                    bound, P1, P2 = (2325, 200, 800) if dtype == torch.int16 else (40000, 8, 32000)
                    Cc = torch.from_numpy(rng.integers(0, bound + 1, (1, H_, Wv, K))).to(dtype)
                    tiles = rng.integers(0, 6, (1, -(-H_ // 4), -(-Wv // 4))) * G
                    sc = torch.from_numpy(np.repeat(np.repeat(tiles, 4, 1), 4, 2)[:, :H_, :Wv].astype(np.int32))
                    if H_ == 1:  # per-pixel random shifts, on the G grid and off it
                        sc = sc + torch.from_numpy((rng.random((1, 1, Wv)) < 0.1) * rng.integers(1, 3, (1, 1, Wv)))
                        sc = sc.to(torch.int32)
                    for diag in (False, True):
                        out_ = banded_cuda.banded_vertical(Cc.to(dev), sc.to(dev), G, P1, P2,
                                                           cost_bound=2325 if dtype == torch.int16 else 20000,
                                                           with_diagonals=diag)
                        ref = banded_cuda.vertical_plain(Cc, sc, G, P1, P2, diag)
                        if not all(torch.equal(a.cpu().to(torch.int32), r) for a, r in zip(out_, ref)):
                            raise AssertionError(f"banded_vertical grid K={K} G={G} Wv={Wv} H={H_} {dtype} "
                                                 f"diagonals={diag} (plan {banded_cuda.banded_vertical.plan}) differs "
                                                 "from its plain form")
                        cases += 1
    print(f"kernel banded_vertical grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    out["grid_cases"] = cases
    return out


# Phase 29: the WTA's (#20) and the packed LR check's (#10) settings: bands
# (1-3 lanes, off and on the powers of two, the group form above 32), storage
# types, 2-4 volumes, both forms, pixel counts about a warp's and a block's
# run; widths, ranges
# and row counts of the LR check (23,040 rows only where a call's plain form
# stays under a second: 30 M pixels at most, ranges to 128).
WTA_GRID_K = (1, 2, 3, 4, 8, 12, 16, 20, 32, 36, 64)
WTA_GRID_PIXELS = (1, 31, 32, 33, 255, 256, 257, 1007)  # a thread a pixel, 32 a warp, 256 a block at K <= 16
LR_GRID = dict(W=(17, 96, 1280, 4096, 20000), ndisp=(16, 128, 1024, 2047), rows=(1, 7, 23040), max_diff=(0, 1, 2))


def copy_ms(nbytes: int) -> float:
    """torch's copy of nbytes / 2 bytes into another buffer (nbytes moved):
    the least of five runs of 5 calls, CUDA events."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return min(event_ms(lambda: dst.copy_(src), 5) for _ in range(5))


def phase_wta_lr(dev) -> dict:
    """The banded WTA (#20) on the arguments each hier main path's recorded
    call gave it (hier4x3's three levels, hier16x3's two, hier4x8's full
    level) and the packed LR check (#10) on hier4x3's and hier16x3's: exact
    against the plain form (run on the card) on the first frame, one device
    launch a call (graph_kernels), five timed runs of 5 calls (CUDA events),
    the bound (every input read once, every output written once) and the
    time of torch's copy of as many bytes; then each kernel's grid, card
    against plain, exact."""
    out = {"banded_wta": {}, "lr_fail_packed": {}}
    for name, kern_name in (("banded_wta", "banded_wta_kernel"), ("lr_fail_packed", "lr_fail_kernel")):
        fn, plain = KERNELS[name][0], PLAIN[name]
        for key in WTA_LR_LEVELS[name]:
            rec = WTA_LR_RECORDS[name].get(key)
            if rec is None:
                raise AssertionError(f"no recorded call of {name} at {key}")
            args, kwargs = rec["args"], rec["kwargs"]
            kern = lambda: fn(*args, **kwargs)
            got = kern()
            ref = plain(*_head(args, 1), **_head(kwargs, 1))
            torch.cuda.synchronize()
            gots, refs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
            if len(gots) != len(refs) or any(not torch.equal(a[:1], r) for a, r in zip(gots, refs)):
                raise AssertionError(f"{name} ({key}) differs from its plain form")
            launches = device_launches(kern, kern_name)
            if launches != 1:
                raise AssertionError(f"{name} ({key}) made {launches} device launches")
            runs = [event_ms(kern, 5) for _ in range(5)]
            nbytes = _nbytes(args) + _nbytes(gots)
            b_ms, b_by = bound_ms(nbytes, _ops(name, args, kwargs, gots[0].numel()))
            c_ms = copy_ms(nbytes)
            shape = list((args[0][0] if name == "banded_wta" else args[0]).shape)
            out[name][key] = dict(shape=shape, device_launches=launches, runs_ms=runs, ms=min(runs), bound_ms=b_ms,
                                  bound_by=b_by, copy_ms=c_ms, bytes=nbytes)
            print(f"kernel {name} ({key}, {tuple(shape)}): exact, {launches} device launch(es), runs "
                  f"{[round(r, 4) for r in runs]} ms, bound {b_ms:.4f} ms by {b_by}, copy {c_ms:.4f} ms", flush=True)
            del got, ref, gots, refs
    t0 = time.perf_counter()
    cases = 0
    for K in WTA_GRID_K:
        for dtype in (torch.int16, torch.int32):
            rng = np.random.default_rng(K)
            modes = WTA_MODES if dtype == torch.int32 else WTA_MODES[:-1]
            for nvol in (2, 3, 4):
                for n in WTA_GRID_PIXELS:
                    for mode in modes:
                        vols = [torch.from_numpy(v).to(dtype).to(dev) for v in wta_volumes(
                            rng, (1, 1, n, K), mode, nvol, np.int32 if mode == "near_bound" else np.int16)]
                        for sub in (False, True):
                            got = banded_cuda.banded_wta(vols, 10, sub)
                            ref = banded_cuda.banded_wta_plain(vols, 10, sub)
                            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                                raise AssertionError(f"banded_wta grid K={K} {dtype} {nvol} volumes n={n} {mode} "
                                                     f"sub={sub} differs from its plain form")
                            cases += 1
    out["banded_wta"]["grid_cases"] = cases
    print(f"kernel banded_wta grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    cases = 0
    for W_ in LR_GRID["W"]:
        for nd in LR_GRID["ndisp"]:
            for rows in LR_GRID["rows"]:
                if nd >= W_ or (rows > 7 and (rows * W_ > 30_000_000 or nd > 128)):
                    continue
                rng = np.random.default_rng(W_ + nd + rows)
                for mode in LR_MODES:
                    pack, d16 = (torch.from_numpy(m).to(dev) for m in lr_maps(rng, (1, rows, W_ - nd), nd, mode))
                    for md in LR_GRID["max_diff"]:
                        kw = dict(W=W_, ndisp=nd, max_diff=md)
                        if not torch.equal(lr_cuda.lr_fail_packed(pack, d16, **kw),
                                           lr_cuda.lr_fail_packed_plain(pack, d16, **kw)):
                            raise AssertionError(f"lr_fail_packed grid W={W_} ndisp={nd} rows={rows} {mode} "
                                                 f"max_diff={md} differs from its plain form")
                        cases += 1
    out["lr_fail_packed"]["grid_cases"] = cases
    print(f"kernel lr_fail_packed grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


# Phase 30: the grids of the fused R->L WTA (#5) and the fused banded WTA
# (#19). #5: the register forms' edges (VPL 1, 2, 4, 8, 32 and the direct
# form at 129), both storage types, widths from one column to exact8's,
# 5 and 9 rows (no multiple of a block's rows). #19: 2-4 volumes, both
# storage types, pixel counts about a warp's and a block's run, shift maps
# at 0, at ndisp - 16 and random, adversarial lanes.
RL_GRID = dict(D=(3, 4, 31, 32, 128, 129, 1024), W=(1, 2, 31, 1152), uniq=(0, 10))
FUSED19_GRID = dict(pixels=(1, 31, 255, 257, 1007), ndisp=2047)


def phase_fused_kernels(dev) -> dict:
    """#5 on the recorded exact8 fused call's arguments and #19 on the
    recorded hier16x3 fused call's: exact against the plain form (run on the
    card) on the first frame, one device launch a call and no other
    (graph_kernels), five timed runs of 5 calls (CUDA events), the bound,
    torch's copy of as many bytes, and what each replaces on the unfused path
    timed on the same arguments (#5: #3's R->L launch then #4, whose maps
    must equal #5's; #19: #20 on the same volumes); then both grids, card
    against plain, exact."""
    out = {}
    for name in ("horizontal_rl_wta", "banded_wta_fused"):
        rec = FUSED_RECORDS.get(name)
        if rec is None:
            raise AssertionError(f"no recorded call of {name}")
        args, kwargs = rec["args"], rec["kwargs"]
        fn, plain = KERNELS[name][0], PLAIN[name]
        kern = lambda: fn(*args, **kwargs)
        got = kern()
        ref = plain(*_head(args, 1), **_head(kwargs, 1))
        torch.cuda.synchronize()
        if len(got) != len(ref) or any(not torch.equal(a[:1], r.to(a.dtype)) for a, r in zip(got, ref)):
            raise AssertionError(f"{name} ({rec['path']}) differs from its plain form")
        launched = graph_kernels(kern)  # the call launches this one kernel and nothing else
        launches = sum(name in k for k in launched)
        if launches != 1 or len(launched) != 1:
            raise AssertionError(f"{name} ({rec['path']}) launched {launched} on the device")
        runs = [event_ms(kern, 5) for _ in range(5)]
        if name == "horizontal_rl_wta":
            C, s_dn, s_up, s_lr, P1, P2, uniq = args
            other = "unfused pair (#3 R->L + #4)"
            unfused = lambda: sgm_cuda.wta4([s_dn, s_up, s_lr, sgm_cuda.horizontal(C, P1, P2, True, PARAMS.cost_bound)],
                                            uniq)
            if not all(torch.equal(a, b) for a, b in zip(unfused(), got)):
                raise AssertionError("the unfused pair's maps differ from the fused R->L kernel's")
            shape, plan = list(C.shape), sgm_cuda.horizontal_rl_wta.plan
        else:
            vols, uniq = args[0], args[2]
            other = "#20 (6-stat) on the same volumes"
            unfused = lambda: banded_cuda.banded_wta(vols, uniq, False)
            shape, plan = list(vols[0].shape), None
        other_runs = [event_ms(unfused, 5) for _ in range(5)]
        nbytes = _nbytes(args) + _nbytes(got)
        b_ms, b_by = bound_ms(nbytes, _ops(name, args, kwargs, got[0].numel()))
        c_ms = copy_ms(nbytes)
        out[name] = dict(path=rec["path"], shape=shape, plan=plan, device_launches=launches, runs_ms=runs,
                         ms=min(runs), bound_ms=b_ms, bound_by=b_by, copy_ms=c_ms, bytes=nbytes, replaced=other,
                         replaced_runs_ms=other_runs, replaced_ms=min(other_runs))
        print(f"kernel {name} ({rec['path']}, {tuple(shape)}, plan {plan}): exact, {launches} device launch(es), runs "
              f"{[round(r, 4) for r in runs]} ms, bound {b_ms:.4f} ms by {b_by}, copy {c_ms:.4f} ms, {other} "
              f"{[round(r, 4) for r in other_runs]} ms", flush=True)
        del got, ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cases, forms = 0, {}
    for D in RL_GRID["D"]:
        for dtype in (torch.int16, torch.int32):
            B_, H_ = (1, 5) if dtype == torch.int16 else (3, 3)
            bound = PARAMS.cost_bound if dtype == torch.int16 else 40000
            modes = WTA_MODES if dtype == torch.int32 else WTA_MODES[:-1]
            for W_ in RL_GRID["W"]:
                rng = np.random.default_rng(D * 10 + W_)
                for i, uniq in enumerate(RL_GRID["uniq"]):
                    mode = modes[(W_ + i) % len(modes)]
                    C = rng.integers(0, bound + 1, (B_, H_, W_, D))
                    C[:, 1::2] = 0  # every other row: an L flat over d, so the volumes' ties survive in S
                    vols = wta_volumes(rng, (B_, H_, W_, D), mode, 3, np.int32 if dtype == torch.int32 else np.int16)
                    Cd = torch.from_numpy(C).to(dtype).to(dev)
                    vd = [torch.from_numpy(v).to(dtype).to(dev) for v in vols]
                    got = sgm_cuda.horizontal_rl_wta(Cd, *vd, 200, 800, uniq)
                    ref = sgm_cuda.horizontal_rl_wta_plain(Cd, *vd, 200, 800, uniq)
                    if not all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, ref)):
                        raise AssertionError(f"horizontal_rl_wta grid D={D} {dtype} W={W_} uniq={uniq} {mode} "
                                             f"({sgm_cuda.horizontal_rl_wta.plan}) differs from its plain form")
                    form = sgm_cuda.horizontal_rl_wta.plan["form"]
                    forms[form] = forms.get(form, 0) + 1
                    cases += 1
    out["horizontal_rl_wta"].update(grid_cases=cases, grid_forms=forms)
    print(f"kernel horizontal_rl_wta grid: {cases} cases exact, forms {forms} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    cases, K, nd = 0, banded_cuda.FUSED_BAND, FUSED19_GRID["ndisp"]
    for dtype in (torch.int16, torch.int32):
        for nvol in (2, 3, 4):
            rng = np.random.default_rng(nvol)
            for n in FUSED19_GRID["pixels"]:
                for mode in WTA_MODES[:-1]:  # the pack holds minS < 2^20: no sums near 2^31
                    vols = [torch.from_numpy(v).to(dtype).to(dev) for v in wta_volumes(rng, (1, 1, n, K), mode, nvol)]
                    for kind in ("zero", "top", "random"):
                        s = (np.zeros((1, 1, n)) if kind == "zero" else np.full((1, 1, n), nd - K) if kind == "top"
                             else rng.integers(0, nd - K + 1, (1, 1, n)))
                        sd = torch.from_numpy(s.astype(np.int32)).to(dev)
                        kw = dict(ndisp=nd, volume_bound=None if dtype == torch.int16 else 6000)
                        got = banded_cuda.banded_wta_fused(vols, sd, 10, **kw)
                        ref = banded_cuda.banded_wta_fused_plain(vols, sd, 10)
                        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                            raise AssertionError(f"banded_wta_fused grid {dtype} {nvol} volumes n={n} {mode} "
                                                 f"shift {kind} differs from its plain form")
                        cases += 1
    out["banded_wta_fused"]["grid_cases"] = cases
    print(f"kernel banded_wta_fused grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


# Phase 31: the pyramid's (#14) settings: nesting factor sets (one launch)
# and others (a launch a level), odd and unaligned widths, one frame; and the
# unpacked LR check's (#9): widths and ranges up to the pack's field, valid
# regions off 16 bytes, rows from one to more than exact8's 2,880 (where the
# plain form stays under a second: 4 M pixels at most, ranges to 128;
# max_diff 0-2 at ranges to 128, 1 above).
PYRAMID_GRID = dict(factors=(((4, 4), (2, 2)), ((4, 4),), ((8, 8), (4, 4), (2, 2)), ((4, 8), (2, 2)),
                             ((16, 16), (2, 4)), ((3, 3),), ((4, 4), (3, 3)), ((2, 8), (4, 2))),
                    shapes=((1, 720, 1280), (2, 45, 101), (3, 17, 26), (1, 33, 130)))
LR9_GRID = dict(W_ndisp_mindisp=((17, 8, 0), (96, 16, 16), (1280, 128, 0), (1283, 128, 16), (4096, 1024, 0),
                                 (20000, 2031, 16)), past_min_x=(0, 3), rows=(1, 7, 33, 2881))
PYRAMID_LR_KEYS = ("downsample_pyramid (hier4x3)", "downsample_pyramid (hier4x8)", "downsample_pyramid (hier16x3)",
                   "lr_fail (exact8)")


def pyramid_entry(left, right, factors):
    """The pyramid's C entry alone on these arguments (the main paths'
    factors nest: one launch): a function that launches it, and its outputs."""
    P, H, W_ = left.shape
    n = len(factors)
    order = sorted(range(n), key=lambda i: factors[i])
    outs = [torch.empty((2, P, H // fy, W_ // fx), dtype=torch.int32, device=left.device) for fy, fx in factors]
    fy, fx = ((ctypes.c_int * n)(*(factors[i][k] for i in order)) for k in (0, 1))
    ptrs = (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in order))
    lib, st = banded_cuda._lib("downsample"), torch.cuda.current_stream().cuda_stream
    return (lambda: lib.svt_downsample_pyramid(left.data_ptr(), right.data_ptr(), P, H, W_, n, fy, fx, ptrs, st),
            [o.unbind(0) for o in outs])


def lr_entry(minS, best, disp, *, W, min_x, ndisp, mindisp, max_diff):
    """The unpacked LR check's C entry alone on these arguments: a function
    that launches it, and its mask."""
    maps = [m.contiguous() for m in (minS, best, disp)]
    if any(m.data_ptr() % 16 for m in maps):
        raise AssertionError("the recorded LR maps do not start on 16 bytes")
    fail = torch.empty(minS.shape, dtype=torch.bool, device=minS.device)
    B_, H_, Wv = minS.shape
    lib, st = lr_cuda._lib(), torch.cuda.current_stream().cuda_stream
    return lambda: lib.svt_lr_fail(*(m.data_ptr() for m in maps), fail.data_ptr(), B_ * H_, W, Wv, min_x, ndisp,
                                   mindisp, max_diff, st), fail


def phase_pyramid_lr(dev) -> dict:
    """The pyramid (#14) on the arguments each hier main path's recorded call
    gave it and the unpacked LR check (#9) on the exact8 call's
    (``PYRAMID_LR_RECORDS``): exact against the plain form (run on the card)
    on the first frame, one device launch a call and no other
    (graph_kernels), five timed runs of 5 calls of the wrapper and of its C
    entry alone (CUDA events), the bound (every input read once, every
    output written once), torch's copy of as many bytes; beside #14 the
    parent's form (downsample_box once a level and image, its device
    launches and the bound of its work: each launch reads a whole image set)
    and avg_pool2d. Then both grids, card against plain, exact."""
    out = {}
    for key in PYRAMID_LR_KEYS:
        rec = PYRAMID_LR_RECORDS.get(key)
        if rec is None:
            raise AssertionError(f"no recorded call of {key}")
        name, args, kwargs = rec["name"], rec["args"], rec["kwargs"]
        fn, plain = KERNELS[name][0], PLAIN[name]
        kern = lambda: fn(*args, **kwargs)
        got, ref = _flat(kern()), _flat(plain(*_head(args, 1), **_head(kwargs, 1)))
        torch.cuda.synchronize()
        if len(got) != len(ref) or any(not torch.equal(a[:1], r) for a, r in zip(got, ref)):
            raise AssertionError(f"{key} differs from its plain form")
        kernel = "downsample_pyramid_kernel" if name == "downsample_pyramid" else "lr_fail_unpacked_kernel"
        launched = graph_kernels(kern)
        launches = sum(kernel in k for k in launched)
        if launches != 1 or len(launched) != 1:
            raise AssertionError(f"{key} launched {launched} on the device")
        entry, entry_out = pyramid_entry(*args) if name == "downsample_pyramid" else lr_entry(*args, **kwargs)
        if entry() != 0 or not all(torch.equal(a, b) for a, b in zip(_flat(entry_out), got)):
            raise AssertionError(f"{key}: the C entry's output differs from the wrapper's")
        runs = [event_ms(kern, 5) for _ in range(5)]
        entry_runs = [event_ms(entry, 5) for _ in range(5)]
        nbytes = _nbytes(args) + _nbytes(got)
        b_ms, b_by = bound_ms(nbytes, _ops(name, args, kwargs, got[0].numel()))
        row = dict(path=rec["path"], shape=list(args[0].shape), device_launches=launches, runs_ms=runs, ms=min(runs),
                   entry_runs_ms=entry_runs, entry_ms=min(entry_runs), bound_ms=b_ms, bound_by=b_by,
                   copy_ms=copy_ms(nbytes), bytes=nbytes)
        note = ""
        if name == "downsample_pyramid":
            left, right, factors = args
            parent = lambda: [banded_cuda.downsample_box(img, fy, fx) for fy, fx in factors for img in (left, right)]
            if not all(torch.equal(a, b) for a, b in zip(parent(), got)):
                raise AssertionError(f"{key}: the parent's form differs from the pyramid")
            parent_launches = device_launches(parent, "downsample_box_kernel")
            parent_runs = [event_ms(parent, 5) for _ in range(5)]
            lib = LIBRARY[name]
            lib_runs = [event_ms(lambda: lib(*args), 5) for _ in range(5)]
            parent_bytes = len(factors) * _nbytes((left, right)) + _nbytes(got)
            row.update(factors=[list(f) for f in factors], parent_form="downsample_box a level and image",
                       parent_device_launches=parent_launches, parent_runs_ms=parent_runs,
                       parent_form_ms=min(parent_runs), parent_work_bound_ms=bound_ms(parent_bytes, 0)[0],
                       library_runs_ms=lib_runs, library_ms=min(lib_runs))
            note = (f"; parent's form ({parent_launches} launches) {[round(r, 4) for r in parent_runs]} ms, bound of "
                    f"its work {row['parent_work_bound_ms']:.4f} ms, avg_pool2d {[round(r, 4) for r in lib_runs]} ms")
        out[key] = row
        print(f"kernel {key} {tuple(row['shape'])}: exact, {launches} device launch(es), runs "
              f"{[round(r, 4) for r in runs]} ms, C entry {[round(r, 4) for r in entry_runs]} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, copy {row['copy_ms']:.4f} ms{note}", flush=True)
        del got, ref, entry_out
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cases = 0
    for factors in PYRAMID_GRID["factors"]:
        for P, H_, W_ in PYRAMID_GRID["shapes"]:
            rng = np.random.default_rng(P * H_ * W_)
            for fill in ("random", 0, 255):
                img = rng.integers(0, 256, (2, P, H_, W_)) if fill == "random" else np.full((2, P, H_, W_), fill)
                left, right = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in img)
                got = _flat(banded_cuda.downsample_pyramid(left, right, factors))
                if not all(torch.equal(a, b) for a, b in
                           zip(got, _flat(banded_cuda.downsample_pyramid_plain(left, right, factors)))):
                    raise AssertionError(f"downsample_pyramid grid {factors} {(P, H_, W_)} {fill} differs from its "
                                         "plain form")
                cases += 1
    buf = [torch.arange(2 * 40 * 96 + 1, dtype=torch.int32, device=dev) % 251 for _ in range(2)]
    left, right = (b[1:].view(2, 40, 96) for b in buf)  # frames 4 bytes past a 16-byte boundary
    for factors in PYRAMID_GRID["factors"][:3]:
        if not all(torch.equal(a, b) for a, b in zip(_flat(banded_cuda.downsample_pyramid(left, right, factors)),
                                                    _flat(banded_cuda.downsample_pyramid_plain(left, right, factors)))):
            raise AssertionError(f"downsample_pyramid on frames off 16 bytes {factors} differs from its plain form")
        cases += 1
    out["downsample_pyramid grid_cases"] = cases
    print(f"kernel downsample_pyramid grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    cases = 0
    for W_, nd, md in LR9_GRID["W_ndisp_mindisp"]:
        rng = np.random.default_rng(W_ + nd + md)
        for extra in LR9_GRID["past_min_x"]:
            min_x = nd + md + extra
            Wv = W_ - min_x
            for rows in LR9_GRID["rows"]:
                if rows > 33 and (rows * W_ > 4_000_000 or nd > 128):
                    continue
                for mode in LR_MODES:
                    pack, d16 = lr_maps(rng, (1, rows, Wv), nd, mode)
                    best = pack & 2047
                    best[rng.random(best.shape) < 0.02] = rng.choice([-1, nd, 2047])
                    minS, best, disp = (torch.from_numpy(m.astype(t)).to(dev) for m, t in
                                        zip((pack >> 11, best, d16 / 16.0 + md), (np.int32, np.int32, np.float32)))
                    for max_diff in ((0, 1, 2) if nd <= 128 else (1,)):
                        kw = dict(W=W_, min_x=min_x, ndisp=nd, mindisp=md, max_diff=max_diff)
                        got = lr_cuda.lr_fail(minS, best, disp, **kw)
                        if not torch.equal(got, sgbm.lr_fail(minS, best, disp, **kw)):
                            raise AssertionError(f"lr_fail grid W={W_} ndisp={nd} mindisp={md} min_x={min_x} "
                                                 f"rows={rows} {mode} max_diff={max_diff} differs from its plain form")
                        cases += 1
    out["lr_fail grid_cases"] = cases
    print(f"kernel lr_fail grid: {cases} cases exact ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


# Phase 32: the CLI's chain intrinsic -> extrinsic -> rectify -> sync ->
# stream (stereo_vision_tpu/pipeline/cli.py:74-181, 235-397) on the card. The
# true rig is parallel_rig's at 1280x720 (f = 1000 px, no distortion, R = I)
# with its 0.1 m baseline in the board's millimetres; a 9x6, 100 mm board.
CAL_K = np.array([[1000.0, 0, (W - 1) / 2], [0, 1000.0, (H - 1) / 2], [0, 0, 1]])
CAL_T = np.array([-100.0, 0.0, 0.0])
CAL_FRAMES = 20
# Card against CPU: tests/test_torch_calib.py's tolerances of the port
# against JAX (float64 on both, products summed in another order).
CAL_RTOL = {"K": 1e-5, "dist": 1e-5, "tvecs": 1e-5, "T": 1e-5, "E": 1e-5, "F": 1e-5}
CAL_ATOL = {"rvecs": 1e-6, "R": 1e-6, "per_frame_errors": 1e-6, "rms": 1e-6}
# The streams: the right camera 3 frames late, a flash at left frame 20; two
# hier4x3 windows of 32 pairs (the CLI's default window for sgbm_hier).
STREAM_LAG, STREAM_FLASH = 3, 20
STREAM_FRAMES = 2 * HIER_P + STREAM_LAG
CONTENT_SEARCH = 10  # offsets searched by content (tests/test_sync.py's window): at least 22 pairs overlap
EXACT_KERNELS = {"cost": cost_cuda.cost_volume, "vertical": sgm_cuda.vertical, "horizontal": sgm_cuda.horizontal,
                 "wta4": sgm_cuda.wta4, "lr_fail": lr_cuda.lr_fail, "speckle_filter": speckle_cuda.speckle_filter}
STREAM_KERNELS = {"sgbm_hier": {k: KERNELS[k][0] for k in HIER_KERNEL_NAMES}, "sgbm": EXACT_KERNELS,
                  "bm": {"bm_disparity": bm_cuda.bm_disparity}}


def same_calibration(name: str, card, cpu) -> dict:
    """The card's calibration result against the CPU's, field by field,
    within CAL_RTOL / CAL_ATOL; returns the largest differences."""
    out = {}
    for field in (f.name for f in dataclasses.fields(card)):
        a, b = getattr(card, field), getattr(cpu, field)
        if field == "kept_frames":
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: the card kept frames {a}, the CPU {b}")
            continue
        if field not in CAL_RTOL and field not in CAL_ATOL:
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.abs(a - b).max())
        rel = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())
        ok = (np.abs(a - b) <= CAL_RTOL[field] * np.abs(b)).all() if field in CAL_RTOL else err <= CAL_ATOL[field]
        if not ok:
            raise AssertionError(f"{name}: {field} differs between the card and the CPU (abs {err}, rel {rel})")
        out[field] = rel if field in CAL_RTOL else err
    return out


def stream_window(proc, run, wl, wr, maps, Q, matcher: str, params, dev) -> dict:
    """One window through the processor (the caller's arrays rewritten right
    after ``submit``) with the path's kernel counts set to 0 before it and
    read after it, held bit for bit to batched_stereo_pipeline on the same
    frames with host maps (its counts read the same way; they must be equal
    and none 0); then host-clock ms of the closure ``run`` (maps on the
    card), of batched_stereo_pipeline (host maps) and of submit + drain."""
    kernels = STREAM_KERNELS[matcher]

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {name: k.launches for name, k in kernels.items()}

    ref, ref_counts = counted(lambda: batched_stereo_pipeline(wl, wr, maps, Q, matcher, params, device=dev))
    ref = tuple(t.cpu().numpy() for t in ref)

    def submit_drain():
        lc, rc = wl.copy(), wr.copy()
        proc.submit(lc, rc)
        lc[:] = 0  # the caller reuses its buffers at once
        rc[:] = 255
        return proc.drain()

    out, counts = counted(submit_drain)
    if counts != ref_counts or min(counts.values()) == 0:
        raise AssertionError(f"{matcher} window launches {counts}, batched_stereo_pipeline's {ref_counts}")
    for a, b, what in zip(out, ref, ("disparity", "points")):
        if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"the processor's {matcher} {what} differs from batched_stereo_pipeline's")
    truth = scene_truth(H, W)
    min_x = {"sgbm_hier": D, "sgbm": PARAMS.min_disparity + D, "bm": BM_PARAMS.num_disparities}[matcher]
    valid_share, within1 = quality(out[0], truth, min_x)
    ms = {"closure (maps on the card)": host_ms(lambda: run(wl, wr)),
          "batched_stereo_pipeline (host maps)": host_ms(
              lambda: batched_stereo_pipeline(wl, wr, maps, Q, matcher, params, device=dev)),
          "processor submit + drain": host_ms(lambda: (proc.submit(wl, wr), proc.drain()))}
    return dict(frames=len(wl), launches=counts, valid_share=valid_share, within1_share=within1,
                ms={k: round(v, 3) for k, v in ms.items()})


def phase_calibrate_stream(dev) -> dict:
    """Phase 32: calibrate both cameras and the rig from board corners
    (card against CPU, card against the truth), rectify on the card, find
    the streams' offset by their flash and by content (card against CPU),
    then stream windows of synchronised pairs through StereoStreamProcessor
    with the calibrated maps and Q, each held bit for bit to
    batched_stereo_pipeline."""
    out = {}
    zero = np.zeros(5)
    obj, c1, c2 = board_views(CAL_FRAMES, 0, CAL_K, zero, (W, H), CAL_K, zero, np.eye(3), CAL_T)
    seconds, cal = {}, {}
    for name, fn in (("camera 1", lambda d: calib.calibrate_camera(obj, c1, (W, H), device=d)),
                     ("camera 2", lambda d: calib.calibrate_camera(obj, c2, (W, H), device=d)),
                     ("stereo", lambda d: calib.calibrate_stereo(obj, c1, c2, cal["camera 1"][0].K,
                                                                 cal["camera 1"][0].dist, cal["camera 2"][0].K,
                                                                 cal["camera 2"][0].dist, (W, H), device=d))):
        results = []
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            results.append(fn(d))
            seconds[f"{name} {torch.device(d).type}"] = time.perf_counter() - t0
        cal[name] = results
        out[f"{name} card vs cpu"] = same_calibration(name, *results)
    for name in ("camera 1", "camera 2"):
        K, rms = cal[name][0].K, cal[name][0].rms
        if (abs(K[0, 0] / CAL_K[0, 0] - 1) > 0.005 or abs(K[1, 1] / CAL_K[1, 1] - 1) > 0.005
                or abs(K[0, 2] - CAL_K[0, 2]) > 8 or abs(K[1, 2] - CAL_K[1, 2]) > 8 or not rms < 0.3):
            raise AssertionError(f"{name}'s calibration is off the truth: K {K.tolist()}, rms {rms}")
    st = cal["stereo"][0]
    if abs(st.baseline / np.linalg.norm(CAL_T) - 1) > 0.01:
        raise AssertionError(f"the calibrated baseline {st.baseline} mm is off the true {np.linalg.norm(CAL_T)}")
    out["calibration"] = dict(fx=[cal[n][0].K[0, 0] for n in ("camera 1", "camera 2")],
                              rms=[cal[n][0].rms for n in ("camera 1", "camera 2", "stereo")],
                              baseline_mm=st.baseline, seconds=seconds)
    print(f"calibration ({CAL_FRAMES} views of 9x6 at {W}x{H}): card == CPU; fx {out['calibration']['fx']}, "
          f"rms {out['calibration']['rms']}, baseline {st.baseline:.4f} mm; seconds {json.dumps(seconds)}",
          flush=True)

    cam1, cam2 = cal["camera 1"][0], cal["camera 2"][0]
    res = ops.stereo_rectify(cam1.K, cam1.dist, cam2.K, cam2.dist, (W, H), st.R, st.T, device=dev)
    maps = (*ops.init_undistort_rectify_map(cam1.K, cam1.dist, res.R1, res.P1, (W, H), device=dev),
            *ops.init_undistort_rectify_map(cam2.K, cam2.dist, res.R2, res.P2, (W, H), device=dev))
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    out["maps max px from identity"] = max(float((m - g).abs().max()) for m, g in zip(maps, (xx, yy, xx, yy)))
    if any(m.device != res.Q.device or m.device.type != torch.device(dev).type for m in maps):
        raise AssertionError("the rectification maps left the card")
    maps = tuple(m.cpu().numpy() for m in maps)
    Q = res.Q.cpu().numpy()
    print(f"rectified on the card: maps up to {out['maps max px from identity']:.3f} px from the identity, "
          f"Q[2, 3] {Q[2, 3]:.3f}, 1/Q[3, 2] {1 / Q[3, 2]:.4f} mm", flush=True)

    left, right = flash_streams(STREAM_FRAMES, STREAM_LAG, STREAM_FLASH, H, W)
    t0 = time.perf_counter()
    flash = sync.synchronize_streams(left, right, device=dev)
    t_flash = time.perf_counter() - t0
    flash_cpu = sync.synchronize_streams(left, right, device="cpu")
    if flash[:3] != flash_cpu[:3] or flash.offset != STREAM_LAG:
        raise AssertionError(f"flash sync: card {flash}, CPU {flash_cpu}, the streams' lag {STREAM_LAG}")
    t0 = time.perf_counter()
    content = sync.find_best_offset_by_content(left[:HIER_P], right[:HIER_P], CONTENT_SEARCH, device=dev)
    t_content = time.perf_counter() - t0
    content_cpu = sync.find_best_offset_by_content(left[:HIER_P], right[:HIER_P], CONTENT_SEARCH, device="cpu")
    if content[0] != content_cpu[0] or content[0] != flash.offset or abs(content[1] - content_cpu[1]) > 0.05:
        raise AssertionError(f"content offset: card {content}, CPU {content_cpu}, by the flash {flash.offset}")
    offset = flash.offset
    out["sync"] = dict(flash=flash._asdict(), flash_s=t_flash, content_offset=content[0], content_psnr=content[1],
                       content_psnr_cpu=content_cpu[1], content_s=t_content)
    print(f"sync of {STREAM_FRAMES} frames a stream: flash at left {flash.left_flash}, right {flash.right_flash} "
          f"(offset {offset}, {t_flash:.3f} s); by content over {HIER_P} frames offset {content[0]}, "
          f"{content[1]:.4f} dB (CPU {content_cpu[1]:.4f}; {t_content:.3f} s); card == CPU", flush=True)

    mesh = create_mesh()
    windows = {"sgbm_hier": [(left[i * HIER_P:(i + 1) * HIER_P], right[i * HIER_P + offset:(i + 1) * HIER_P + offset])
                             for i in range(2)],
               "sgbm": [(left[:B], right[offset:B + offset])],
               "bm": [(left[:BM_B], right[offset:BM_B + offset])]}
    params = {"sgbm_hier": P3, "sgbm": PARAMS, "bm": BM_PARAMS}
    for matcher, wins in windows.items():
        proc = StereoStreamProcessor(mesh, maps, Q, matcher, params[matcher])
        run = make_sharded_pipeline(mesh, maps, Q, matcher, params[matcher])
        for i, (wl, wr) in enumerate(wins):
            r = stream_window(proc, run, wl, wr, maps, Q, matcher, params[matcher], dev)
            out[f"{matcher} window {i}"] = r
            print(f"stream {matcher} window {i} ({r['frames']} pairs): equal to batched_stereo_pipeline, launches "
                  f"{json.dumps(r['launches'])}, valid share {r['valid_share']:.4f}, within 1 px "
                  f"{r['within1_share']:.4f}; ms {json.dumps(r['ms'])}", flush=True)
        del proc, run
        torch.cuda.empty_cache()
    return out


# Phase 33: detection on the card at the CLI's frame sizes. The CLI's default
# board (stereo_vision_tpu/pipeline/cli.py:699: 7x4 inner corners, 100 mm
# squares) seen by a 1920x1080 rig of f = 1500 px, 100 mm apart, 20 views.
DET_W, DET_H = 1920, 1080
DET_BOARD, DET_SQUARE, DET_VIEWS = (7, 4), 100.0, 20
DET_K = np.array([[1500.0, 0, (DET_W - 1) / 2], [0, 1500.0, (DET_H - 1) / 2], [0, 0, 1]])
DET_T = np.array([-100.0, 0.0, 0.0])
# Corners card against CPU: the same candidates (the response is elementwise
# float32 in one order on both), refined by sums over the window reduced in
# other orders; tests/test_torch_checkerboard.py holds the port to JAX within
# 1e-2 px, the card to the CPU is held tighter.
DET_CARD_CPU_PX = 5e-3
DET_TRUTH_PX = 0.5  # every clean view's corners against the render's truth
DEGRADED = ("noise", "glare", "low_contrast", "blur", "occlusion", "foreshorten")
DEGRADED_VIEWS = 4  # views of camera 1 under each degradation
VALIDATE_MM, VALIDATE_TOL = 2500.0, 10.0  # validate-distance's truth and the CLI's --tolerance default
# The ball: a 1280x720 frame, radius 32 px at the centre (synth.scenes.ball_frame).
BALL_W, BALL_H, BALL_R = 1280, 720, 32.0
BALL_C = (640.0, 360.0)
BALL_CROP = 120  # half-size of the crop the CPU's Hough runs on (holds every ring up to r = 101)
HOUGH_KW = dict(min_radius=20, max_radius=100)  # the highlight (r = 8) is no ball


def degrade(kind: str, img: np.ndarray, truth: np.ndarray, rng) -> tuple[np.ndarray, np.ndarray]:
    """One of phase 33's degradations (the cv2-free forms of synth.boards):
    the image and its corners' truth (moved by the perspective warp)."""
    if kind == "noise":
        return add_noise(img, 12.0, rng), truth
    if kind == "glare":
        return add_glare(img, rng), truth
    if kind == "low_contrast":
        return add_noise(low_contrast(img), 6.0, rng), truth
    if kind == "occlusion":
        return occlude(img, truth, rng, frac=0.05), truth
    if kind == "foreshorten":
        return warp_perspective(img, truth, 0.15, rng)
    return motion_blur(img, 9, rng.uniform(0, 180)), truth


def detect_both(img: np.ndarray, dev) -> tuple:
    """find_chessboard_corners on the card and on the CPU; equal ok flags,
    corners within DET_CARD_CPU_PX. Returns (ok, card corners, CPU corners, px apart)."""
    ok, c = detect.find_chessboard_corners(img, DET_BOARD, device=dev)
    ok_cpu, c_cpu = detect.find_chessboard_corners(img, DET_BOARD, device="cpu")
    if ok != ok_cpu:
        raise AssertionError(f"the card's detection says {ok}, the CPU's {ok_cpu}")
    apart = float(np.abs(c - c_cpu).max()) if ok else 0.0
    if apart > DET_CARD_CPU_PX:
        raise AssertionError(f"corners card against CPU {apart} px apart (limit {DET_CARD_CPU_PX})")
    return ok, c, c_cpu, apart


def check_truth_limits(name: str, K, rms) -> None:
    """Phase 32's limits of a calibration against the truth."""
    if (abs(K[0, 0] / DET_K[0, 0] - 1) > 0.005 or abs(K[1, 1] / DET_K[1, 1] - 1) > 0.005
            or abs(K[0, 2] - DET_K[0, 2]) > 8 or abs(K[1, 2] - DET_K[1, 2]) > 8 or not rms < 0.3):
        raise AssertionError(f"{name}'s calibration from detected corners is off the truth: K {K.tolist()}, rms {rms}")


def phase_detect(dev, card: str) -> dict:
    """Phase 33: calibrate from corners detected on the card at 1920x1080,
    degraded views, the validate-distance chain, circles and balls, times."""
    out = {}
    obj, c1, c2, pose1, pose2 = board_views(DET_VIEWS, 3, DET_K, np.zeros(5), (DET_W, DET_H), DET_K, np.zeros(5),
                                            np.eye(3), DET_T, cols=DET_BOARD[0], rows=DET_BOARD[1],
                                            square=DET_SQUARE, noise=0.0, margin=150.0, depth=(1800.0, 3500.0),
                                            return_poses=True)
    views = [[render_board_view(DET_K, rv, tv, (DET_W, DET_H), *DET_BOARD, DET_SQUARE, device=dev)
              for rv, tv in zip(*pose)] for pose in (pose1, pose2)]
    detected, apart, truth_px = [], 0.0, 0.0
    for cam, (vs, truth) in enumerate(zip(views, (c1, c2))):
        found = []
        for i, (img, t) in enumerate(vs):
            if np.abs(t - truth[i]).max() > 1e-6:
                raise AssertionError("the render's truth is not board_views' corners")
            ok, c, _, d = detect_both(img, dev)
            if not ok:
                raise AssertionError(f"camera {cam + 1} view {i}: no board found in a clean view")
            err = float(np.abs(c - t).max())
            if err > DET_TRUTH_PX:
                raise AssertionError(f"camera {cam + 1} view {i}: corners {err} px off the truth")
            apart, truth_px = max(apart, d), max(truth_px, err)
            found.append(c.astype(np.float64))
        detected.append(np.stack(found))
    cams = [calib.calibrate_camera(obj, d, (DET_W, DET_H), device=dev) for d in detected]
    for name, cam in zip(("camera 1", "camera 2"), cams):
        check_truth_limits(name, cam.K, cam.rms)
    st = calib.calibrate_stereo(obj, detected[0], detected[1], cams[0].K, cams[0].dist, cams[1].K, cams[1].dist,
                                (DET_W, DET_H), device=dev)
    if abs(st.baseline / np.linalg.norm(DET_T) - 1) > 0.01:
        raise AssertionError(f"the baseline from detected corners {st.baseline} mm is off the true 100")
    out["clean"] = dict(views=2 * DET_VIEWS, card_cpu_px=apart, truth_px=truth_px,
                        fx=[c.K[0, 0] for c in cams], cx=[c.K[0, 2] for c in cams], cy=[c.K[1, 2] for c in cams],
                        rms=[c.rms for c in cams] + [st.rms], baseline_mm=st.baseline)
    print(f"detection ({2 * DET_VIEWS} clean {DET_W}x{DET_H} views of {DET_BOARD[0]}x{DET_BOARD[1]}): all found on "
          f"the card and the CPU, corners card vs CPU <= {apart:.2e} px, vs truth <= {truth_px:.4f} px; calibrated "
          f"from them on the card: fx {out['clean']['fx']}, rms {out['clean']['rms']}, baseline "
          f"{st.baseline:.4f} mm", flush=True)

    rng = np.random.default_rng(33)
    degraded = {}
    for kind in DEGRADED:
        found = {"card": [], "cpu": []}
        for i in range(DEGRADED_VIEWS):
            img, truth = degrade(kind, *views[0][i], rng)
            ok, c, c_cpu, _ = detect_both(img, dev)
            if ok:
                found["card"].append(float(np.linalg.norm(c - truth, axis=1).mean()))
                found["cpu"].append(float(np.linalg.norm(c_cpu - truth, axis=1).mean()))
        degraded[kind] = {side: dict(success=len(e) / DEGRADED_VIEWS, mean_err_px=float(np.mean(e)) if e else None)
                          for side, e in found.items()}
    out["degraded"] = degraded
    print(f"degraded {DET_W}x{DET_H} views ({DEGRADED_VIEWS} each; success share, mean px from the truth), card | "
          f"CPU: " + "; ".join(f"{k} {v['card']['success']:.2f} {v['card']['mean_err_px']} | {v['cpu']['success']:.2f} "
                              f"{v['cpu']['mean_err_px']}" for k, v in degraded.items()), flush=True)

    out["validate_distance"] = validate_distance_chain(dev, cams, st)
    out["balls"] = phase_balls(dev)
    out["times"] = detect_times(dev, views[0][0][0], card)
    return out


def validate_distance_chain(dev, cams, st) -> dict:
    """The CLI's validate-distance on the card: a board VALIDATE_MM from
    camera 1 rendered for both cameras of the true rig, corners detected on
    the card, undistorted with R1/P1 and R2/P2 from stereo_rectify of the rig
    calibrated above, triangulated, measured; the geometry again on the CPU
    from the same corners (rtol 1e-6), and the whole chain from the CPU's
    corners."""
    centre = np.array([(DET_BOARD[0] - 1) * DET_SQUARE / 2, (DET_BOARD[1] - 1) * DET_SQUARE / 2, 0.0])
    rvec = np.array([0.06, -0.1, 0.03])
    target = np.array([-60.0, 40.0, 0.0])
    target[2] = np.sqrt(VALIDATE_MM**2 - target[0] ** 2 - target[1] ** 2)
    tvec = target - ops.rodrigues(torch.from_numpy(rvec)).numpy() @ centre
    imgs = [render_board_view(DET_K, rvec, tv, (DET_W, DET_H), *DET_BOARD, DET_SQUARE, device=dev)[0]
            for tv in (tvec, tvec + DET_T)]
    corners = [detect_both(img, dev) for img in imgs]

    def chain(c1, c2, d):
        rect = ops.stereo_rectify(cams[0].K, cams[0].dist, cams[1].K, cams[1].dist, (DET_W, DET_H), st.R, st.T,
                                  device=d)
        ul = ops.undistort_points(c1.astype(np.float64), cams[0].K, cams[0].dist, R=rect.R1, P=rect.P1, device=d)
        ur = ops.undistort_points(c2.astype(np.float64), cams[1].K, cams[1].dist, R=rect.R2, P=rect.P2, device=d)
        pts = ops.triangulate_points(rect.P1[:3, :4], rect.P2[:3, :4], ul, ur)
        if pts.device.type != torch.device(d).type:
            raise AssertionError("the validate-distance chain left its device")
        return pts.cpu().numpy(), track.validate_distance(pts, VALIDATE_MM, VALIDATE_TOL)

    pts, res = chain(corners[0][1], corners[1][1], dev)
    pts_cpu, res_cpu = chain(corners[0][1], corners[1][1], "cpu")
    _, res_cpu_corners = chain(corners[0][2], corners[1][2], "cpu")
    rel = float(np.abs(pts - pts_cpu).max() / np.abs(pts_cpu).max())
    if not res.passed or abs(res.measured / VALIDATE_MM - 1) > 0.01 or rel > 1e-6:
        raise AssertionError(f"validate-distance: {res} (CPU {res_cpu}), points card vs CPU rel {rel}")
    out = dict(measured_mm=res.measured, error_percent=res.error_percent, passed=res.passed,
               cpu_measured_mm=res_cpu.measured, points_card_cpu_rel=rel,
               cpu_corners_measured_mm=res_cpu_corners.measured)
    print(f"validate-distance on the card: {res.measured:.4f} mm against {VALIDATE_MM} ({res.error_percent:.4f}%, "
          f"passed at {VALIDATE_TOL}%); the geometry on the CPU from the same corners {res_cpu.measured:.4f} mm "
          f"(points rel {rel:.2e}); from the CPU's corners {res_cpu_corners.measured:.4f} mm", flush=True)
    return out


def _pred(cx, cy, half_w, half_h, conf):
    return {"x": cx, "y": cy, "width": 2 * half_w, "height": 2 * half_h, "confidence": conf}


def phase_balls(dev) -> dict:
    """rgb_to_gray and Otsu card against CPU, Hough at 1280x720 on the card
    (against the CPU on a crop that holds every ring around the ball),
    rescore_detections and the hosted client with a stub transport, and
    largest_component_mask at 1920x1080, card against CPU bit for bit."""
    rng = np.random.default_rng(34)
    levels = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)[None]
    triples = rng.integers(0, 256, (1, 100_000, 3), dtype=np.uint8)
    for img in (levels, triples):
        a = detect.rgb_to_gray(torch.from_numpy(img).to(dev)).cpu()
        if not torch.equal(a.view(torch.int32), detect.rgb_to_gray(torch.from_numpy(img)).view(torch.int32)):
            raise AssertionError("rgb_to_gray differs between the card and the CPU")
    for i in range(50):
        g = np.clip(np.where(rng.random((90, 120)) < 0.5, rng.normal(70, 25, (90, 120)),
                             rng.normal(170, 30, (90, 120))), 0, 255).astype(np.float32)
        if float(detect.otsu_threshold(torch.from_numpy(g).to(dev))) != float(detect.otsu_threshold(torch.from_numpy(g))):
            raise AssertionError(f"Otsu's threshold differs between the card and the CPU on image {i}")

    frame = ball_frame(0, BALL_H, BALL_W, *BALL_C, BALL_R)
    gray = detect.rgb_to_gray(torch.from_numpy(frame).to(dev))
    found = detect.hough_circles(gray, **HOUGH_KW)
    x0, y0 = int(BALL_C[0]) - BALL_CROP, int(BALL_C[1]) - BALL_CROP
    crop = gray[y0:y0 + 2 * BALL_CROP, x0:x0 + 2 * BALL_CROP]
    found_crop = detect.hough_circles(crop, **HOUGH_KW)
    found_cpu = detect.hough_circles(crop.cpu(), **HOUGH_KW)
    mag = detect.sobel_magnitude(crop)[0] > 100.0
    radii = tuple(range(20, 101, 2))
    if not torch.equal(detect.hough_accumulator(mag.float(), radii).cpu(),
                       detect.hough_accumulator(mag.cpu().float(), radii)):
        raise AssertionError("the Hough accumulator differs between the card and the CPU")
    c = found[0]
    if (found_crop != found_cpu or (c.cx - x0, c.cy - y0, c.radius, c.score) != found_cpu[0]
            or np.hypot(c.cx - BALL_C[0], c.cy - BALL_C[1]) > 1.0):
        raise AssertionError(f"Hough: card {found[:1]}, card crop {found_crop[:1]}, CPU crop {found_cpu[:1]}")

    boxes = [(BALL_C[0] - 34, BALL_C[1] - 33, BALL_C[0] + 35, BALL_C[1] + 33, 0.8),
             (200.0, 150.0, 280.0, 230.0, 0.9), (1000.0, 500.0, 1060.0, 560.0, 0.3)]
    rescored = [detect.rescore_detections(frame, boxes, color_range=detect.BLUE_HSV_RANGE, device=d)
                for d in (dev, "cpu")]
    stub = [_pred(BALL_C[0] + 2.0, BALL_C[1] - 1.5, 35.0, 33.0, 0.9), _pred(240.0, 190.0, 40.0, 40.0, 0.95)]
    hosted = [detect.HostedDetectorClient(lambda im: stub, device=d).detect(frame) for d in (dev, "cpu")]
    h = hosted[0]
    if (rescored[0][:3] != rescored[1][:3] or abs(rescored[0].confidence / rescored[1].confidence - 1) > 1e-6
            or np.hypot(rescored[0].cx - BALL_C[0], rescored[0].cy - BALL_C[1]) > 1.0):
        raise AssertionError(f"rescore_detections: card {rescored[0]}, CPU {rescored[1]}")
    if (h is None or hosted[1] is None or np.abs(np.subtract(h, hosted[1])).max() > 1e-4
            or np.hypot(h.cx - BALL_C[0], h.cy - BALL_C[1]) > 1.0):
        raise AssertionError(f"the hosted client: card {h}, CPU {hosted[1]}, truth {BALL_C}")

    big = ball_frame(1, 1080, 1920, 900.0, 500.0, 60.0)
    draw_ball(big, 1500.0, 300.0, 40.0, (40, 60, 220))
    hsv = detect.rgb_to_hsv(torch.from_numpy(big))
    mask = detect.in_range(hsv, *detect.BLUE_HSV_RANGE) | torch.from_numpy(rng.random((1080, 1920)) < 0.3)
    lcm = detect.largest_component_mask(mask.to(dev)).cpu()
    lcm_cpu = detect.largest_component_mask(mask)
    if not torch.equal(lcm, lcm_cpu):
        raise AssertionError("largest_component_mask differs between the card and the CPU at 1920x1080")
    out = dict(hough=c._asdict(), hough_cpu_crop=found_cpu[0]._asdict(), rescored=rescored[0]._asdict(),
               hosted=h._asdict(), hosted_cpu=hosted[1]._asdict(), lcm_pixels=int(lcm.sum()))
    print(f"balls: Hough at {BALL_W}x{BALL_H} on the card {c} (CPU on the crop: equal), centre "
          f"{np.hypot(c.cx - BALL_C[0], c.cy - BALL_C[1]):.3f} px from the truth; rescored {rescored[0]} (CPU equal); "
          f"hosted client {h} ({np.hypot(h.cx - BALL_C[0], h.cy - BALL_C[1]):.3f} px from the truth; CPU "
          f"{hosted[1]}); largest_component_mask at 1920x1080 card == CPU ({int(lcm.sum())} px); rgb_to_gray "
          f"(256 levels, 10^5 triples) and Otsu (50 images) card == CPU", flush=True)
    return out


def detect_times(dev, board_img: np.ndarray, card: str) -> dict:
    """Seconds per call, card and CPU, each the mean of a few calls after a
    warm-up: find_chessboard_corners at 1920x1080, hough_circles at 1280x720."""
    frame = ball_frame(0, BALL_H, BALL_W, *BALL_C, BALL_R)
    gray = detect.rgb_to_gray(torch.from_numpy(frame)).numpy()
    calls = {"find_chessboard_corners 1920x1080": lambda d: detect.find_chessboard_corners(board_img, DET_BOARD,
                                                                                            device=d),
             "hough_circles 1280x720": lambda d: detect.hough_circles(gray, **HOUGH_KW, device=d)}
    out = {}
    for name, fn in calls.items():
        for d, reps in ((dev, 5), ("cpu", 2)):
            fn(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(d)
            torch.cuda.synchronize()
            out[f"{name} {torch.device(d).type}"] = (time.perf_counter() - t0) / reps
    print(f"detect times, s per call on {card} (host {torch.get_num_threads()} threads): {json.dumps(out)}",
          flush=True)
    return out


# Phase 34: the CLI's ball-drop and pose chains at its frame size, on the rig
# of tests/test_e2e_detectors.py (f = 350 px at 320 px, 500 mm baseline) with
# its field of view scaled to 1920 px: a ball of 80 mm held 25 frames then
# dropped is ~4.5 px in radius after the letterbox, as in that test.
E2E_W, E2E_H, E2E_F, E2E_BASELINE = 1920, 1080, 2100.0, 500.0
E2E_LEAVES = {"ball": 297, "pose": 156}
# Card against CPU: float32 networks with TF32 off, summed in other orders;
# the letterbox maps 1 px of the letterbox to 15 (ball) or 7.5 (pose) px of
# the frame. The fusion takes the same (the card's) landmarks on both sides.
E2E_BALL_PX, E2E_BALL_CONF = 1e-2, 1e-4
E2E_POSE_PX, E2E_POSE_ZV = 2e-2, 1e-4
E2E_FUSE_MM = 1e-3


def e2e_rig() -> track.StereoRig:
    K = np.array([[E2E_F, 0, E2E_W / 2], [0, E2E_F, E2E_H / 2], [0, 0, 1.0]])
    return track.StereoRig(K1=K, d1=np.zeros(8), K2=K, d2=np.zeros(8), R=np.eye(3),
                           T=np.array([-E2E_BASELINE, 0, 0]))


def same_balls(a, b, what: str) -> float:
    """The largest centre / radius difference of two detection lists (frame
    px), which must find the ball in the same frames."""
    if [d is None for d in a] != [d is None for d in b]:
        raise AssertionError(f"{what}: card and CPU find the ball in different frames")
    px = conf = 0.0
    for d, e in zip(a, b):
        if d is not None:
            px = max(px, abs(d.cx - e.cx), abs(d.cy - e.cy), abs(d.radius - e.radius))
            conf = max(conf, abs(d.confidence - e.confidence))
    if px > E2E_BALL_PX or conf > E2E_BALL_CONF:
        raise AssertionError(f"{what}: card against CPU {px} px, confidence {conf}")
    return px


def split_ms(stages, reps: int = 3) -> dict:
    """CUDA-event ms per stage of a chain of stages (each takes the output of
    the one before), the mean of ``reps`` runs after a warm-up."""
    out = {name: 0.0 for name, _ in stages}
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        x = None
        ev[0].record()
        for i, (_, fn) in enumerate(stages):
            x = fn(x)
            ev[i + 1].record()
        torch.cuda.synchronize()
        if rep:
            for i, (name, _) in enumerate(stages):
                out[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    return out


def phase_ball_pose(dev, card: str) -> dict:
    """Phase 34: the ball-drop chain (render, detect_balls_in_frames,
    analyze_ball_drop, drop_report) and the pose chain (render,
    pose_landmarks_in_frames, run_pose_workflow) at 1920x1080 on the card,
    card against CPU, the hosted client's local transport, times."""
    out = {}
    rig = e2e_rig()
    models = {"ball": pretrained.load_ball_detector(dev), "pose": pretrained.load_pose_net(dev)}
    for name, m in models.items():
        n = len(convert.reference_leaves(m))
        if n != E2E_LEAVES[name]:
            raise AssertionError(f"{name}: {n} weight leaves loaded, not {E2E_LEAVES[name]}")
    out["leaves"] = E2E_LEAVES

    t0 = time.perf_counter()
    lf, rf, uv_l, _, _ = render_ball_drop_stereo(rig, T=120, fps=240.0, H=E2E_H, W=E2E_W, hold_frames=25,
                                                        ball_radius_mm=80.0, seed=3)
    render_s = time.perf_counter() - t0
    dl = pretrained.detect_balls_in_frames(lf, device=dev)
    dr = pretrained.detect_balls_in_frames(rf, device=dev)
    found = float(np.mean([d is not None for d in dl + dr]))
    traj = track.analyze_ball_drop(rig, dl, dr, fps=240.0, device=dev)
    report = track.drop_report(traj, drop_height_mm=0.5 * 9800.0 * (95 / 240.0) ** 2)
    if found <= 0.9:
        raise AssertionError(f"the detector found the ball in only {found:.1%} of the frames")
    if traj.gravity_mm_s2 is None or abs(traj.gravity_mm_s2 - 9800.0) / 9800.0 >= 0.05:
        raise AssertionError(f"gravity {traj.gravity_mm_s2} mm/s^2 is not within 5% of 9800")
    px_err = [np.hypot(d.cx - u, d.cy - v) for d, (u, v) in zip(dl, uv_l) if d is not None]
    idx = np.linspace(0, 119, 8).astype(int)
    ball_apart = max(same_balls(pretrained.detect_balls_in_frames(f[idx], device=dev),
                                pretrained.detect_balls_in_frames(f[idx], device="cpu"), f"camera {c}")
                     for c, f in ((1, lf), (2, rf)))
    small, _ = pretrained.letterbox(lf[idx], pretrained.BALL_IMG_HW, dev)
    kept = [yolov8.detect(pretrained.load_ball_detector(d), small.to(d), score_threshold=0.3, max_det=8).valid.cpu()
            for d in (dev, "cpu")]
    if not torch.equal(*kept):
        raise AssertionError("the card and the CPU keep different detections")
    out["ball_drop"] = dict(frames=2 * len(lf), found=found, gravity_mm_s2=traj.gravity_mm_s2,
                            gravity_error_pct=traj.gravity_error_pct, drop_start=traj.drop_start,
                            median_centre_err_px=float(np.median(px_err)), card_cpu_px=ball_apart,
                            report=report, render_s=render_s)
    print(f"ball drop {E2E_W}x{E2E_H} (120 frames a camera, 240 fps): found in {found:.1%}, gravity "
          f"{traj.gravity_mm_s2:.1f} mm/s^2 ({traj.gravity_error_pct:.2f}% off), median centre "
          f"{np.median(px_err):.2f} px off the truth; card vs CPU <= {ball_apart:.2e} px on 8 frames a camera, "
          f"the same kept detections", flush=True)

    t0 = time.perf_counter()
    plf, prf, gt33 = render_pose_stereo(rig, T=60, H=E2E_H, W=E2E_W, seed=2)
    render_s = time.perf_counter() - t0
    lml = pretrained.pose_landmarks_in_frames(plf, device=dev)
    lmr = pretrained.pose_landmarks_in_frames(prf, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        res = run_pose_workflow(rig, lml, lmr, conf_threshold=0.5, out_dir=tmp, fps=30.0,
                                                    device=dev)
        files = sorted(os.listdir(tmp))
    gt13 = gt33[:, track.joints.MEDIAPIPE_INDICES]
    finite = np.isfinite(res.poses_raw).all(-1)
    err = np.linalg.norm(res.poses_raw - gt13, axis=-1)[finite]
    ang_gt = track.pose_angles(gt13, dev).cpu().numpy()
    ok = np.isfinite(res.angles_raw) & np.isfinite(ang_gt)
    ang_err = float(np.median(np.abs(res.angles_raw - ang_gt)[ok]))
    if finite.mean() <= 0.9 or np.median(err) >= 30.0 or ok.mean() <= 0.9 or ang_err >= 4.0:
        raise AssertionError(f"pose: {finite.mean():.1%} fused, median {np.median(err):.1f} mm, {ok.mean():.1%} "
                             f"angles, median angle error {ang_err:.2f} deg")
    lm_apart = zv_apart = 0.0
    pidx = np.linspace(0, 59, 8).astype(int)
    for f in (plf, prf):
        a, b = (pretrained.pose_landmarks_in_frames(f[pidx], device=d) for d in (dev, "cpu"))
        lm_apart = max(lm_apart, float(np.abs(a[..., :2] - b[..., :2]).max()))
        zv_apart = max(zv_apart, float(np.abs(a[..., 2:] - b[..., 2:]).max()))
    if lm_apart > E2E_POSE_PX or zv_apart > E2E_POSE_ZV:
        raise AssertionError(f"pose landmarks card against CPU: {lm_apart} px, z / visibility {zv_apart}")
    fused = [track.fusion.fuse_pose_sequence(lml, lmr, rig.as_arrays(d), conf_threshold=0.5, device=d).cpu()
             for d in (dev, "cpu")]
    if not torch.equal(fused[0].isnan(), fused[1].isnan()):
        raise AssertionError("fuse_pose_sequence: card and CPU fuse different joints")
    fuse_apart = float((fused[0] - fused[1]).nan_to_num().abs().max())
    if fuse_apart > E2E_FUSE_MM:
        raise AssertionError(f"fuse_pose_sequence card against CPU: {fuse_apart} mm")
    out["pose"] = dict(frames=2 * len(plf), fused=float(finite.mean()), median_joint_err_mm=float(np.median(err)),
                       angles_finite=float(ok.mean()), median_angle_err_deg=ang_err,
                       smoothing_stats={k: v for k, v in res.smoothing_stats.items() if k != "processing_time"},
                       files=files, card_cpu_px=lm_apart, card_cpu_zv=zv_apart, fuse_card_cpu_mm=fuse_apart,
                       render_s=render_s)
    print(f"pose {E2E_W}x{E2E_H} (60 frames a camera): {finite.mean():.1%} of joints fused, median 3D error "
          f"{np.median(err):.2f} mm, {ok.mean():.1%} angles, median angle error {ang_err:.2f} deg; landmarks card vs "
          f"CPU <= {lm_apart:.2e} px (z, visibility {zv_apart:.2e}), fusion card vs CPU <= {fuse_apart:.2e} mm; "
          f"artifacts {files}", flush=True)

    hosted = [detect.HostedDetectorClient(detect.local_transport(device=d), hsv_range=None, device=d).detect(lf[60])
              for d in (dev, "cpu")]
    out["hosted_card_cpu_px"] = same_balls(hosted[:1], hosted[1:], "the hosted client")
    if hosted[0] is None:
        raise AssertionError("the hosted client over local_transport found no ball")
    out["times"] = ball_pose_times(dev, card, np.concatenate([lf, rf]), np.concatenate([plf, prf]), lml, lmr,
                                   res.poses_raw)
    return out


def ball_pose_times(dev, card: str, balls: np.ndarray, bodies: np.ndarray, lml, lmr, poses) -> dict:
    """Seconds per call of the slice's entry points on the card (host clock,
    3 calls after a warm-up), and the two detectors' calls split into their
    stages with CUDA events."""
    rig = e2e_rig()
    calib_arrays = rig.as_arrays(dev)
    smoother = track.MotionSmoother("smalliphone", device=dev)
    calls = {f"detect_balls_in_frames {len(balls)}": lambda: pretrained.detect_balls_in_frames(balls, device=dev),
             f"pose_landmarks_in_frames {len(bodies)}": lambda: pretrained.pose_landmarks_in_frames(bodies,
                                                                                                  device=dev),
             f"fuse_pose_sequence {len(lml)}": lambda: track.fusion.fuse_pose_sequence(
                 lml, lmr, calib_arrays, conf_threshold=0.5, device=dev),
             f"smooth_pose_sequence {len(poses)}": lambda: smoother.smooth_pose_sequence(poses)}
    out = {}
    for name, fn in calls.items():
        fn()
        out[name] = host_ms(fn, 3) / 1e3
    ball, pose = pretrained.load_ball_detector(dev), pretrained.load_pose_net(dev)
    with torch.no_grad():
        out["detect_balls stages ms"] = split_ms([
            ("letterbox + upload", lambda _: pretrained.letterbox(balls, pretrained.BALL_IMG_HW, dev)[0]),
            ("forward", ball),
            ("decode + NMS", lambda raw: yolov8.detections_from_maps(raw, pretrained.BALL_IMG_HW, 1,
                                                                      score_threshold=0.3, max_det=8))])
        out["pose_landmarks stages ms"] = split_ms([
            ("letterbox + upload", lambda _: pretrained.letterbox(bodies, pretrained.POSE_IMG_HW, dev)[0]),
            ("forward + soft-argmax", pose),
            ("to host", lambda lm: lm.cpu())])
    print(f"ball / pose times on {card}: {json.dumps(out)}", flush=True)
    return out


# Phase 35: the trainers' defaults (models/pretrained.py) and the checks' limits.
TRAIN_BATCH = 16
TRAIN_BALL_STEPS, TRAIN_POSE_STEPS, TRAIN_CHUNK = 30, 10, 25
TRAIN_DEFAULT_STEPS = {"ball": 800, "pose": 3000}  # the schedules' lengths in the parity steps
TRAIN_LOSS_RTOL, TRAIN_STAT_REL = 1e-4, 1e-4
# Card against CPU: cuDNN's and the CPU's float32 sums in other orders (and
# algorithms), some of cuDNN's weight-gradient sums not deterministic. Every
# gradient within TRAIN_GRAD_NET of the network's largest; each leaf within
# TRAIN_GRAD_LEAF of its own largest, or of TRAIN_GRAD_FLOOR x the network's
# largest where that is more (a leaf 0 in exact arithmetic, the heatmap's
# bias, is rounding on both sides). Measured on an H100 80GB HBM3 at 700 W:
# up to 5.4e-5 and 1.3e-2 on the pose net, 1.2e-6 and 9.5e-6 on the ball
# detector.
TRAIN_GRAD_NET, TRAIN_GRAD_LEAF, TRAIN_GRAD_FLOOR = 2e-4, 5e-2, 1e-3
# Adam divides each gradient by its own root mean square, so an element whose
# gradient is near 0 may step the other way on the other device.
TRAIN_PARAM_LRS = 4.0


def _train_objectives():
    """(name, model factory, in-repo weights, objective, forward kwargs) of
    the two trainers (pretrained.train_ball_detector / train_pose_net)."""
    H, W = pretrained.BALL_IMG_HW
    return [("ball", pretrained._ball_model, pretrained.BALL_WEIGHTS,
             lambda raw, b, c, v: yolov8.detection_loss(raw, b, c, v, (H, W), 1), {}),
            ("pose", pretrained._pose_model, pretrained.POSE_WEIGHTS,
             lambda out, gt: pose.pose_loss_full(out[0], out[1], gt), {"return_heatmap": True})]


def train_parity(dev, name, make, weights, objective, kw, batch) -> dict:
    """Two steps of a trainer's step function from the in-repo weights on
    the card and on the CPU, the same batch; the loss, every gradient leaf,
    the running statistics and the parameters held card against CPU."""
    nets = {d: convert.load_tree(weights, make()).to(d) for d in (dev, "cpu")}
    steps = {d: pretrained._make_bn_train_step(m, objective, pretrained.adamw_warmup_cosine(
        m.parameters(), TRAIN_DEFAULT_STEPS[name]), kw) for d, m in nets.items()}
    start = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    out = {"loss_rel": [], "grad_net": [], "grad_leaf": [], "stat_frac": []}
    for i in range(2):
        loss = {d: float(steps[d](*(a.to(d) for a in batch))) for d in nets}
        rel = abs(loss[dev] - loss["cpu"]) / abs(loss["cpu"])
        grads = {d: {k: p.grad for k, p in m.named_parameters()} for d, m in nets.items()}
        top = max(float(g.abs().max()) for g in grads["cpu"].values())
        net = leaf = 0.0
        for k, g in grads["cpu"].items():
            err = float((grads[dev][k].cpu() - g).abs().max())
            net = max(net, err / top)
            leaf = max(leaf, err / max(float(g.abs().max()), TRAIN_GRAD_FLOOR * top))
        stats = {d: dict(m.named_buffers()) for d, m in nets.items()}
        stat = max(float((stats[dev][k].cpu() - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                   for k, v in stats["cpu"].items())
        out["loss_rel"].append(rel)
        out["grad_net"].append(net)
        out["grad_leaf"].append(leaf)
        out["stat_frac"].append(stat)
        if rel > TRAIN_LOSS_RTOL or net > TRAIN_GRAD_NET or leaf > TRAIN_GRAD_LEAF or stat > TRAIN_STAT_REL:
            raise AssertionError(f"{name} step {i + 1} card against CPU: loss {rel:.2e}, gradients {net:.2e} of the "
                                 f"largest, {leaf:.2e} of their leaf's, running statistics {stat:.2e}")
        if i == 0:
            for d, m in nets.items():
                for k, p in m.named_parameters():
                    if not torch.equal(p.detach().cpu(), start[k]):
                        raise AssertionError(f"{name}: step 1 (lr 0) moved {k} on {d}")
    lr = pretrained.warmup_cosine_lr(1, min(50, max(TRAIN_DEFAULT_STEPS[name] // 10, 1)),
                                     TRAIN_DEFAULT_STEPS[name], 2e-3)
    params = {d: dict(m.named_parameters()) for d, m in nets.items()}
    apart = max(float((params[dev][k].detach().cpu() - p.detach()).abs().max()) for k, p in params["cpu"].items())
    moved = max(float((p.detach() - start[k]).abs().max()) for k, p in params["cpu"].items())
    if apart > TRAIN_PARAM_LRS * lr or moved == 0.0:
        raise AssertionError(f"{name}: parameters after step 2 {apart:.2e} apart (lr {lr:.1e}), moved {moved:.2e}")
    out.update(step2_lr=lr, params_apart=apart, params_moved=moved)
    return out


def train_stage_ms(dev, make, weights, objective, kw, batch, reps: int = 5) -> dict:
    """CUDA-event ms of one training step split into forward + loss,
    backward and the optimizer (AdamW + the schedule), the mean of ``reps``
    steps after a warm-up, on the in-repo weights."""
    model = convert.load_tree(weights, make()).to(dev).train()
    opt, sched = pretrained.adamw_warmup_cosine(model.parameters(), 800)
    x, *targets = (a.to(dev) for a in batch)
    names = ("forward + loss", "backward", "optimizer")
    out = dict.fromkeys(names, 0.0)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        with layers.fp32_forward():
            loss = objective(model(x, **kw), *targets)
            ev[1].record()
            loss.backward()
            ev[2].record()
        opt.step()
        sched.step()
        ev[3].record()
        torch.cuda.synchronize()
        if rep:
            for i, n in enumerate(names):
                out[n] += ev[i].elapsed_time(ev[i + 1]) / reps
    out["step"] = sum(out[n] for n in names)
    return out


def phase_train(dev, card: str) -> dict:
    """Phase 35: both trainers on the card: parity with the CPU on two steps
    from the in-repo weights, training from flax's initialisation, the saved
    weights read back, times. The trainers share one render pool, spawned as
    the phase starts so that its processes start (10-11 s on the card's
    host) while the parity checks run; each trainer would spawn its own."""
    with render_pool() as pool:
        for _ in range(os.cpu_count() or 1):
            pool.submit(int, 0)
        saved = pretrained._renderers
        pretrained._renderers = lambda _dev: contextlib.nullcontext(pool)
        try:
            return _train_phase(dev, card)
        finally:
            pretrained._renderers = saved


def _train_phase(dev, card: str) -> dict:
    out = {}
    rng = np.random.default_rng(35)
    t0 = time.perf_counter()
    ball = ball_training_batch(rng, TRAIN_BATCH, *pretrained.BALL_IMG_HW)
    ball_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    im, gt = pose_training_batch(rng, TRAIN_BATCH, *pretrained.POSE_IMG_HW)
    pose_ms = (time.perf_counter() - t0) * 1e3
    u8 = torch.from_numpy(np.round(im * 255.0).astype(np.uint8))  # as train_pose_net uploads it
    batches = {"ball": [torch.from_numpy(a) for a in ball],
               "pose": [u8.to(torch.float32) / torch.tensor(255.0), torch.from_numpy(gt)]}
    render_ms = {"ball": ball_ms, "pose": pose_ms}
    trainers = {"ball": (pretrained.train_ball_detector, TRAIN_BALL_STEPS, {}),
                "pose": (pretrained.train_pose_net, TRAIN_POSE_STEPS, {"scan_chunk": TRAIN_CHUNK})}
    for name, make, weights, objective, kw in _train_objectives():
        parity = train_parity(dev, name, make, weights, objective, kw, batches[name])
        stages = train_stage_ms(dev, make, weights, objective, kw, batches[name])
        train, steps, extra = trainers[name]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}.npz")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train(steps=steps, batch=TRAIN_BATCH, seed=0, out_path=path, log_every=steps, device=dev, **extra)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            model = res["model"]
            losses = np.asarray(res["losses"])
            tenth = max(steps // 10, 1)
            first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
            if not np.isfinite(losses).all() or not last < first:
                raise AssertionError(f"{name}: the loss did not fall ({first:.4f} in the first tenth, {last:.4f} "
                                     f"in the last)")
            back = convert.load_tree(path, make()).to(dev).eval()
            with np.load(path) as z, np.load(weights) as ref:
                shapes = [z[f"arr_{i}"].shape for i in range(len(z.files))]
                if shapes != [ref[f"arr_{i}"].shape for i in range(len(ref.files))]:
                    raise AssertionError(f"{name}: the saved npz's arrays differ from the in-repo npz's")
        x = batches[name][0][:4].to(dev)
        with torch.no_grad():
            a, b = model(x, **kw), back(x, **kw)
        a, b = (list(t) if isinstance(t, (list, tuple)) else [t] for t in (a, b))
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{name}: the weights read back do not give the trained model's forward")
        out[name] = dict(parity=parity, stages_ms=stages, render_ms=render_ms[name], steps=steps,
                         train_s=train_s, steps_per_s=steps / train_s, images_per_s=steps * TRAIN_BATCH / train_s,
                         loss_first_tenth=first, loss_last_tenth=last, final_loss=res["final_loss"],
                         leaves=len(shapes))
        print(f"train {name} on {card}: parity loss {max(parity['loss_rel']):.1e}, gradients "
              f"{max(parity['grad_net']):.1e} of the largest ({max(parity['grad_leaf']):.1e} of their leaf's), "
              f"statistics {max(parity['stat_frac']):.1e}, "
              f"parameters after step 2 {parity['params_apart']:.1e} apart (lr {parity['step2_lr']:.0e}); "
              f"{steps} steps from flax's init in {train_s:.2f} s ({steps / train_s:.2f} steps/s, "
              f"{steps * TRAIN_BATCH / train_s:.1f} images/s), loss {first:.4f} -> {last:.4f}; step ms "
              f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; render {render_ms[name]:.1f} ms a batch",
              flush=True)
    return out


# Phase 36: several devices. The row-band SGM on MESH_S bands of MESH_F
# frames of exact8's shape; the data-parallel pipeline at each main path's
# frames a device (exact8 4, hier16x3 8, bm1080 8) on MESH_SHAPES; the
# processor on 2x1; PoseNet w32's training step (256x256, batch 16) on 2x2.
MESH_S, MESH_F = 4, 2
MESH_SHAPES = ((2, 1), (4, 1))
MESH_PIPELINES = {"exact8": ("sgbm", PARAMS, B, H, W), "hier16x3": ("sgbm_hier", P3, H16_P, H, W),
                  "bm1080": ("bm", BM_PARAMS, BM_B, BM_H, BM_W)}
MESH_WINDOWS = 3  # hier16x3 windows through the processor on 2x1
MESH_TRAIN_MESH, MESH_TRAIN_BATCH, MESH_TRAIN_HW, MESH_TRAIN_STEPS = (2, 2), 16, (256, 256), 2
# Two Adam steps on 2x2 against 1x1: the losses within rtol 1e-5 (cuDNN may
# pick other algorithms at 8 images than at 16), the parameters within 1e-4
# of the largest.
MESH_LOSS_RTOL, MESH_PARAM_FRAC = 1e-5, 1e-4


def mesh_frames(n: int, h: int, w: int, cache: dict) -> tuple[np.ndarray, np.ndarray]:
    """n distinct uint8 (left, right) frames of the ramp+box scene: eight
    seeds, each further group of eight rolled along the rows (both views
    alike, so every share of a mesh sees other frames)."""
    if (h, w) not in cache:
        cache[(h, w)] = [scene(seed=s, H=h, W=w) for s in range(8)]
    base = cache[(h, w)]
    views = [[np.roll(base[i % 8][v], 7 * (i // 8), axis=0) for i in range(n)] for v in (0, 1)]
    return tuple(np.stack(v).astype(np.uint8) for v in views)


def mesh_sgm(dev, make_mesh) -> dict:
    """sgm_aggregate_sharded (8 and 4 paths) against aggregate_8 and
    stereo_sgbm_sharded against stereo_sgbm, bit for bit, with host-clock ms
    beside the same call on a 1x1 mesh, band-ticks run and the kernels'
    launches in the sharded SGBM."""
    out = {}
    bands, one = make_mesh(1, MESH_S), create_mesh(1, 1, devices=[dev])
    frames = [scene(seed=s, H=H, W=W) for s in range(MESH_F)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    C = cost_cuda.cost_volume(lt, rt, ndisp=D, block_size=PARAMS.block_size, ftzero=PARAMS.ftzero, x_offset=D,
                              dtype=torch.int32)
    for num_paths in (8, 4):
        ref = sgm_cuda.aggregate_8(C, PARAMS.P1, PARAMS.P2, num_paths, cost_bound=PARAMS.cost_bound)
        ms, ticks = {}, {}
        for name, mesh in (("sharded", bands), ("1x1", one)):
            t0, n = time.perf_counter(), sgm_sharded.aggregate_bands.band_ticks
            got = sgm_sharded.sgm_aggregate_sharded(C, PARAMS.P1, PARAMS.P2, mesh, num_paths=num_paths)
            torch.cuda.synchronize()
            ms[name], ticks[name] = (time.perf_counter() - t0) * 1e3, sgm_sharded.aggregate_bands.band_ticks - n
            if got.shape != ref.shape or not torch.equal(got, ref):
                raise AssertionError(f"sgm_aggregate_sharded ({name}, {num_paths} paths) differs from aggregate_8")
            del got
        ms["aggregate_8"] = host_ms(lambda: sgm_cuda.aggregate_8(C, PARAMS.P1, PARAMS.P2, num_paths,
                                                                  cost_bound=PARAMS.cost_bound), reps=1)
        out[f"sgm_aggregate_sharded {num_paths} paths"] = dict(ms=ms, band_ticks=ticks)
        del ref
        torch.cuda.empty_cache()
    del C
    kernels = {"horizontal": sgm_cuda.horizontal, "wta_stats": sgm_cuda.wta_stats, "lr_fail": lr_cuda.lr_fail,
               "speckle_filter": speckle_cuda.speckle_filter}
    ref = stereo_sgbm(lt, rt, PARAMS)
    ms, ticks = {}, {}
    for name, mesh in (("sharded", bands), ("1x1", one)):
        for k in kernels.values():
            k.launches = 0
        t0, n = time.perf_counter(), sgm_sharded.aggregate_bands.band_ticks
        got = sgm_sharded.stereo_sgbm_sharded(lt, rt, PARAMS, mesh)
        torch.cuda.synchronize()
        ms[name], ticks[name] = (time.perf_counter() - t0) * 1e3, sgm_sharded.aggregate_bands.band_ticks - n
        launches = {k: fn.launches for k, fn in kernels.items()}
        if name == "sharded":
            want = {"horizontal": 2 * MESH_F * MESH_S, "wta_stats": MESH_S, "lr_fail": MESH_S, "speckle_filter": 1}
            if launches != want:
                raise AssertionError(f"stereo_sgbm_sharded launched {launches}, expected {want}")
            out["stereo_sgbm_sharded launches"] = launches
        if not torch.equal(got, ref):
            raise AssertionError(f"stereo_sgbm_sharded ({name}) differs from stereo_sgbm")
    ms["stereo_sgbm"] = host_ms(lambda: stereo_sgbm(lt, rt, PARAMS), reps=1)
    out["stereo_sgbm_sharded"] = dict(ms=ms, band_ticks=ticks, valid_share=float((ref > -1).float().mean()))
    return out


def mesh_pipelines(dev, make_mesh, cache: dict) -> dict:
    """make_sharded_pipeline at each main path's frames a device on 2x1 and
    4x1, each share against batched_stereo_pipeline on its frames; host
    ms of the sharded call and of the same shares through a 1x1 mesh's
    closure one after another."""
    out = {}
    one = create_mesh(1, 1, devices=[dev])
    for path, (matcher, params, per, h, w) in MESH_PIPELINES.items():
        maps, Q = rig(h, w)
        run1 = make_sharded_pipeline(one, maps, Q, matcher, params)
        for n_data, n_space in MESH_SHAPES:
            n = per * n_data
            left, right = mesh_frames(n, h, w, cache)
            run = make_sharded_pipeline(make_mesh(n_data, n_space), maps, Q, matcher, params)
            disp, pts = run(left, right)
            for i in range(n_data):
                s = slice(i * per, (i + 1) * per)
                rd, rp = batched_stereo_pipeline(left[s], right[s], maps, Q, matcher, params, device=dev)
                if not torch.equal(disp[s], rd) or not torch.allclose(pts[s], rp, rtol=1e-6, atol=0, equal_nan=True):
                    raise AssertionError(f"{path} on {n_data}x{n_space}: share {i} differs from the batched pipeline")
            del disp, pts, rd, rp
            ms = {"sharded": host_ms(lambda: run(left, right)),
                  "1x1, share by share": host_ms(lambda: [run1(left[i * per:(i + 1) * per],
                                                               right[i * per:(i + 1) * per]) for i in range(n_data)])}
            out[f"{path} {n_data}x{n_space}"] = dict(frames=n, ms=ms)
            del run
            torch.cuda.empty_cache()
    return out


def mesh_processor(dev, make_mesh, cache: dict) -> dict:
    """StereoStreamProcessor on 2x1: MESH_WINDOWS hier16x3 windows of 2 x 8
    frames submitted, the drained last window against the batched pipeline
    of each share."""
    maps, Q = rig(H, W)
    proc = StereoStreamProcessor(make_mesh(2, 1), maps, Q, "sgbm_hier", P3)
    frames = mesh_frames(2 * H16_P * MESH_WINDOWS, H, W, cache)
    windows = [tuple(v[k * 2 * H16_P:(k + 1) * 2 * H16_P] for v in frames) for k in range(MESH_WINDOWS)]
    t0 = time.perf_counter()
    for wl, wr in windows:
        proc.submit(wl, wr)
    disp, pts = proc.drain()
    ms = (time.perf_counter() - t0) * 1e3
    wl, wr = windows[-1]
    for i in range(2):
        s = slice(i * H16_P, (i + 1) * H16_P)
        rd, rp = batched_stereo_pipeline(wl[s], wr[s], maps, Q, "sgbm_hier", P3, device=dev)
        if not np.array_equal(disp[s], rd.cpu().numpy()) or not np.allclose(pts[s], rp.cpu().numpy(), rtol=1e-6,
                                                                            atol=0, equal_nan=True):
            raise AssertionError(f"the processor's last window, share {i}, differs from the batched pipeline")
    return dict(windows=MESH_WINDOWS, frames_a_window=2 * H16_P, ms_submits_and_drain=ms)


def mesh_train_steps(dev, m, x, gt, steps: int | None = None,
                     batch_stats: bool = True) -> tuple[list, dict, list, dict]:
    """``steps`` (MESH_TRAIN_STEPS) steps of PoseNet w32 (in-repo weights, eval mode, pose_loss,
    Adam 1e-3) on the mesh ``m``: the losses, the parameters whole on
    ``dev``, host ms a step, and copies of the split parameters' shards as
    the initial state holds them. Without ``batch_stats`` the variables
    hold none (the net reads its own buffers), so a 1x1 step runs without
    the step's TorchFunctionMode."""
    net = convert.load_tree(pretrained.POSE_WEIGHTS, pretrained._pose_model()).to(dev).eval()
    init, step = train_models.make_train_step(
        m, lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,)),
        lambda out, g: pose.pose_loss(out, g), lambda p: torch.optim.Adam(p, lr=1e-3))
    state = init({"params": dict(net.named_parameters()),
                  "batch_stats": dict(net.named_buffers()) if batch_stats else {}})
    split = {k: {pos: t.detach().clone() for pos, t in v.shards.items()}
             for k, v in state.params.items() if isinstance(v, ShardedTensor)}
    losses, ms = [], []
    for _ in range(steps or MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, x, gt)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
    params = {k: (v.gather(dev) if isinstance(v, ShardedTensor) else v).detach() for k, v in state.params.items()}
    return losses, params, ms, split


# The 1x1 step's host ms with the batch statistics given (the step's
# TorchFunctionMode on) and without (off), in turns, MESH_MODE_STEPS steps a
# turn, the first of each dropped; both compute the same in eval mode.
MESH_MODE_TURNS, MESH_MODE_STEPS = 3, 5


def mesh_train(dev, make_mesh) -> dict:
    """PoseNet w32's training step from the in-repo weights: MESH_TRAIN_STEPS
    steps on 2x2 (the wide Dense kernel's storage split by output rows over
    space) against the same on 1x1, cuDNN's deterministic algorithms on both
    (its other weight-gradient sums vary run to run, and Adam's first steps
    move a parameter whose gradient is near 0 by up to ~lr whatever the
    gradient's size); then the 1x1 step with and without its
    TorchFunctionMode (MESH_MODE_*)."""
    rng = np.random.default_rng(36)
    x, gt = pose_training_batch(rng, MESH_TRAIN_BATCH, *MESH_TRAIN_HW)
    mesh = make_mesh(*MESH_TRAIN_MESH)
    one_mesh = create_mesh(1, 1, devices=[dev])
    w = convert.load_tree(pretrained.POSE_WEIGHTS, pretrained._pose_model()).get_parameter("Dense_1.weight").detach()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        (l1, p1, ms1, _), (l4, p4, ms4, split) = (mesh_train_steps(dev, m, x, gt) for m in (one_mesh, mesh))
        mode_ms: dict = {"on": [], "off": []}
        mode_losses = {}
        for _ in range(MESH_MODE_TURNS):
            for key, given in (("on", True), ("off", False)):
                losses, _, ms, _ = mesh_train_steps(dev, one_mesh, x, gt, MESH_MODE_STEPS, batch_stats=given)
                mode_ms[key] += ms[1:]
                mode_losses[key] = losses
    if mode_losses["on"] != mode_losses["off"]:
        raise AssertionError(f"the 1x1 step with and without its mode: losses {mode_losses}")
    n = MESH_TRAIN_MESH[1]
    rows = w.shape[0] // n
    shards = split.get("Dense_1.weight", {})
    if list(split) != ["Dense_1.weight"] or sorted(shards) != [(0, j) for j in range(n)] or any(
            shards[(0, j)].device != mesh.devices[0, j]
            or not torch.equal(shards[(0, j)].cpu(), w[j * rows:(j + 1) * rows]) for j in range(n)):
        raise AssertionError("the split Dense kernel's shards are not its output rows on the space devices")
    rel = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
    top = max(float(v.abs().max()) for v in p1.values())
    apart = max(float((p4[k] - v).abs().max()) for k, v in p1.items())
    if rel > MESH_LOSS_RTOL or apart > MESH_PARAM_FRAC * top:
        raise AssertionError(f"the 2x2 step against 1x1: losses {rel:.2e} apart, parameters {apart:.2e} "
                             f"(largest {top:.3f})")
    return dict(losses={"1x1": l1, "2x2": l4}, loss_rel=rel, params_apart=apart, params_largest=top,
                step_ms={"1x1": ms1, "2x2": ms4},
                mode_step_ms={k: dict(median=float(np.median(v)), all=v) for k, v in mode_ms.items()})


# ROADMAP C.9 on the card: a forward pass that reads batch statistics (a
# batch norm in training form) takes the whole batch's on every mesh. PoseNet
# w32 (in-repo weights) in train() mode at 128x128, batch 8, and torch's
# Linear -> BatchNorm1d -> Linear, MESH_BN_STEPS SGD steps at lr 0 (the
# gradients stay to be read) on 1x1, 2x1 and 2x2; cuDNN's deterministic
# algorithms; the loss within rtol 1e-5 of the 1x1 step's, each gradient
# within 1e-5 of its leaf's largest (+ 1e-6), the batch statistics unmoved;
# host ms a step (on several data devices the first step probes).
MESH_BN_MESHES, MESH_BN_BATCH, MESH_BN_HW, MESH_BN_STEPS = ((2, 1), (2, 2)), 8, (128, 128), 3
MESH_BN_RTOL, MESH_BN_GRAD_FRAC, MESH_BN_ATOL = 1e-5, 1e-5, 1e-6


def mesh_bn_grads(dev, m, net, x, gt, loss_fn) -> tuple[float, dict, list]:
    """MESH_BN_STEPS steps at lr 0 of ``net`` (train() mode) on the mesh
    ``m``: the last loss, every parameter's gradient whole on ``dev``, and
    host ms a step; the batch statistics must not move."""
    init, step = train_models.make_train_step(
        m, lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,)), loss_fn,
        lambda p: torch.optim.SGD(p, lr=0.0))
    state = init({"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())})
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    ms = []
    for _ in range(MESH_BN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, x, gt)
        loss = loss.item()
        ms.append((time.perf_counter() - t0) * 1e3)
    if any(not torch.equal(v, before[k]) for k, v in state.batch_stats.items()):
        raise AssertionError("the training step moved the batch statistics")
    grads = {k: (torch.cat([p.shards[pos].grad.to(dev) for pos in sorted(p.shards)]) if isinstance(p, ShardedTensor)
                 else p.grad.to(dev)) for k, p in state.params.items()}
    return loss, grads, ms


def mesh_train_bn(dev, make_mesh) -> dict:
    """ROADMAP C.9's repair on the card (see MESH_BN_*)."""
    rng = np.random.default_rng(37)
    x, gt = pose_training_batch(rng, MESH_BN_BATCH, *MESH_BN_HW)
    pose_net = convert.load_tree(pretrained.POSE_WEIGHTS, pretrained._pose_model()).to(dev).train()
    torch.manual_seed(0)
    small = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.BatchNorm1d(8), torch.nn.Linear(8, 1)).to(dev).train()
    xs = (torch.randn(8, 4) * torch.arange(1, 9)[:, None]).numpy()
    ys = torch.randn(8).numpy()
    cases = {"PoseNet w32": (pose_net, x, gt, lambda out, g: pose.pose_loss(out, g)),
             "Linear-BatchNorm1d-Linear": (small, xs, ys, lambda out, t: ((out[:, 0] - t) ** 2).mean())}
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for name, (net, a, b, loss_fn) in cases.items():
            one_loss, one, one_ms = mesh_bn_grads(dev, create_mesh(1, 1, devices=[dev]), net, a, b, loss_fn)
            r = {"1x1 loss": one_loss, "1x1 step_ms": one_ms}
            for shape in MESH_BN_MESHES:
                loss, grads, ms = mesh_bn_grads(dev, make_mesh(*shape), net, a, b, loss_fn)
                apart = max(float((grads[k] - g).abs().max() / (g.abs().max() * MESH_BN_GRAD_FRAC + MESH_BN_ATOL))
                            for k, g in one.items())
                rel = abs(loss - one_loss) / abs(one_loss)
                if rel > MESH_BN_RTOL or apart > 1.0:
                    raise AssertionError(f"{name} in train() mode on {shape} against 1x1: loss {rel:.2e} apart, "
                                         f"gradients {apart:.2f} of their limit")
                r[f"{shape[0]}x{shape[1]}"] = dict(loss=loss, loss_rel=rel, grads_of_limit=apart, step_ms=ms)
            out[name] = r
    return out


def phase_mesh(dev, card: str) -> dict:
    """Phase 36: several devices, on a mesh of logical shards of the card and,
    where the machine has two cards or more, again on distinct cards."""
    count = torch.cuda.device_count()
    layouts = {"logical shards of one card": lambda n: [dev] * n}
    if count >= 2:
        layouts["distinct cards"] = lambda n: [torch.device("cuda", k % count) for k in range(n)]
    print(f"phase 36 on {card}: {count} CUDA device(s); meshes of {' and of '.join(layouts)} (frame and row "
          f"parallelism across distinct cards is {'timed too' if count >= 2 else 'not timed: one card'})", flush=True)
    out, cache = {"device_count": count}, {}
    for layout, devices in layouts.items():
        make_mesh = lambda n_data, n_space, devices=devices: create_mesh(n_data, n_space,  # noqa: E731
                                                                         devices=devices(n_data * n_space))
        r = {"sgm": mesh_sgm(dev, make_mesh)}
        torch.cuda.empty_cache()
        for k, v in r["sgm"].items():
            what = "launches" if "launches" in k else "bit-equal to the one-device call; host ms and band-ticks"
            print(f"mesh ({layout}) {k}: {what} {json.dumps(v)}", flush=True)
        r["pipelines"] = mesh_pipelines(dev, make_mesh, cache)
        for k, v in r["pipelines"].items():
            print(f"mesh ({layout}) make_sharded_pipeline {k}: every share equal to batched_stereo_pipeline; "
                  f"host ms {json.dumps({a: round(b, 3) for a, b in v['ms'].items()})}", flush=True)
        r["processor"] = mesh_processor(dev, make_mesh, cache)
        print(f"mesh ({layout}) StereoStreamProcessor 2x1: the last of {MESH_WINDOWS} hier16x3 windows equal to the "
              f"batched pipeline; {r['processor']['ms_submits_and_drain']:.1f} ms for the submits and the drain",
              flush=True)
        torch.cuda.empty_cache()
        r["train"] = mesh_train(dev, make_mesh)
        t = r["train"]
        print(f"mesh ({layout}) make_train_step PoseNet w32 2x2 against 1x1 on {card}: losses {t['losses']} "
              f"({t['loss_rel']:.1e} apart), parameters {t['params_apart']:.1e} apart (largest "
              f"{t['params_largest']:.3f}); step host ms {json.dumps(t['step_ms'])}; 1x1 step host ms with its "
              f"TorchFunctionMode and without, in turns: {json.dumps(t['mode_step_ms'])}", flush=True)
        r["train_bn"] = mesh_train_bn(dev, make_mesh)
        print(f"mesh ({layout}) make_train_step in train() mode (batch statistics of the whole batch, ROADMAP C.9) "
              f"2x1 and 2x2 against 1x1 on {card}: {json.dumps(r['train_bn'])}", flush=True)
        out[layout] = r
        torch.cuda.empty_cache()
    return out


# Phase 37: two video files streamed on the card (stream_video_pair), written
# by the port's writer as raw AVI: the stream CLI's default matcher, sgbm_hier
# at window 32 (hier4x3, p3), at 1280x720 on 67 RGBA frames a camera (windows
# of 32, 32 and 3), and BASELINE config #5's BM at window 8 at 1920x1080 on 19
# Y800 frames (8, 8 and 3); the parallel rig's maps. The bench scene, seeds 0-7
# repeated along a stream; the colour stream's channels tinted apart
# (VIDEO_TINT added to R, G, B) so that the ring's 8.8 pack does real work.
VIDEO_STREAMS = {"sgbm_hier": dict(params=P3, window=HIER_P, frames=67, h=H, w=W, fourcc="RGBA"),
                 "bm": dict(params=BM_PARAMS, window=BM_B, frames=19, h=BM_H, w=BM_W, fourcc="Y800")}
VIDEO_SEEDS, VIDEO_TINT = 8, (0, 8, -8)


def decoder_findings() -> dict:
    """What this machine could decode video with, found without importing
    any of it: the ffmpeg / ffprobe programs, the av, cv2 and torchvision
    modules, and NVDEC's library (libnvcuvid)."""
    return {"ffmpeg": shutil.which("ffmpeg"), "ffprobe": shutil.which("ffprobe"),
            **{f"module {m}": importlib.util.find_spec(m) is not None for m in ("av", "cv2", "torchvision")},
            "libnvcuvid": ctypes.util.find_library("nvcuvid"), "libavcodec": ctypes.util.find_library("avcodec")}


def video_pair(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """A stream's (left, right) frames: (T, h, w, 3) RGB or (T, h, w) gray uint8."""
    scenes = [scene(seed=s, H=spec["h"], W=spec["w"]) for s in range(VIDEO_SEEDS)]
    out = []
    for i in (0, 1):
        g = np.stack([scenes[t % VIDEO_SEEDS][i] for t in range(spec["frames"])]).astype(np.int16)
        if spec["fourcc"] == "RGBA":
            g = np.stack([g + k for k in VIDEO_TINT], axis=-1)
        out.append(np.clip(g, 0, 255).astype(np.uint8))
    return out[0], out[1]


def video_stream(dev, mesh, matcher: str, spec: dict, tmp: str) -> dict:
    """One stream of phase 37: write the pair, check its decode, then
    stream_video_pair three times (full output timed, stats_only timed,
    full output kept and checked, each with the path's kernel counts set to
    0 before it and read after it), decode + pack alone and the pipeline
    alone; every window held bit for bit to batched_stereo_pipeline on the
    same gray frames."""
    params, window, n = spec["params"], spec["window"], spec["frames"]
    left, right = video_pair(spec)
    paths = [os.path.join(tmp, f"{matcher}_{side}.avi") for side in ("left", "right")]
    t0 = time.perf_counter()
    for path, frames in zip(paths, (left, right)):
        io_video.write_video(path, frames, fps=30.0)
    write_s = time.perf_counter() - t0
    rgb = left.ndim == 4
    for path, frames in zip(paths, (left, right)):  # the decoded frames are the frames written
        got = 0
        for idx, f in io_video.iter_frames(path, grayscale=not rgb):
            if not np.array_equal(f, frames[idx]):
                raise AssertionError(f"{path}: frame {idx} decodes to other pixels than were written")
            got += 1
        if got != n:
            raise AssertionError(f"{path}: {got} frames decoded, {n} written")
    gl, gr = (native.pack_gray(f) if rgb else f for f in (left, right))  # what the frame ring hands on
    del left, right
    maps, Q = parallel_rig(spec["h"], spec["w"], dev)
    kernels = STREAM_KERNELS[matcher]
    n_windows = -(-n // window)
    windows = [np.minimum(np.arange(k * window, (k + 1) * window), n - 1) for k in range(n_windows)]

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    zero()
    ref = [batched_stereo_pipeline(gl[i], gr[i], maps, Q, matcher, params, device=dev) for i in windows[:1]]
    torch.cuda.synchronize()
    per_call = counts()

    def stream(stats_only: bool, keep: bool):
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_first, n_first, frames, kept = None, 0, 0, []
        for item in stream_video_pair(*paths, mesh, maps, Q, matcher, params, window=window,
                                      stats_only=stats_only):
            frames += item[3]
            if keep:
                kept.append(item)
            if t_first is None:
                t_first, n_first = time.perf_counter(), frames
        t_end = time.perf_counter()
        c = counts()
        if c != {k: v * n_windows for k, v in per_call.items()} or min(c.values()) == 0:
            raise AssertionError(f"{matcher} stream launches {c} in {n_windows} windows, "
                                 f"batched_stereo_pipeline's {per_call} a call")
        if frames != n:
            raise AssertionError(f"{matcher} stream returned {frames} frames of {n}")
        return kept, dict(s=t_end - t0, fps=frames / (t_end - t0),
                          fps_steady=(frames - n_first) / (t_end - t_first) if frames > n_first else None)

    _, full = stream(False, keep=False)
    stats, stats_t = stream(True, keep=True)
    kept, _ = stream(False, keep=True)
    for k, ((seq, disp, pts, n_valid), (sseq, st, none, sn), idx) in enumerate(zip(kept, stats, windows)):
        nv = min(window, n - k * window)  # the tail window repeats its last frame
        if (seq, n_valid, sseq, sn, none) != (k, nv, k, nv, None):
            raise AssertionError(f"{matcher} window {k}: seq / n_valid {(seq, n_valid, sseq, sn)}")
        d, p = batched_stereo_pipeline(gl[idx], gr[idx], maps, Q, matcher, params, device=dev)
        if not (np.array_equal(disp, d.cpu().numpy()) and np.array_equal(pts, p.cpu().numpy(), equal_nan=True)):
            raise AssertionError(f"{matcher} window {seq} differs from batched_stereo_pipeline's")
        if not np.array_equal(st, streaming._frame_stats(d, p).cpu().numpy(), equal_nan=True):
            raise AssertionError(f"{matcher} window {seq}: stats_only differs from _frame_stats")
    if len(kept) != n_windows or len(stats) != n_windows:
        raise AssertionError(f"{matcher}: {len(kept)} / {len(stats)} windows, {n_windows} expected")
    min_x = D if matcher == "sgbm_hier" else BM_PARAMS.num_disparities
    valid_share, within1 = quality(kept[0][1], scene_truth(spec["h"], spec["w"]), min_x)
    del kept, ref
    t0 = time.perf_counter()
    decoded = sum(nv for *_, nv in StereoPairLoader(*paths, window))
    decode_fps = decoded / (time.perf_counter() - t0)
    run = make_sharded_pipeline(mesh, maps, Q, matcher, params)
    lt, rt = (torch.from_numpy(g[windows[0]]).to(dev) for g in (gl, gr))
    pipeline_ms = host_ms(lambda: run(lt, rt))
    torch.cuda.empty_cache()
    return dict(frames=n, window=window, size=[spec["w"], spec["h"]], fourcc=spec["fourcc"],
                launches_per_window=per_call, write_s=write_s, full=full, stats_only=stats_t,
                decode_pack_fps=decode_fps, pipeline_ms_per_window=pipeline_ms, valid_share=valid_share,
                within1_share=within1)


def phase_video(dev, card: str) -> dict:
    """Phase 37: two video files to disparity and 3D on the card through
    stream_video_pair, with the native frame ring and gray pack (a failed
    g++ build fails the phase)."""
    findings = decoder_findings()
    print(f"phase 37 decoders on this machine: {json.dumps(findings)}", flush=True)
    if not (native.native_available("host_ops") and native.native_available("frame_ring")):
        raise AssertionError("the native host runtime (host_ops, frame_ring) did not build")
    if FrameRing(1, (1,))._mod is None:
        raise AssertionError("the frame ring is not the native one")
    out = {"decoders": findings}
    mesh = create_mesh(devices=[dev])
    with tempfile.TemporaryDirectory() as tmp:
        for matcher, spec in VIDEO_STREAMS.items():
            r = video_stream(dev, mesh, matcher, spec, tmp)
            out[matcher] = r
            print(f"video stream {matcher} ({r['frames']} {r['fourcc']} frames of {r['size'][0]}x{r['size'][1]} a "
                  f"camera, windows of {r['window']}) on {card}: decoded == written, every window == "
                  f"batched_stereo_pipeline and stats_only == _frame_stats, launches a window "
                  f"{json.dumps(r['launches_per_window'])}, native ring and pack; frames/s end to end "
                  f"{r['full']['fps']:.2f} (steady {r['full']['fps_steady']:.2f}) full output, "
                  f"{r['stats_only']['fps']:.2f} (steady {r['stats_only']['fps_steady']:.2f}) stats_only; "
                  f"decode + pack alone {r['decode_pack_fps']:.2f} frames/s; the pipeline alone "
                  f"{r['pipeline_ms_per_window']:.3f} ms a window; valid share {r['valid_share']:.4f}, within "
                  f"1 px {r['within1_share']:.4f}; written in {r['write_s']:.2f} s", flush=True)
    return out


# Phase 38: the CLI on the card (pipeline.cli.main, in process, its default
# --device cuda) through one test directory: intrinsic -> extrinsic -> rectify
# on raw AVI board videos of phase 33's 1920x1080 rig (the CLI's default 7x4
# board of 100 mm squares, CLI_VIEWS views a camera); sync on a 1280x720 pair
# whose flash the command's sampling (every 15th frame, as the reference's)
# sees one sampled frame apart; stream on it for each matcher at phase 37's
# sizes (sgbm_hier window 32 and sgbm window 8 at 1280x720, bm window 8 at
# 1920x1080; D = 128, the default) and disparity (D = 64, the default) on a
# 1280x720 PNG pair; then validate-distance, ball-drop and pose on short
# renders and smooth, animate, measure and analyze on what they wrote. Each
# output is held to the same library calls made directly on the card.
CLI_VIEWS = 12
CLI_SYNC_FRAMES, CLI_FLASH, CLI_LAG = 96, 75, 15
# The windows are the command's defaults (one card): 32 for sgbm_hier, 8 else.
CLI_STREAMS = {"sgbm_hier": dict(window=32, frames=64, h=H, w=W), "sgbm": dict(window=8, frames=16, h=H, w=W),
               "bm": dict(window=8, frames=16, h=BM_H, w=BM_W)}
CLI_BALL_FRAMES, CLI_POSE_FRAMES = 16, 8


def cli_run(dev, tmp: str, seconds: dict, name: str, *argv) -> tuple[int, list[dict]]:
    """``pipeline.cli.main(argv)`` in process, on ``dev`` (the CLI's own
    default, ``--device cuda``, on the card): its exit code and JSON lines;
    its host seconds under ``name``."""
    from stereo_vision_tpu_torch.pipeline import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv] if dev.type == "cuda" else [*argv, "--device", dev.type])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    if rc != 0:
        raise AssertionError(f"cli {name} exited {rc}: {lines}")
    return rc, lines


def counted_launches(kernels: dict, fn):
    """``fn()`` with the kernels' launch counts set to 0 before it and read
    after it."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def same_launches(what: str, got: dict, ref: dict) -> None:
    """The CLI's launches equal the library call's, and some kernel of the
    path launched (which of the LR check and the speckle filter run is the
    command's parameters' business)."""
    if got != ref or not any(got.values()):
        raise AssertionError(f"{what}: the CLI launched {got}, the library call {ref}")


def cli_calibrate(dev, tmp: str, seconds: dict) -> dict:
    """intrinsic -> extrinsic -> rectify, each held to the library on the card."""
    from stereo_vision_tpu_torch.pipeline import ArtifactStore

    obj, c1, c2, p1, p2 = board_views(CLI_VIEWS, 38, DET_K, np.zeros(5), (DET_W, DET_H), DET_K, np.zeros(5),
                                      np.eye(3), DET_T, cols=DET_BOARD[0], rows=DET_BOARD[1], square=DET_SQUARE,
                                      noise=0.0, margin=150.0, depth=(1800.0, 3500.0), return_poses=True)
    views = [np.stack([render_board_view(DET_K, p[0][i], p[1][i], (DET_W, DET_H), *DET_BOARD, DET_SQUARE,
                                         device=dev)[0] for i in range(CLI_VIEWS)]) for p in (p1, p2)]
    os.makedirs(os.path.join(tmp, "videos"))
    for stage in ("intrinsic", "extrinsic"):
        for side, frames in zip(("left", "right"), views):
            io_video.write_video(os.path.join(tmp, "videos", f"{side}_{stage}.avi"), frames)
    sampling = ["--start-frame", "0", "--frame-interval", "1", "--max-frames", str(CLI_VIEWS)]
    _, intr = cli_run(dev, tmp, seconds, "intrinsic", "intrinsic", "--test-dir", tmp, *sampling)
    _, (extr,) = cli_run(dev, tmp, seconds, "extrinsic", "extrinsic", "--test-dir", tmp, *sampling)
    _, (rect,) = cli_run(dev, tmp, seconds, "rectify", "rectify", "--test-dir", tmp, "--size", f"{DET_W}x{DET_H}")
    store = ArtifactStore(tmp)
    found = []
    for frames in views:
        det = [detect.find_chessboard_corners(f, DET_BOARD, device=dev) for f in frames]
        found.append({i: c for i, (ok, c) in enumerate(det) if ok})
    objp = calib.checkerboard_object_points(*DET_BOARD, DET_SQUARE, device=dev)
    out = {}
    cams = []
    for name, f, line in zip(("left", "right"), found, intr):
        cam = calib.calibrate_camera(objp, np.stack(list(f.values())), (DET_W, DET_H), device=dev)
        K, dist = store.load_intrinsics(name)
        for field, a, b in (("K", K, cam.K), ("dist", dist, cam.dist)):
            if not (np.abs(a - b) <= CAL_RTOL[field] * np.abs(b) + 1e-12).all():
                raise AssertionError(f"cli intrinsic {name}: {field} {a.tolist()} against the library's {b.tolist()}")
        if abs(line["rms_px"] - cam.rms) > CAL_ATOL["rms"] or line["frames"] != len(cam.kept_frames):
            raise AssertionError(f"cli intrinsic {name}: {line} against rms {cam.rms}, {len(cam.kept_frames)} frames")
        check_truth_limits(f"cli {name}", K, line["rms_px"])
        cams.append((K, dist))
        out[f"intrinsic {name}"] = dict(rms_px=line["rms_px"], frames=line["frames"], status=line["status"])
    common = sorted(set(found[0]) & set(found[1]))
    st = calib.calibrate_stereo(objp, np.stack([found[0][i] for i in common]), np.stack([found[1][i] for i in common]),
                                *cams[0], *cams[1], (DET_W, DET_H), device=dev)
    R, T = store.load_extrinsics()
    if not (np.abs(R - st.R) <= CAL_ATOL["R"]).all() or not (np.abs(T.ravel() - st.T) <= CAL_RTOL["T"] * np.abs(
            st.T) + 1e-9).all() or abs(extr["baseline_mm"] / np.linalg.norm(DET_T) - 1) > 0.01:
        raise AssertionError(f"cli extrinsic: R {R.tolist()}, T {T.ravel().tolist()} against the library's "
                             f"{st.R.tolist()}, {st.T.tolist()}; baseline {extr['baseline_mm']}")
    out["extrinsic"] = dict(rms_px=extr["rms_px"], baseline_mm=extr["baseline_mm"], pairs=len(common))
    rig = store.load_rig()
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    res = ops.stereo_rectify(t64(rig.K1), t64(rig.d1), t64(rig.K2), t64(rig.d2), (DET_W, DET_H), t64(rig.R),
                             t64(rig.T), alpha=0.0)
    for a, b in zip(store.load_rectification(), res):
        if not np.allclose(a, b.cpu().numpy(), rtol=1e-9, atol=1e-9):
            raise AssertionError("cli rectify: the rectification differs from stereo_rectify's on the card")
    maps = np.load(store.rectify_dir / "maps.npy")
    ref = [ops.init_undistort_rectify_map(t64(K), t64(d), Rr, Pr, (DET_W, DET_H))
           for (K, d), Rr, Pr in ((cams[0], res.R1, res.P1), (cams[1], res.R2, res.P2))]
    apart = max(float(np.abs(m - r.cpu().numpy()).max()) for m, r in zip(maps, [x for pair in ref for x in pair]))
    if apart > 1e-3:
        raise AssertionError(f"cli rectify: maps {apart} px from init_undistort_rectify_map's on the card")
    out["rectify"] = dict(status=rect["status"], maps_px_apart=apart, Q_diag=rect["Q_diag"])
    return out


def cli_frames(h: int, w: int, n: int, flash: int | None, lag: int) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) gray streams: the bench scene of seed t % 8 at instant
    t, the right camera ``lag`` frames late, a flash (+80) at left frame
    ``flash`` and right frame ``flash + lag``; between them the light is
    flat, so that a flash is the one jump either sampling sees."""
    scenes = [scene(seed=s, H=h, W=w) for s in range(8)]
    out = []
    for side in (0, 1):
        frames = np.zeros((n, h, w), np.uint8)
        for j in range(n):
            t = j - (lag if side else 0)
            g = scenes[t % 8][side].astype(np.int16)
            level = np.full_like(g, 80) if flash is not None and t == flash else 0
            # every frame's mean brought to scene 0's, so that only the flash jumps
            frames[j] = np.clip(g - int(g.mean()) + int(scenes[0][side].mean()) + level, 0, 255)
        out.append(frames)
    return out[0], out[1]


def cli_sync_stream(dev, tmp: str, seconds: dict) -> dict:
    """sync, then stream for each matcher (launch counts and per-frame
    stats against stream_video_pair on the card), then disparity."""
    from stereo_vision_tpu_torch.pipeline import ArtifactStore
    from stereo_vision_tpu_torch.io.png import write_png

    out = {}
    left, right = cli_frames(H, W, CLI_SYNC_FRAMES, CLI_FLASH, CLI_LAG)
    paths = {"720": [os.path.join(tmp, f"stream720_{s}.avi") for s in ("left", "right")]}
    for path, frames in zip(paths["720"], (left, right)):
        io_video.write_video(path, frames)
    _, (line,) = cli_run(dev, tmp, seconds, "sync", "sync", "--test-dir", tmp, "--left", paths["720"][0], "--right",
                         paths["720"][1])
    sampled = [io_video.extract_frames(p, max_frames=900, grayscale=True)[0] for p in paths["720"]]
    ref = sync.synchronize_streams(*sampled, device=dev)
    if line["offset"] != ref.offset or ref.offset != 1 or (line["left_flash"], line["right_flash"]) != (
            ref.left_flash, ref.right_flash):
        raise AssertionError(f"cli sync: {line} against synchronize_streams' {ref}")
    offset = ArtifactStore(tmp).load_sync()["frame_offset"]
    out["sync"] = dict(offset=offset, left_flash=line["left_flash"], right_flash=line["right_flash"])
    bl, br = cli_frames(BM_H, BM_W, CLI_STREAMS["bm"]["frames"] + offset, None, 0)
    paths["1080"] = [os.path.join(tmp, f"stream1080_{s}.avi") for s in ("left", "right")]
    for path, frames in zip(paths["1080"], (bl, br)):
        io_video.write_video(path, frames)
    store = ArtifactStore(tmp)
    rig, (R1, R2, P1, P2, Q) = store.load_rig(), store.load_rectification()
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    mesh = create_mesh(devices=[dev])
    for matcher, spec in CLI_STREAMS.items():
        src = paths["1080" if matcher == "bm" else "720"]
        size = (spec["w"], spec["h"])
        kernels = STREAM_KERNELS[matcher]
        argv = ["stream", "--test-dir", tmp, "--left", src[0], "--right", src[1], "--matcher", matcher,
                "--max-frames", str(spec["frames"])]
        if matcher == "sgbm":
            argv += ["--video-out", os.path.join(tmp, "disparity_sgbm.mp4")]
        (_, (line,)), cli_counts = counted_launches(
            kernels, lambda: cli_run(dev, tmp, seconds, f"stream {matcher}", *argv))
        stats = json.loads((store.results / "stream" / "stream_stats.json").read_text())
        saved = np.load(store.rectify_dir / "maps.npy")  # the command's maps: the saved ones where their size fits
        if saved.shape[1:] == (spec["h"], spec["w"]):
            maps = tuple(torch.as_tensor(m, device=dev) for m in saved)
        else:
            maps = (*ops.init_undistort_rectify_map(t64(rig.K1), t64(rig.d1), t64(R1), t64(P1), size),
                    *ops.init_undistort_rectify_map(t64(rig.K2), t64(rig.d2), t64(R2), t64(P2), size))
        if matcher == "bm":
            params = StereoBMParams(num_disparities=128, block_size=5)
        else:
            params = StereoSGBMParams(num_disparities=128, block_size=5, uniqueness_ratio=10)
        full = matcher == "sgbm"

        vis = []  # the --video-out frames the library's disparity gives

        def direct():
            rows = []
            for seq, disp, pts, n in stream_video_pair(*src, mesh, maps, t64(Q), matcher, params,
                                                       window=spec["window"], left_start=0, right_start=offset,
                                                       max_frames=spec["frames"], stats_only=not full):
                for k in range(n):
                    if full:
                        valid = disp[k] > 0
                        z = pts[k, ..., 2][valid]
                        rows.append({"frame": seq * spec["window"] + k, "valid_fraction": float(valid.mean()),
                                     "median_depth_mm": float(np.median(z)) if z.size else None})
                        v = np.zeros_like(disp[k])
                        if valid.any():
                            v[valid] = disp[k][valid] / max(float(disp[k][valid].max()), 1e-6) * 255
                        vis.append(v.astype(np.uint8))
                    else:
                        med = float(disp[k, 1])
                        rows.append({"frame": seq * spec["window"] + k, "valid_fraction": float(disp[k, 0]),
                                     "median_depth_mm": None if np.isnan(med) else med})
            return rows

        ref_rows, ref_counts = counted_launches(kernels, direct)
        same_launches(f"cli stream {matcher}", cli_counts, ref_counts)
        if stats != ref_rows or line["frames"] != spec["frames"] or line["size"] != list(size):
            raise AssertionError(f"cli stream {matcher}: its per-frame stats differ from stream_video_pair's "
                                 f"({line['frames']} frames)")
        r = dict(frames=line["frames"], window=spec["window"], size=line["size"], launches=cli_counts,
                 fps=line["fps"], fps_steady=line["fps_steady"], mpx_per_s=line["mpx_per_s"],
                 valid_fraction_first=stats[0]["valid_fraction"])
        if full:
            written = line["video_out"]
            frames = io_video.extract_frames(written, interval=1, max_frames=spec["frames"] + 1, grayscale=True)[0]
            if len(frames) != spec["frames"] or not np.array_equal(frames, np.stack(vis)):
                raise AssertionError(f"cli stream --video-out {written}: {len(frames)} frames, not the library's")
            r["video_out"] = os.path.basename(written)
        out[f"stream {matcher}"] = r
        torch.cuda.empty_cache()

    l0, r0 = scene(seed=0, H=H, W=W)
    for name, img in (("pair_left.png", l0), ("pair_right.png", r0)):
        write_png(os.path.join(tmp, name), img.astype(np.uint8))
    lt, rt = (torch.as_tensor(a.astype(np.int32), device=dev) for a in (l0, r0))
    for matcher, kernels, fn, params in (
            ("sgbm", EXACT_KERNELS, stereo_sgbm, StereoSGBMParams(num_disparities=64, block_size=5,
                                                                  uniqueness_ratio=10)),
            ("bm", {"bm_disparity": bm_cuda.bm_disparity}, bm.stereo_bm,
             StereoBMParams(num_disparities=64, block_size=5))):
        (_, (line,)), cli_counts = counted_launches(kernels, lambda: cli_run(
            dev, tmp, seconds, f"disparity {matcher}", "disparity", "--test-dir", tmp, "--left",
            os.path.join(tmp, "pair_left.png"), "--right", os.path.join(tmp, "pair_right.png"), "--matcher", matcher))
        got = np.load(store.results / "disparity" / "disparity.npy")
        ref, ref_counts = counted_launches(kernels, lambda: fn(lt, rt, params).cpu().numpy())
        same_launches(f"cli disparity {matcher}", cli_counts, ref_counts)
        if not np.array_equal(got, ref):
            raise AssertionError(f"cli disparity {matcher} differs from the library call on the same arrays")
        out[f"disparity {matcher}"] = dict(launches=cli_counts, valid_fraction=line["valid_fraction"])
    return out


def matplotlib_finding() -> dict:
    """Whether matplotlib imports here, found without importing it."""
    spec = importlib.util.find_spec("matplotlib")
    return {"matplotlib": spec is not None, "origin": getattr(spec, "origin", None)}


def cli_plotting(dev, tmp: str, seconds: dict, name: str, plots: bool, *argv) -> tuple[int, list[dict]] | str:
    """A command that draws with matplotlib: run where it is installed;
    where it is not, the documented ImportError must come, and is the
    result."""
    from stereo_vision_tpu_torch.pipeline.reporting import MATPLOTLIB_MISSING

    if plots:
        return cli_run(dev, tmp, seconds, name, *argv)
    try:
        cli_run(dev, tmp, seconds, name, *argv)
    except ImportError as e:
        if str(e) != MATPLOTLIB_MISSING:
            raise
        return "ImportError: " + str(e)
    raise AssertionError(f"cli {name} ran without matplotlib")


def cli_track(dev, tmp: str, seconds: dict, plots: bool) -> dict:
    """validate-distance, ball-drop, pose, smooth, animate, measure, analyze."""
    from stereo_vision_tpu_torch.io.png import write_png
    from stereo_vision_tpu_torch.pipeline import ArtifactStore, measure

    out = {}
    store = ArtifactStore(tmp)
    rig = store.load_rig()
    offset = store.load_sync()["frame_offset"]
    obj, c1, c2, p1, p2 = board_views(1, 39, DET_K, np.zeros(5), (DET_W, DET_H), DET_K, np.zeros(5), np.eye(3), DET_T,
                                      cols=DET_BOARD[0], rows=DET_BOARD[1], square=DET_SQUARE, noise=0.0,
                                      margin=150.0, depth=(VALIDATE_MM - 100, VALIDATE_MM + 100), return_poses=True)
    for side, p in (("left", p1), ("right", p2)):
        write_png(os.path.join(tmp, f"board_{side}.png"), render_board_view(DET_K, p[0][0], p[1][0], (DET_W, DET_H),
                                                                            *DET_BOARD, DET_SQUARE, device=dev)[0])
    R = ops.rodrigues(torch.as_tensor(p1[0][0])).numpy()
    truth = float(np.linalg.norm((R @ obj.T).T.mean(0) + p1[1][0]))
    _, (line,) = cli_run(dev, tmp, seconds, "validate-distance", "validate-distance", "--test-dir", tmp, "--left",
                         os.path.join(tmp, "board_left.png"), "--right", os.path.join(tmp, "board_right.png"),
                         "--actual-distance", f"{truth:.1f}")
    if not line["passed"] or line["error_percent"] > 1.0:
        raise AssertionError(f"cli validate-distance: {line} against the render's {truth:.1f} mm")
    out["validate-distance"] = dict(measured=line["measured"], expected=line["expected"],
                                    error_percent=line["error_percent"])

    lf, rf, *_ = render_ball_drop_stereo(rig, T=CLI_BALL_FRAMES + offset, fps=240.0, H=E2E_H, W=E2E_W,
                                         hold_frames=8, ball_radius_mm=110.0, seed=5)
    pl, pr, _ = render_pose_stereo(rig, T=CLI_POSE_FRAMES + offset, H=E2E_H, W=E2E_W, seed=6)
    for name, frames in (("ball_left", lf), ("ball_right", rf), ("pose_left", pl), ("pose_right", pr)):
        io_video.write_video(os.path.join(tmp, f"{name}.avi"), frames)
    _, (line,) = cli_run(dev, tmp, seconds, "ball-drop", "ball-drop", "--test-dir", tmp, "--left",
                         os.path.join(tmp, "ball_left.avi"), "--right", os.path.join(tmp, "ball_right.avi"),
                         "--fps", "240")
    ld = pretrained.detect_balls_in_frames(lf[:CLI_BALL_FRAMES], device=dev)
    rd = pretrained.detect_balls_in_frames(rf[offset:offset + CLI_BALL_FRAMES], device=dev)
    report = track.drop_report(track.analyze_ball_drop(rig, ld, rd, fps=240.0, device=dev))
    if line != json.loads(json.dumps({"stage": "ball_drop", "sync_offset": offset, **report})):
        raise AssertionError(f"cli ball-drop: {line} against the library's {report}")
    out["ball-drop"] = {k: line.get(k) for k in ("frames", "valid_detections", "drop_start_index", "gravity_mm_s2")}
    anim = cli_plotting(dev, tmp, seconds, "ball-drop --animate", plots, "ball-drop", "--test-dir", tmp, "--left",
                        os.path.join(tmp, "ball_left.avi"), "--right", os.path.join(tmp, "ball_right.avi"),
                        "--fps", "240", "--animate")
    out["ball-drop --animate"] = anim if isinstance(anim, str) else os.path.basename(anim[1][0]["animation"])

    _, (line,) = cli_run(dev, tmp, seconds, "pose", "pose", "--test-dir", tmp, "--left",
                         os.path.join(tmp, "pose_left.avi"), "--right", os.path.join(tmp, "pose_right.avi"))
    lml = pretrained.pose_landmarks_in_frames(pl[:CLI_POSE_FRAMES], device=dev)
    lmr = pretrained.pose_landmarks_in_frames(pr[offset:offset + CLI_POSE_FRAMES], device=dev)
    res = run_pose_workflow(rig, lml, lmr, device=dev)
    pose_dir = store.results / "pose"
    with open(pose_dir / "pose_3d_original.pkl", "rb") as f:
        poses = pickle.load(f)
    apart = float(np.nanmax(np.abs(poses - res.poses_raw))) if np.isfinite(res.poses_raw).any() else 0.0
    if line["frames"] != CLI_POSE_FRAMES or not np.array_equal(np.isfinite(poses), np.isfinite(res.poses_raw)) \
            or apart > E2E_FUSE_MM:
        raise AssertionError(f"cli pose: {line['frames']} frames, poses {apart} mm from the library's")
    out["pose"] = dict(frames=line["frames"], valid_pose_fraction=line["valid_pose_fraction"], poses_mm_apart=apart,
                       plots=sorted(p.name for p in pose_dir.glob("*.png")))
    _, (line,) = cli_run(dev, tmp, seconds, "smooth", "smooth", "--input", str(pose_dir / "pose_3d_original.pkl"))
    with open(pose_dir / "pose_3d_resmoothed.pkl", "rb") as f:
        got = pickle.load(f)
    ref = track.MotionSmoother("smalliphone", device=dev).smooth_pose_sequence(np.asarray(poses, np.float64))
    if not np.array_equal(got, ref, equal_nan=True):
        raise AssertionError("cli smooth differs from MotionSmoother on the card")
    out["smooth"] = dict(jitter_reduction_pct=line["jitter_reduction_pct"])
    anim = cli_plotting(dev, tmp, seconds, "animate", plots, "animate", "--raw", str(pose_dir / "pose_3d_original.pkl"),
                        "--smoothed", str(pose_dir / "pose_3d_resmoothed.pkl"), "--out",
                        os.path.join(tmp, "pose_comparison.mp4"), "--fps", "4", "--duration", "1")
    out["animate"] = anim if isinstance(anim, str) else os.path.basename(anim[1][0]["output"])

    X = np.array([[0.0, 0.0, 2000.0], [300.0, 50.0, 2300.0]])
    pix = lambda P: (lambda h: h[:, :2] / h[:, 2:])((P @ np.c_[X, np.ones(2)].T).T)  # noqa: E731
    measure.save_clicks(os.path.join(tmp, "clicks.json"), [measure.ClickMeasurement(
        "pair", pix(rig.P1), pix(rig.P2), expected_mm=float(np.linalg.norm(X[0] - X[1])))])
    _, (line,) = cli_run(dev, tmp, seconds, "measure", "measure", "--test-dir", tmp, "--clicks",
                         os.path.join(tmp, "clicks.json"))
    P1 = np.asarray(rig.K1) @ np.hstack([np.eye(3), np.zeros((3, 1))])  # as the command builds them
    P2 = np.asarray(rig.K2) @ np.hstack([np.asarray(rig.R), np.asarray(rig.T).reshape(3, 1)])
    ref = [r.to_dict() for r in measure.measure_clicks(measure.load_clicks(os.path.join(tmp, "clicks.json")), rig.K1,
                                                       rig.d1, rig.K2, rig.d2, P1, P2, device=dev)]
    if line != json.loads(json.dumps({"stage": "measure", "measurements": ref})):
        raise AssertionError(f"cli measure: {line} against measure_clicks' {ref}")
    out["measure"] = dict(distance_mm=line["measurements"][0]["distance_mm"])
    res = cli_plotting(dev, tmp, seconds, "analyze", plots, "analyze", "--results-dir", str(store.results))
    out["analyze"] = res if isinstance(res, str) else dict(runs=res[1][0]["runs"])
    return out


def phase_cli(dev, card: str) -> dict:
    """Phase 38: the CLI's commands on the card (see CLI_*)."""
    finding = matplotlib_finding()
    print(f"phase 38 matplotlib on this machine: {json.dumps(finding)}", flush=True)
    seconds: dict = {}
    out = {"matplotlib": finding}
    with tempfile.TemporaryDirectory() as tmp:
        out["calibrate"] = cli_calibrate(dev, tmp, seconds)
        print(f"cli intrinsic -> extrinsic -> rectify ({CLI_VIEWS} views a camera, {DET_W}x{DET_H}) on {card}: "
              f"equal to the library calls on the card; {json.dumps(out['calibrate'])}", flush=True)
        torch.cuda.empty_cache()
        out["sync_stream"] = cli_sync_stream(dev, tmp, seconds)
        print(f"cli sync, stream and disparity on {card}: each equal to the library call, its launches counted; "
              f"{json.dumps(out['sync_stream'])}", flush=True)
        torch.cuda.empty_cache()
        out["track"] = cli_track(dev, tmp, seconds, finding["matplotlib"])
        print(f"cli validate-distance, ball-drop, pose, smooth, animate, measure, analyze on {card}: "
              f"{json.dumps(out['track'])}", flush=True)
    out["seconds"] = seconds
    print(f"cli host seconds a command on {card}: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # g++ for the host runtime beside the nvcc processes
        host = {name: pool.submit(native.build, name) for name in ("host_ops", "frame_ring")}
        reports = _build.build()
        host = {name: f.result() for name, f in host.items()}
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {sorted(reports) or 'nothing (already built)'}; host runtime "
          f"{json.dumps({k: str(v) for k, v in host.items()})}", flush=True)
    if None in host.values():
        raise AssertionError(f"g++ failed to build the native host runtime: {host}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  {name}: {line.strip()}", file=sys.stderr)

    rows = phase_kernels(dev)
    torch.cuda.empty_cache()
    phase_small_pipeline(dev)
    e2e, counts, disp = phase_main_path(dev, rows)
    print(f"main path 1280x720 D={D} B={B}: {e2e['ms_per_call']:.2f} ms per call, "
          f"{e2e['mpx_per_s']:.2f} Mpx/s, {e2e['frames_per_s']:.2f} frames/s on {card}", flush=True)
    exact_records = record_exact_call(dev, disp)
    cost_record = next(c for c in exact_records if c["name"] == "cost")
    rows += phase_recorded_kernels([c for c in exact_records if c["name"] != "cost"], counts, B, "exact8")
    cost_kernel = phase_cost_kernel(dev, cost_record, reports)
    vertical_cluster = phase_vertical_cluster(dev, cost_record["out"])
    del exact_records, cost_record
    breakdown = phase_breakdown(dev)
    print("breakdown ms per 4-frame call:", json.dumps(breakdown), flush=True)
    disp_exact = disp.cpu()  # the fused R->L phase compares with it later
    del disp
    torch.cuda.empty_cache()

    lt, rt = hier_frames(dev)
    hier_e2e, counts, hier_disp = phase_hier_main_path(dev, lt, rt, P3, "hier4x3")
    hier_breakdown, _ = record_hier_call(dev, lt, rt, hier_disp, keep=False)
    _, records = record_hier_call(dev, lt, rt, hier_disp, keep=True)
    print(f"hier4x3 breakdown ms per {HIER_P}-frame call:", json.dumps(hier_breakdown), flush=True)
    rows += phase_recorded_kernels(records, counts, PLAIN_FRAMES, "hier4x3")
    check_wta16(records)
    del hier_disp, records
    torch.cuda.empty_cache()

    h8_e2e, counts, h8_disp = phase_hier_main_path(dev, lt, rt, P8, "hier4x8")
    h8_breakdown, _ = record_hier_call(dev, lt, rt, h8_disp, keep=False, params=P8)
    _, records = record_hier_call(dev, lt, rt, h8_disp, keep=True, params=P8)
    print(f"hier4x8 breakdown ms per {HIER_P}-frame call:", json.dumps(h8_breakdown), flush=True)
    rows += phase_recorded_kernels(records, counts, PLAIN_FRAMES, "hier4x8")
    del lt, rt, h8_disp, records
    torch.cuda.empty_cache()
    check_diag_random(dev)
    torch.cuda.empty_cache()

    geometry = phase_geometry(dev)
    h16, h16_rows = phase_hier16(dev)
    rows += h16_rows
    torch.cuda.empty_cache()
    phase_hier_per_frame(dev)
    torch.cuda.empty_cache()
    horizontal_bands = phase_horizontal_bands(dev)
    torch.cuda.empty_cache()
    settings = phase_settings(dev)
    torch.cuda.empty_cache()
    banded_cost_levels = phase_banded_cost(dev)
    torch.cuda.empty_cache()
    wide_bands = phase_wide_bands(dev)
    torch.cuda.empty_cache()
    wide_range = phase_wide_range(dev)
    torch.cuda.empty_cache()

    phase_hier_small_pipeline(dev)
    agree = phase_agreement(dev)
    torch.cuda.empty_cache()

    fused, fused_rows = phase_fused_rl(dev, disp_exact)
    rows += fused_rows
    del disp_exact
    torch.cuda.empty_cache()
    sites, site_rows = phase_sgm_sites(dev)
    rows += site_rows
    torch.cuda.empty_cache()

    bm480 = check_bm_kernel(dev)
    phase_bm_small_pipeline(dev)
    frames = [scene(seed=s, H=BM_H, W=BM_W) for s in range(BM_B)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    bm_e2e, counts, bm_disp = phase_bm_main_path(dev, lt, rt)
    bm_breakdown, _ = record_bm_call(dev, lt, rt, bm_disp, keep=False)
    print(f"bm1080 breakdown ms per {BM_B}-frame call:", json.dumps(bm_breakdown), flush=True)
    _, records = record_bm_call(dev, lt, rt, bm_disp, keep=True)
    rows += phase_recorded_kernels(records, counts, BM_PLAIN_FRAMES, "bm1080")
    bm_rows = phase_bm_rows(dev, records[0])
    del lt, rt, bm_disp, records
    torch.cuda.empty_cache()
    speckle = phase_speckle(dev)
    SPECKLE_RECORDS.clear()
    torch.cuda.empty_cache()
    banded_vertical = phase_banded_vertical(dev)
    VERTICAL_RECORDS.clear()
    torch.cuda.empty_cache()
    wta_lr = phase_wta_lr(dev)
    for r in WTA_LR_RECORDS.values():
        r.clear()
    torch.cuda.empty_cache()
    fused_kernels = phase_fused_kernels(dev)
    FUSED_RECORDS.clear()
    torch.cuda.empty_cache()
    pyramid_lr = phase_pyramid_lr(dev)
    PYRAMID_LR_RECORDS.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    calibrate_stream = phase_calibrate_stream(dev)
    calibrate_stream["phase_s"] = time.perf_counter() - t0
    print(f"phase 32: {calibrate_stream['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    detection = phase_detect(dev, card)
    detection["phase_s"] = time.perf_counter() - t0
    print(f"phase 33: {detection['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ball_pose = phase_ball_pose(dev, card)
    ball_pose["phase_s"] = time.perf_counter() - t0
    print(f"phase 34: {ball_pose['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training = phase_train(dev, card)
    training["phase_s"] = time.perf_counter() - t0
    print(f"phase 35: {training['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    several = phase_mesh(dev, card)
    several["phase_s"] = time.perf_counter() - t0
    print(f"phase 36: {several['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    videos = phase_video(dev, card)
    videos["phase_s"] = time.perf_counter() - t0
    print(f"phase 37: {videos['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli_phase = phase_cli(dev, card)
    cli_phase["phase_s"] = time.perf_counter() - t0
    print(f"phase 38: {cli_phase['phase_s']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    for r in rows:  # the copy time of the same bytes beside each #20 / #10 / #5 / #19 row of a main path
        levels = {k: v for k, v in wta_lr.get(r["name"], {}).items() if k.startswith(f"{r['path']} ")}
        if levels and all(f"{r['path']} {lv}" in levels for lv in r["ms_by_level"]):
            r["copy_ms"] = sum(v["copy_ms"] for v in levels.values())
        if r["name"] in fused_kernels:
            f = fused_kernels[r["name"]]
            r.update(copy_ms=f["copy_ms"], replaced=f["replaced"], replaced_ms=f["replaced_ms"])
        p = pyramid_lr.get(f"{r['name']} ({r['path']})")
        if p is not None:  # #14 and #9: the copy, the C entry alone and (#14) the parent's form and work
            r.update({k: p[k] for k in ("copy_ms", "entry_ms", "parent_form_ms", "parent_work_bound_ms") if k in p})

    names = [r["name"] for r in rows]
    for r in rows:  # a kernel that runs on several paths: one row each
        if names.count(r["name"]) > 1:
            r["name"] = f"{r['name']} ({r['path']})"
    print(json.dumps({"card": card, "main_path": e2e, "breakdown": breakdown, "hier_main_path": hier_e2e,
                      "hier_breakdown": hier_breakdown, "hier4x8_main_path": h8_e2e, "hier4x8_breakdown": h8_breakdown,
                      "agreement": agree, "exact8_fused_rl_wta": fused, "sgm_sites": sites, "bm480": bm480,
                      "bm_main_path": bm_e2e, "bm_breakdown": bm_breakdown, "hier16x3": h16,
                      "geometry": geometry, "banded_horizontal_full_shape": horizontal_bands,
                      "settings": settings, "banded_cost_levels": banded_cost_levels,
                      "wide_bands": wide_bands, "wide_range": wide_range, "speckle": speckle,
                      "cost_kernel": cost_kernel, "vertical_cluster": vertical_cluster, "bm_rows": bm_rows,
                      "banded_vertical": banded_vertical, "wta_lr": wta_lr, "fused_kernels": fused_kernels,
                      "pyramid_lr": pyramid_lr, "calibrate_stream": calibrate_stream, "detection": detection,
                      "ball_pose": ball_pose, "training": training, "mesh": several, "video": videos, "cli": cli_phase,
                      "build_s": build_s}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

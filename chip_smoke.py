"""Chip smoke test of the PyTorch/CUDA port (yolosharp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Ten serving paths: v8s detection (kernels conv3x3 s1/s2 and the fused
C2f), v12s detection (conv3x3 s1/s2 and the fused attention), v11s and
v5us detection, v11m-seg instance segmentation, v11m-pose and v11s-pose
pose estimation (conv3x3 s1/s2 only: v11's PSA attention takes the einsum
path, and none has a C2f block), v12x-obb End2End oriented boxes
(conv3x3 s1/s2 and the fused attention), and at 224x224 v8s-cls
classification (conv3x3 s1/s2 and the fused C2f, at 7x7 among others) and
v11s-cls (conv3x3 s1/s2); then predict_stream of one model of each task
family. Training: v8s and v12s on letterbox batches, v11s through the
mosaic (the device render) and v8s through the host mosaic, v11m-seg
through the mosaic with masks, v11m-pose with keypoints, v12x-obb with
rotated boxes, v8s-cls on the AutoAugment stack.

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit; build every CUDA kernel from the
     sources in yolosharp_tpu_torch/csrc (one nvcc per source, in
     parallel), and beside them the host C++ image decoders (c++).
  2. each kernel against its plain PyTorch version at every shape any
     path gives it (recorded with forward hooks on the folded nets of
     every path: 640x640 for the convs and 224x224 for the classify
     models' (v8s-cls's C2f at 56x56 and at 7x7 among them; these also at
     B=32 in float32), the 51-wide keypoint towers of
     v11s-pose (Ci or Co = 51) and v12x-obb's 96-wide angle towers and
     768-wide stride-2 conv included; 640x640, 480x640, 500x375 and
     1280x1280 for the attention), B=2, in float32 (TF32 off for cuDNN
     and matmul; the float32 conv and C2f run twice, their bits equal,
     their f32_plan / f32_c2f_plan printed, the float32 attention's
     f32_geometry printed), bfloat16 and float16, with device times (CUDA events around a CUDA graph of 10
     calls, in turns plain / kernel / library / library / kernel / plain),
     the eager times of the same calls made from Python (host launch cost
     included), and the TFLOP/s each reaches (convs
     2*Ho*Wo*9*Ci*Co*B; the C2f block's four GEMMs; attention's two
     products). Beside them each shape's bound, max(FLOP / peak, bytes /
     3.35 TB/s) with each input read once and the output written once
     (peaks 989 TFLOP/s bf16 and f16, 67 TFLOP/s f32), and the library
     time: one
     PyTorch call computing the same function, timed and never used by the
     port (F.conv2d with bias and without the activation for the convs,
     F.scaled_dot_product_attention for the attention, none for the C2f
     block). bfloat16 and float16 take the tensor-core kernels, float32 the
     CUDA-core kernels. float32: |k-p| <= 1e-4 + 1e-4|p| (attention 2e-5 +
     2e-4|p|). bfloat16 and float16: the kernel against the plain version
     evaluated in float64 on the same rounded inputs, max|k - ref| /
     max|ref| within 1.25 u for the convs (they round their output once;
     u = 2^-8 bf16, 2^-11 f16), 2.5 u for the attention (P and the output
     rounded) and twice the plain chain's own distance for the C2f block
     (which rounds where its plain chain does); both versions' distances
     are printed. Then the 640x640
     shapes again at B=32 in bfloat16 and float16, timed, and at last every
     kernel
     variant the served requests of phases 3 and 4 take (the bf16 conv's N
     tile or stem plan, the C2f block's plan, the attention's route and splits;
     they depend on the batch) that was not checked yet, at the first request
     that takes it. Each check prints the variant it ran, and the sums of
     kernel / plain / library / bound ms are printed over the v11m-seg
     shapes, the v11m-pose shapes, v11s-pose's Ci / Co = 51 shapes and
     v12x-obb's shapes (the attention at 1536 and 384 sequences of N =
     400 at b32 among them). The 16-bit stems (Ci <= 7, csrc/stem.cuh) are
     printed as rows of their own and summed, kernel / plain / F.conv2d /
     bound, at B=2, b32 and b8 (HGStem's ReLU), and held at the ragged
     shapes of the card tests too.
  3. the v8s slice: a v8s nc=80 YoloTask on cuda with seeded weights times
     its bf16 batch-32 640x640 network forward (CUDA events), counts the
     kernel launches of one such forward, and answers image_predict and
     batch_predict requests, with end2end False and True; conv3x3 s1/s2 and
     c2f_fused must have launched during them.
  3b. the v12s slice, the same way; conv3x3 s1/s2 and fused_attention must
     have launched during it.
  3c. the v11s slice, the same way; conv3x3 s1/s2 must have launched,
     c2f_fused and fused_attention must not (in every slice a kernel off
     the path must not launch).
  3d. v5us: one b32 batch_predict (NMS), the same launch check.
  4. / 4b. / 4c. the v8s, v12s and v11s float32 predict of one image on
     the card against the CPU's float32 predict through the plain versions;
     v8s (4) once more under PyTorch's default flags (cuDNN's TF32 on),
     which the port's own scope turns off around its work.

Training (the attention is the only kernel on the train path; the conv and
C2f kernels serve predict only and must not launch there):
  5. the attention under autograd at the v12s batch-16 640x640 train
     shapes, (64, 400, 4, 32) and (16, 400, 8, 32) in (B, N, H, D), and
     at v12x-obb's batch-8 ones, (32, 400, 12, 32) and (8, 400, 12, 32)
     (384 and 96 sequences; their bf16 sums apart from v12s's), each
     with the variant it takes: the kernel's forward (an output with a
     grad_fn, one launch) against the plain version's output at the
     tolerances of phase 2, and with the plain backward against full plain
     autograd, gradients of q, k and v: float32 |d| <= 1e-4 + 1e-4|ref|,
     bfloat16 max|d| / max|ref| < 2e-2; forward + backward ms of the kernel
     route, plain autograd and SDPA (CUDA events).
  6. one float32 train step of v8n, v12n, v11n-seg, v11n-pose and
     v12n-obb (End2End; the segment batch's masks are its boxes' regions,
     the pose batch's 17 keypoints a box lie inside it, visibility 0, 1 or
     2; its cv4 towers are 51 wide; the OBB batch's boxes take an angle
     from [-pi/2, 0), and its attention runs under autograd) at 128x128,
     batch 2, card and CPU in float32 against the same step in float64 on
     the CPU, same seeded weights and uint8 batch (the CPU float32 step's
     own distance from float64 is printed beside the card's; the card is
     gated): loss items to 1e-4 relative (the OBB step's to 1e-5). The
     leaves whose gradient is 0 by construction (a conv
     bias that a train-mode BN removes, as in AAttn's pe; SPPF's cv1 BN
     bias) must read |g| <= 1e-6 G on both devices, G the float64 net's
     largest gradient, and are printed. Every other leaf: gradients
     |g_card - g_f64| <= 1e-3 max|g_f64| per tensor; each parameter's
     change (the float64 step's new parameters rounded to float32 first)
     |dp_card - dp_f64| <= 1e-3 max|dp_f64| + 1e-8 wherever the two
     gradients fix AdamW's first update, lr * g / (|g| + eps) (the count of
     elements outside the rule where they do not, a near-zero gradient
     whose sign or size the float32 rounding moves, is printed); BN running
     statistics against the float64 step's, per tensor:
     |d| <= b (|ref| + max|ref|), b = 1e-5 or twice the CPU
     float32 run's own distance where that is larger (running means near 0
     sit within the rounding of far larger sums; the CPU's distance and
     the plain |d| / |ref| are printed beside it).
  7. YoloTask.train() of v8s at full width, 640x640, batch 16, bfloat16,
     one epoch, on a synthetic dataset that this script writes as PNG with
     adaptive row filters (the filter mix is printed; 160 train and 32 val
     images of 480-800 px a side, 1-8 solid rectangles each, YOLO txt
     labels): steps, median ms a step after the
     first two (each step ends in its host sync), img/s, the share of the
     step loop spent waiting on the loader, val seconds and metrics, peak
     device memory; finite losses, the five output files, and best.bin
     loaded into a fresh YoloTask whose image_predict runs.
  6b. true_fp16 (float16 compute): v8s and v12s b32 640x640 batch_predict,
     every kernel of each path launched in float16 (the largest |x| a
     layer of the float16 forward reaches is printed, and any layer past
     float16's 65504); then v12n true_fp16 train steps at 128x128, batch 2,
     from the loss scale 65536 until two updates have been applied (the
     scale halves after each step whose float16 gradients overflow), with
     the attention kernel in float16 under autograd (its output has a
     grad_fn), finite loss items, and the loss scale printed after each
     step.
  7b. v12s on the same data: the seconds to build its train YoloDataset
     (PNG decode without cv2 and resize), one epoch (10 steps) through the
     port's train step, ms a step, and 8 attention launches a forward.
  8a. the mosaic: one planned b16 640x640 batch of the data (degrees 10,
     shear 2, perspective 5e-4: the full warp) rendered on the card and on
     the CPU in float32: at most 0.1% of the values more than 1e-2 apart
     (the fraction is printed); the render's ms a batch (CUDA events). Then
     YoloTask.train() of v11s at full width, 640x640, batch 16, bf16,
     close_mosaic=1 and 2 epochs: epoch 1 on the device render (a render a
     step), epoch 2 on letterbox batches; per epoch the median step ms,
     img/s, the loader-wait share and peak device memory; finite losses;
     best.bin served by a fresh v11s YoloTask through the conv kernels.
  8b. one epoch of v8s with device_augment=False and mosaic=0.5: the host
     mosaic (mosaic4 + random_perspective) and letterbox mix; ms a step and
     the loader-wait share.
Segment (v11m-seg at its published widths: nc=80, Proto 256, cv4 64; its
conv shapes are in phase 2's checks and the b32 bf16 / f16 timings, with
their sums printed):
  9a. the v11m-seg slice as phase 3, bf16: the b32 forward (CUDA events)
     and its launches (conv3x3 s1 and s2 only), batch_predict b32 and
     image_predict at 640x640, 480x640 and 500x375 in both End2End modes,
     every result with a bool mask of its image's (h, w).
  9b. its float32 predict of one image, card against CPU: the rows as
     phase 4, and the matched results' masks with at least 99.9% of their
     pixels equal.
  9c. one planned b8 640x640 segment batch (the full warp) of a polygon
     PNG dataset that this script writes (64 train and 16 val images of
     480-800 px, 1-8 star-shaped polygons of 3-12 vertices): its masks
     rendered on the card and on the CPU, at most 0.1% of the ids
     differing (printed); the image and mask render ms.
  9d. YoloTask.train() of v11m-seg, 640x640, batch 8, bf16, close_mosaic=1,
     2 epochs (the device render of images and masks, then letterbox): per
     epoch the median step ms, img/s, loader-wait share and peak memory;
     val's eight metrics; finite losses; best.bin served by a fresh
     v11m-seg YoloTask through the conv kernels, with masks.
  9e. Segmenter.val of phase 9a's seeded v11m-seg in float32 on the card and
     on the CPU, on 8 640x640 images labelled with its own predictions (up
     to 8 an image: the highest-scored masks of at least 400 pixels that
     fill at least 0.8 of their row-span polygon, written as that polygon),
     NMS at mask_ratio 4 and End2End at mask_ratio 2 (the ground truth's
     masks resized nearest to the proto grid): box and mask mAP50 above 0
     on both, and each of the eight metrics within 0.02 card against CPU.
Pose (v11m-pose at its published widths: nc=1, 17 x 3 keypoints, cv4 64,
Ultralytics yolo11-pose.yaml at scale m; its conv shapes, and v11s-pose's,
are in phase 2's checks):
  10a. the v11m-pose slice as phase 3, bf16: the b32 forward (CUDA events)
     and its launches (conv3x3 s1 and s2 only), batch_predict b32 and
     image_predict at 640x640, 480x640 and 500x375 in both End2End modes,
     every result with 17 finite keypoints; then one b32 batch_predict of
     v11s-pose (NMS), whose 51-wide towers run inside a served request.
  10b. its float32 predict of one image, card against CPU: the rows as
     phase 4, and each matched row's keypoints within 0.5 px, visibility
     within 1e-3.
  10c. YoloTask.train() of v11m-pose, 640x640, batch 8, bf16,
     close_mosaic=1, 2 epochs (the device render, whose planned batches
     carry keypoints, then letterbox) on a PNG dataset that this script
     writes (64 train and 16 val images of 480-800 px, 1-8 rectangles,
     each with 17 keypoints inside it of visibility 0, 1 or 2): per epoch
     the median step ms, img/s, loader-wait share and peak memory; val's
     eight metrics; finite losses; best.bin served by a fresh v11m-pose
     YoloTask through the conv kernels, with keypoints.
  10d. PoseDetector.val of phase 10a's seeded v11m-pose in float32 on the
     card and on the CPU, on 8 640x640 images labelled with its own
     predictions (up to 8 an image: box and 17 keypoints, visible (2)
     where the predicted visibility is above 0.5, else 0, and at least
     the 3 most visible visible), NMS and End2End: box and pose mAP50
     above 0 on both, and each of the eight metrics within 0.02 card
     against CPU.
OBB (v12x-obb End2End, nc=15 (DOTA's classes), the JAX bench's workload 5,
bench.py:292-354; cv4 angle towers 96 wide; its conv and attention shapes
are in phase 2's checks):
  11a. the v12x-obb slice as phase 3, bf16: the b32 forward (CUDA events)
     and its launches, a full forward's and the End2End predict's (one2one
     towers only), each equal to the count its modules give (each 3x3
     ConvBN on the kernel route one conv launch of its stride, each AAttn
     one attention launch); batch_predict b32 and image_predict at
     640x640, 480x640 and 500x375 in both End2End modes (the rotated fast
     NMS: conf calibrated to <= 300 candidates an image, the NMS pool of
     512 untruncated), every row with w, h > 0 and an angle in [-pi/4,
     3pi/4] (bf16 rounds the head's 3pi/4 up by up to 2^-7).
  11b. its float32 predict of one image, card against CPU, NMS and
     End2End: no unmatched row, the matched rows' centre and sides within
     0.5 px and angle within 1e-4 rad.
  11c. YoloTask.train() of v12x-obb, 640x640, bf16, close_mosaic=1, 2
     epochs (the device render, then letterbox), at batch 4 (the JAX
     workload's) and at batch 8, on a PNG dataset that this script writes
     (48 train and 8 val images of 480-800 px, 1-8 solid rotated
     rectangles drawn by the port's fill_poly, 4-corner labels, 15
     classes): per epoch the median step ms, img/s, loader-wait share and
     peak memory; the updates applied (a non-finite step is skipped);
     val's four metrics; finite losses; the attention launched in
     training and no conv kernel; best.bin served by a fresh v12x-obb
     YoloTask through the conv and attention kernels.
  11d. Obber.val of phase 11a's seeded v12x-obb in float32 on the card and
     on the CPU, on the same 4 640x640 images labelled with its own
     predictions (up to 8 an image, written as the 4 corners of each
     rotated box), NMS and End2End: box mAP50 above 0 on both, and each of
     the four metrics within 0.005 card against CPU.
Classify (v8s-cls at its published widths, Ultralytics yolov8-cls.yaml
scale s: the v8s trunk's layers 0-8 and the Classify head, nc=1000
(ImageNet), 224x224; its shapes, and v11s-cls's, are in phase 2's checks
and a shape group of their own):
  12a. v8s-cls, bf16, seeded weights (ConvBN kernels x2.8, the head's
     Linear from U(-0.3, 0.3)): the b32 forward (CUDA events) and its launches, equal to the
     count its modules give and to 8 s1 + 5 s2 + 2 C2f (no attention);
     image_predict at 224x224, 480x640 and 500x375 and batch_predict b32,
     each result 5 distinct classes with descending scores; a float16
     (true_fp16) b32 batch_predict; a v11s-cls b32 batch_predict (conv3x3
     only).
  12b. the float32 predict of 8 images (squashed to 224), card against
     CPU: the softmax within 1e-5, and batch_predict's top 5 the same
     classes wherever neighbouring scores differ by more than 1e-5.
  12c. YoloTask.train() of v8s-cls (nc=10), 224x224, batch 32, bf16, 2
     epochs, the default augment stack (RandomResizedCrop, flips,
     AutoAugment, erasing 0.4), on a folder-per-class PNG set that this
     script writes (10 classes of one stripe pattern each, 32 train and 8
     val images a class, 160-400 px a side): per epoch the median step
     ms, img/s, loader-wait share and peak memory; top1 / top5; finite
     losses; no kernel launched in training; best.bin served by a fresh
     v8s-cls YoloTask through the conv and C2f kernels.
  12d. Classifier.val of 12c's best.bin in float32 on the card and on the
     CPU: top1 and top5 equal, the val loss within 1e-4 relative.
  13. predict_stream of v8s (NMS), v11m-seg (NMS), v11m-pose (NMS),
     v12x-obb (End2End) and v8s-cls with their phase's seeded weights and
     conf: 8 images of 300-640 px a side in float32 at batch 3 (a partial
     last batch) on the card and on the CPU, one list an image in order,
     rows matched (counts within 2, each CPU row by a card row of its
     class with centre and size within 1 px and score within 1e-3, at
     most 2 unmatched, OBB none and its angle within 1e-4 rad; keypoints
     within 0.5 px; float32 masks > 0.5 equal on 99.9% of the pixels;
     classify: scores within 1e-5 and the same top 1); then 64 images in
     bf16 at batch 16, img/s beside batch_predict's of the same
     letterboxed canvases (classify: the same images) in calls of 16 and
     beside the letterbox and batch_predict in the caller's thread, and
     the path's kernels launched, no other.
Image input (the host decoders of yolosharp_tpu_torch/csrc: the JPEG
decoder of jpeg_decode.cpp, baseline, progressive, of several scans,
Huffman or arithmetic-coded, gray, YCbCr, RGB, CMYK and YCCK, cut streams,
restart recovery and block smoothing as libjpeg-turbo's; the PNG row
unfilter of png_unfilter.cpp, that every PNG phase reads through; the TIFF
LZW, PackBits and CCITT decoders of tiff_decode.cpp (JPEG-in-TIFF through
the JPEG decoder, YCbCr and CMYK mapped in numpy);
the WebP VP8L and VP8 decoders of webp_decode.cpp; the JPEG 2000
codestream decoder of jp2_decode.cpp (OpenJPEG's tiers 1 and 2, 5/3 and
9/7 DWT, RCT / ICT); GIF's LZW in gif_decode.cpp; HDR scanlines in
hdr_decode.cpp; all built with c++ in phase 1 beside the CUDA kernels;
BMP, PNM, PAM, Sun raster and PFM in numpy):
  14a. every committed fixture of tests/data_torch/jpeg and
     tests/data_torch/images (progressive, CMYK and YCCK JPEG, JPEG cut
     short, without EOI, with restart markers misnumbered or missing,
     progressive left unrefined, of three scans, arithmetic-coded; every
     PNG kind; baseline TIFF kinds, uncompressed YCbCr, an LZW strip cut
     short, JPEG-in-TIFF, CCITT MH / T.4 / T.6, CMYK; 1- / 4- / 16-bit,
     bit-field, RLE and OS/2 BMP, PNM, PAM, lossy / lossless / alpha /
     EXIF / animated WebP and WebP bytes under a .jpg name; JPEG 2000 of
     every progression order, tiled, layered, gray, RGBA, 16-bit, sYCC,
     palette, every code-block style, SOP / EPH / POC / RGN / COC / QCC;
     GIF, Sun raster, PFM, HDR; JPEG without DHT segments) read by
     read_image_rgb: the SHA-256 of its
     RGB bytes equal to its manifest's (cv2.imread's, where the fixtures
     were written). The host decode ms of each (the median of 5); of the
     641x479 4:2:0 baseline and progressive files, the 640x480 lossy and
     lossless WebP files, the 640x480 lossy JPEG 2000 fixture and a
     640x480 RGB TIFF, LZW with the predictor, an ASCII P3 and a GIF that
     this phase writes with tests/data_torch/images/writers.py (equal to
     the pixels they were written from), the median of 50.
  14b. v8s-640 detect, bf16, phase 3's seeded weights: image_predict of
     the 641x479 baseline fixture's path and of the WebP fixture named
     .jpg (each equal to image_predict of its decoded array) and
     batch_predict of 32 images decoded from the fixtures of both
     folders (a lossy JP2 under a .jpg name, a GIF, a Sun raster, an HDR,
     a PFM and a DHT-less JPEG file, a cut JPEG, a CCITT T.4 TIFF, a YCbCr
     JPEG-in-TIFF and a CMYK TIFF first, then cycled over every file
     extension: JPEG, PNG, TIFF, BMP, PNM, PAM, WebP, JPEG 2000, GIF, Sun
     raster, PFM and HDR kinds), conv3x3 s1 / s2 and c2f_fused
     launched and
     no other kernel; then YoloTask.train() of v8s, 640x640, batch 16, 2
     epochs on a detect set of those fixtures (those of 32 px a side or
     more; a PNM, PAM, WebP, JPEG 2000, GIF, Sun raster, PFM or HDR file
     under a .png name, as the loaders admit only the JAX package's
     extensions and cv2 reads by content),
     listed by a txt file 128 times over (labels this phase writes; the
     label scan decodes each file once), and val on 16 of them: per epoch
     the step ms, img/s, the loader-wait share; finite losses.
  14c. YoloTask.train() of v8s-cls (nc=10), 224x224, batch 32, 1 epoch on
     a folder-per-class set of copies of the same fixtures (16 train and 2
     val a class; every kind in the cycle): the decode on every get; the
     step ms and loader-wait share.
Library blocks no zoo model builds (phase 15; their 3x3 shapes, with
their activations, are also a shape group of phase 2, checked at B=2 in
float32, bfloat16 and float16 and timed at B=8 in bfloat16 and float16:
kernel / plain / F.conv2d / bound ms summed):
  15a-c. each of 24 blocks alone at the input shape a published
     configuration gives it: HGStem(32, 48) on 640x640 RGB, HGBlock(48,
     128, k=3, n=6) at 160x160, HGBlock(96, 512, k=3, n=6) at 80x80 and
     HGBlock(192, 1024, k=5, n=6, lightconv) at 40x40, RepC3(256, n=3) at
     80x80 and 40x40 (Ultralytics rtdetr-l.yaml); SCDown(256, 3, 2) at
     80x80 and C2fCIB(512, shortcut, lk) at 20x20 (yolov10s.yaml at width
     0.5); GhostConv(64, 3, 2) at 320x320 and C3Ghost(64) at 160x160
     (yolov8-ghost.yaml scale s); Focus(32, 3) on 640x640 RGB (YOLOv5
     v5.0 yolov5s.yaml); SPP(512, (5, 9, 13)) at 20x20 from 1024
     (yolov3-spp.yaml); C3TR(512) at 20x20 (yolov5s-transformer.yaml, 4
     heads, N = 400); Conv2, LightConv, ConvTranspose, DWConvTranspose2d,
     CBAM, C1, C2, C3x, RepVGGDW, AGLU and Index at v8s's P3 stage (128
     wide at 80x80), which no published config builds. Seeded as phase 3
     (ConvBN kernels x2.5, every BatchNorm's statistics jittered). (a)
     bf16 folded predict at B=8: the forward's ms (CUDA events, mean of
     10) and its conv kernel launches, equal to the block's list and to
     the count its modules give (the ReLU s1 and stem routes in HGStem /
     HGBlock, identity in RepC3's RepConvs, Ci = 12 in Focus; C2fCIB, a
     C2f of CIBs, must not take the C2f kernel); (b) float32 folded
     predict at B=2, card against CPU: max|d| <= 1e-4 max|ref|; (c) one
     float32 train-mode forward + backward at B=2 on the card and on the
     CPU, each against float64 on the card, per tensor ||d|| / ||ref||: the
     card's output within 1e-4 and the input's and every parameter's
     gradient within 1e-3, or within 4 times the CPU's own distance where
     that is larger (a train-mode BatchNorm's backward cancels); a
     gradient zero by construction (a shift a train-mode BN removes) must
     read under 1e-6 of the largest on both devices.
  15d. convert_checkpoint on the card's host: phase 3's seeded v8s state
     dict written by torch.save and as .safetensors, each converted to
     .bin in float32 and float16, loaded into a YoloTask and served phase
     3's b32 batch: the rows equal those of the directly loaded weights
     (float16: of the weights rounded to float16).
  15e. Config.profile_dir: YoloTask.train() of v8n-320 b8, one epoch of 6
     steps on 48 PNGs this script writes: the Chrome trace holds CUDA
     kernel events and the spans of steps 2-5.
  15f. int8_predict without calibration stats predicts the float rows
     (no int8 launch), as the JAX package does; fsdp,
     resume_format="orbax" and mesh_shape run (v8n-128 b8 train() of one
     epoch on 16 PNGs: FSDP over the visible cards, unsharded on one; the
     torch.distributed.checkpoint directory weights/last_state.dcp; the
     mesh shape read nowhere, at train() and at predict).

Several devices (phase 16, over N = torch.cuda.device_count() cards):
  16a. create_mesh() over the N cards: phase 2's rule on a handful of
     bf16 v8s / v12s shapes on every card but cuda:0; phase 3's v8s
     weights and conf served by batch_predict(mesh=) of 32 and of 33
     images (a padded shard) and predict_stream(mesh=) of 64, conv3x3 s1 /
     s2 and the C2f launched on every card (launches_by_device); the
     float32 rows of N + 1 images over the mesh against one forward on
     cuda:0 by phase 3's rule (0.5 px, 1e-3 score); bf16 b32 img/s on
     cuda:0 and over the mesh.
  16b. data-parallel training, NCCL over the N cards (N >= 2) or two gloo
     ranks sharing cuda:0 (N = 1, labelled so: no scaling number): a
     float32 v8n and v12n End2End step at 128x128, global batch 2 a rank,
     against the same step on cuda:0 by phase 6's rule (loss and items
     1e-4 relative; gradients 1e-3 of a tensor's largest, the zero-by-
     construction leaves under 1e-6 G; parameter changes where the
     gradients fix AdamW's update, within one float32 spacing more; BN
     statistics 1e-5 of (|ref| + max|ref|), a mean's scale at least its
     layer's largest standard deviation), the v12n attention kernel
     launched under autograd on every rank; then YoloTask.train() of v8s
     640 b16 bf16 over 2 epochs (1 on one card) on phase 7's PNG set over
     the ranks
     (torch.profiler over rank 0's steps 2-5): each rank's step ms, img/s,
     loader wait and peak memory, the collectives' ms a step, one log.csv
     and one set of weights.
  16c. one v8s float32 step under FSDP against the DP step by the same
     rule; each rank's sharded train-state bytes (masters, AdamW state,
     buffers, from the storage held) equal sharded_param_bytes, and each
     rank's peak CUDA memory in the step is below the DP step's.
  16d. two FSDP v8s steps over the ranks, the state saved after the first
     as a torch.distributed.checkpoint directory; cuda:0 alone reads it
     back (every network and AdamW tensor equal to the saved ones, bit for
     bit) and takes the second step: loss, items and BN statistics by the
     same rule against the uninterrupted run's (its parameter changes are
     printed: a second AdamW step no longer follows the gradient's sign).
  16e. graft_entry.entry() (the v8s-640 forward and decode) on the card;
     graft_entry.dryrun_multichip(2) on gloo CPU ranks.
int8 post-training quantisation (phase 17; its kernels replace no Pallas
kernel: the JAX int8_conv is XLA's int8 convolution):
  17a. the quantise pass and the int8 conv (csrc/int8_conv.cu) against
     their plain versions at every int8 shape of v8s-640, v12s-640, the
     v5us stem (6x6 / 2), v11s-pose's 51-wide towers and v8s-cls-224, B=2
     in float32, bfloat16 and float16 and B=32 in bfloat16: the quantise
     pass equal to the bit; the conv equal to the bit in float32 with the
     identity (float32 SiLU: phase 2's conv rule), and in bfloat16 /
     float16 within 1.25 u of a float64 evaluation of the same int32 sums
     (rounded where the plain version rounds, before the activation). The
     stems (route "stem": quantise and conv in one launch of
     csrc/stem.cuh's kernel) equal to their plain version (the plain
     quantise, then the plain conv) to the bit in every type, with the
     identity and SiLU, at the three stem shapes and at ragged ones.
     Timed at B=32 (CUDA graphs): conv kernel, quantise, the two, plain,
     the conv's float route today (the conv3x3 kernel or cuDNN) and
     torch._int_mm on the 1x1 stride-1 shapes (the same int32 sums in one
     PyTorch call; never used by the port); bound max(2 M N K / 1979e12,
     bytes / 3.35e12), K and the int8 bytes over the conv's Ci (the
     kernel's padded Cp printed beside it); sums per shape group. Each
     shape on its route (int8_route: the wgmma GEMM, the wgmma flat-row
     tile, the stem kernel, or mma.sync) and plan, timed beside the
     mma.sync kernel every shape took before the wgmma routes (on the stem
     route, beside that kernel and its quantise pass); sums per route, the
     redesigns' aims marked held or missed; first the 8-bit descriptor probe and the
     epilogue's SiLU against the IEEE-division SiLU at all 2^32 floats.
  17b. v8s-640: calibrate_int8 on the card over 16 of phase 7's PNGs and
     the same on the CPU (the same keys, absmax within 1e-4 relative);
     the bf16 b32 network forward float against int8 (CUDA events, in
     turns) with the int8 launches of one forward against the model's
     modules (no conv3x3 or C2f launch), batch_predict img/s of both and
     the share of float boxes the int8 boxes match (at least 0.7, the JAX
     facade test's rule); float32 int8 card against CPU: each int8
     ConvBN of the card holds the CPU's folded and int8 buffers to the
     bit and, fed the CPU net's input to it, gives the CPU's output
     (identity to the bit, SiLU phase 2's float32 conv rule), the
     head outputs of 4 images lie from the CPU int8's at most 1.0x and
     from the CPU float's at least 0.5x the CPU int8's distance from the
     CPU float's (INT8_CPU_FACTOR, INT8_FLOAT_FLOOR), and image_predict's
     rows match the CPU's by the same rule.
  17c. one int8 bf16 batch_predict at B=2 of v11m-seg, v11s-pose,
     v12x-obb and v8s-cls, calibrated on the batch, the launches against
     the model's modules.
  17d. where more than one card is visible, v8s int8 batch_predict over a
     mesh of them, the int8 conv launched on every card.
  An int8 kernel launched by any other phase, train or predict, fails the
  run.
Each phase prints its wall seconds.

``python3 chip_smoke.py --multi`` runs phase 1, phase 3's v8s slice and
phases 16a-d alone (for a machine of several cards); ``--dp-train`` runs
phase 1 and 16b's train() alone.

The run fails if jax, flax or the JAX package yolosharp_tpu was imported.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 2
BLOCK_BATCH = 8     # phase 15's bf16 predict batch, timed in phase 2 too
CANDIDATES = 300    # above-threshold anchors per image in phase 3 (bench.py:8-13)
CONV_CANVAS = (640, 640)
# the request canvases of phase 3 (500x375 pads to 512x384) and, for the
# attention only, v12s at 1280
CANVASES = ((640, 640), (480, 640), (512, 384), (1280, 1280))
# the batches and canvases of the served requests: phase 3 in bfloat16,
# phase 4 one 640x640 image in float32
SERVED_BATCH = 32
# phase 12's classify requests at 224 (b32 and single images in bfloat16,
# b32 in float16, b8 in float32), phase 13's streams (bfloat16 at b16,
# float32 at b3)
CLS_CANVAS = (224, 224)
STREAM_BATCH, STREAM_F32_BATCH = 16, 3
SERVED = {torch.bfloat16: ((SERVED_BATCH, 640, 640), (1, 640, 640),
                           (1, 480, 640), (1, 512, 384),
                           (SERVED_BATCH, 224, 224), (1, 224, 224),
                           (STREAM_BATCH, 640, 640),
                           (STREAM_BATCH, 224, 224)),
          torch.float16: ((SERVED_BATCH, 640, 640),
                          (SERVED_BATCH, 224, 224)),
          torch.float32: ((1, 640, 640), (8, 224, 224),
                          (STREAM_F32_BATCH, 640, 640),
                          (STREAM_F32_BATCH, 224, 224))}
HALF = (torch.bfloat16, torch.float16)
KINDS = ("s2", "s1", "c2f", "attn")
# float32: the conv kernels sum 9*Ci <= 4608 products in another order than
# cuDNN; the attention kernel as tests/test_pallas_attention.py. bfloat16:
# the JAX package's own bf16 criterion (max error / max |reference| < 1e-2,
# tests/test_pallas_conv.py), doubled for the C2f block, whose four layers
# round to bf16 at different points in the two versions; float16 (three
# more mantissa bits) is held to the same rule.
TOL_F32 = {"conv": (1e-4, 1e-4), "c2f": (1e-4, 1e-4), "attn": (2e-5, 2e-4)}
# the roofline of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor
# cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
HBM_BYTES = 3.35e12
# bfloat16 and float16: the kernel against a float64 evaluation of the
# plain version on the same rounded inputs, max|k - ref| / max|ref| in
# units of the type's unit roundoff u. The conv kernels sum in float32 and
# round their output once (at most u; 1.25 u leaves room for the float32
# sums and SiLU); the attention rounds P and its output (2.5 u); the C2f
# block rounds every intermediate where its plain chain does, so it is
# held to twice the plain chain's own distance from float64. The bounds
# follow from where each version rounds, not from the inputs drawn.
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
TOL16 = {"conv": 1.25, "attn": 2.5}
C2F_VS_PLAIN = 2.0
SOURCES = {
    "conv3x3_silu": ("yolosharp_tpu_torch/csrc/conv3x3.cu",
                     "yolosharp_tpu/kernels/conv3x3.py:112"),
    "conv3x3s2_silu": ("yolosharp_tpu_torch/csrc/conv3x3.cu",
                       "yolosharp_tpu/kernels/conv3x3.py:198"),
    "c2f_fused": ("yolosharp_tpu_torch/csrc/c2f.cu",
                  "yolosharp_tpu/kernels/c2f.py:138"),
    "fused_attention": ("yolosharp_tpu_torch/csrc/attention.cu",
                        "yolosharp_tpu/kernels/attention.py:57"),
}
# phase 17's int8 kernels: no Pallas kernel behind them (the JAX int8_conv
# is XLA's int8 convolution)
INT8_SOURCES = {
    "quantize_int8": ("yolosharp_tpu_torch/csrc/int8_conv.cu",
                      "yolosharp_tpu/nn/common.py:635 (int8_conv's "
                      "quantise, XLA; no Pallas kernel)"),
    "int8_conv": ("yolosharp_tpu_torch/csrc/int8_conv.cu",
                  "yolosharp_tpu/nn/common.py:635 (int8_conv, XLA's int8 "
                  "convolution; no Pallas kernel)"),
}
# the attention's backward: no Pallas kernel behind it (the JAX custom
# VJP's backward is einsum code); launched by every 16-bit v12 train step
BWD_SOURCES = {
    "fused_attention_bwd": ("yolosharp_tpu_torch/csrc/attention_bwd.cu",
                            "yolosharp_tpu/kernels/attention.py:100 "
                            "(_pallas_attn_bwd, einsum code; no Pallas "
                            "kernel)"),
}
# every kernel wrapper that counts launches (kernels.KERNELS)
ALL_KERNELS = (*SOURCES, *BWD_SOURCES, *INT8_SOURCES)
OBB = "v12x-obb"
CLS, CLS11 = "v8s-cls", "v11s-cls"
# the kernels each path must launch (and no other)
PATHS = {"v8": ("conv3x3_silu", "conv3x3s2_silu", "c2f_fused"),
         "v12": ("conv3x3_silu", "conv3x3s2_silu", "fused_attention"),
         "v11": ("conv3x3_silu", "conv3x3s2_silu"),
         "v5u": ("conv3x3_silu", "conv3x3s2_silu"),
         "v11m-seg": ("conv3x3_silu", "conv3x3s2_silu"),
         "v11m-pose": ("conv3x3_silu", "conv3x3s2_silu"),
         "v11s-pose": ("conv3x3_silu", "conv3x3s2_silu"),
         OBB: ("conv3x3_silu", "conv3x3s2_silu", "fused_attention"),
         CLS: ("conv3x3_silu", "conv3x3s2_silu", "c2f_fused"),
         CLS11: ("conv3x3_silu", "conv3x3s2_silu")}
# each path's model: (version, size, task)
ARCH = {"v8": ("v8", "s", "detect"), "v12": ("v12", "s", "detect"),
        "v11": ("v11", "s", "detect"), "v5u": ("v5u", "s", "detect"),
        "v11m-seg": ("v11", "m", "segment"),
        "v11m-pose": ("v11", "m", "pose"), "v11s-pose": ("v11", "s", "pose"),
        OBB: ("v12", "x", "obb"),
        CLS: ("v8", "s", "classify"), CLS11: ("v11", "s", "classify")}
SEG, POSE, POSE_S = "v11m-seg", "v11m-pose", "v11s-pose"
# each path's classes: COCO's 80, COCO-Pose's one (person) for the pose
# models (Ultralytics yolo11-pose.yaml: nc 1, kpt_shape [17, 3]), DOTA's 15
# for the OBB model (the JAX bench's workload 5, bench.py:292-354),
# ImageNet's 1000 for the classify models (Ultralytics yolov8-cls.yaml)
PATH_NC = {POSE: 1, POSE_S: 1, OBB: 15, CLS: 1000, CLS11: 1000}
PHASE = {"v8": "3", "v12": "3b", "v11": "3c", "v5u": "3d", SEG: "9a",
         POSE: "10a", POSE_S: "10a", OBB: "11a", CLS: "12a", CLS11: "12a"}
# the paths held card against CPU in float32 (phases 4, 4b, 4c, 9b, 10b,
# 11b)
CPU_MATCH = {"v8": "4", "v12": "4b", "v11": "4c", SEG: "9b", POSE: "10b",
             OBB: "11b"}
# phase 2's sums over a group of shapes: (name, which (shape, paths) it
# holds): v11m-seg's and v11m-pose's shapes, v11s-pose's odd ones (its
# keypoint towers are 51 wide), and v12x-obb's (no other path takes them)
SHAPE_GROUPS = ((SEG, lambda shape, vs: SEG in vs),
                (POSE, lambda shape, vs: POSE in vs),
                (f"{POSE_S} Ci/Co = 51",
                 lambda shape, vs: POSE_S in vs and 51 in shape[2:4]),
                (OBB, lambda shape, vs: OBB in vs),
                (f"{CLS} / {CLS11} 224", lambda shape, vs: CLS in vs
                 or CLS11 in vs),
                ("phase 15 blocks", lambda shape, vs: vs[0] in BLOCK_NAMES))
# the suffix of each (dtype, batch) phase 2 times, in its stats
SUFFIX = {(torch.float32, BATCH): "_f32", (torch.bfloat16, BATCH): "",
          (torch.float16, BATCH): "_f16",
          (torch.float32, SERVED_BATCH): "_f32_b32",
          (torch.bfloat16, SERVED_BATCH): "_b32",
          (torch.float16, SERVED_BATCH): "_f16_b32",
          (torch.bfloat16, BLOCK_BATCH): "_b8",
          (torch.float16, BLOCK_BATCH): "_f16_b8"}
CONV_NAMES = ("conv3x3_silu", "conv3x3s2_silu")
# phase 2's ragged 16-bit stems (the card tests' shapes): (kind, (H, W, Ci,
# Co), activation)
STEM_RAGGED = (("s1", (17, 23, 3, 16), "silu"), ("s2", (17, 23, 3, 16), "relu"),
               ("s1", (9, 33, 3, 70), "silu"), ("s2", (9, 33, 3, 70), "identity"),
               ("s2", (9, 33, 7, 70), "silu"))
# the stats suffix of each (dtype, batch) phase 2 times
ERR_KEY = {torch.float32: "max_abs_err", torch.bfloat16: "max_abs_err_bf16",
           torch.float16: "max_abs_err_f16"}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def time_calls(fns: dict, iters: int = 10):
    """({name: device ms per call}, {name: eager ms per call}), CUDA events
    around iters calls, in turns forward then backward (plain / kernel /
    library / library / kernel / plain). Device: the iters calls replayed
    as one CUDA graph, so the time is the device's alone. Eager: the calls
    made from Python, where at small shapes the host's launch cost (the
    wrappers' checks and ctypes, ~50-90 us a call) is what is measured."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    graphs = {}
    for name, fn in fns.items():
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(iters):
                fn()
    out = []
    for run in ((lambda n: graphs[n].replay()),
                (lambda n: [fns[n]() for _ in range(iters)])):
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(name)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
        out.append({name: float(np.mean(t)) for name, t in times.items()})
    del graphs
    return out[0], out[1]


def bound(flop: int, nbytes: int, dtype):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    ops = flop / PEAK_FLOPS[dtype] * 1e3
    mem = nbytes / HBM_BYTES * 1e3
    return max(ops, mem), ("bytes" if mem >= ops else "operations")


def compare(name, got, want, dtype, kind, ref):
    """Kernel (got) against plain (want) at the rule of its type; ref is
    the plain version evaluated in float64 on the same inputs. Returns
    max|k-p|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs = float(err.max())
    top = float(ref.abs().max()) + 1e-12
    dk = float((got.double() - ref).abs().max()) / top
    dp = float((want.double() - ref).abs().max()) / top
    finite = bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        atol, rtol = TOL_F32[kind]
        bad = int((err > atol + rtol * want.abs()).sum())
        ok = bad == 0 and finite
        rule = f"|k-p| <= {atol} + {rtol}|p| ({bad} outside)"
    else:   # bfloat16 and float16
        u = UNIT[dtype]
        limit = C2F_VS_PLAIN * dp if kind == "c2f" else TOL16[kind] * u
        ok = dk <= limit and finite
        rule = (f"vs float64 kernel {dk / u:.3f} u, plain {dp / u:.3f} u "
                f"(u = 2^{int(np.log2(u))}); kernel <= "
                + (f"{C2F_VS_PLAIN} x plain" if kind == "c2f"
                   else f"{TOL16[kind]} u"))
    print(f"  {name}: max_abs_err {max_abs:.3e} {rule} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if dtype == torch.float32:
        print(f"    vs float64 (max|v - ref| / max|ref|): kernel {dk:.3e}, "
              f"plain {dp:.3e}", flush=True)
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return max_abs


@torch.no_grad()
def record_shapes(path: str) -> dict:
    """The shapes each kernel of one path takes on each canvas, from forward
    hooks on the path's folded net (ARCH) run at B=1 on the CPU (the routing
    is the same as on the card; the CPU runs the plain versions and launches
    nothing): {(h, w): {"s1" / "s2": {(H, W, Ci, Co)},
    "c2f": {(H, W, Cin, c, C2)}, "attn": {(areas, heads, N, D)}}}. The
    classify models at CLS_CANVAS only."""
    from yolosharp_tpu_torch.ckpt import fold_bn
    from yolosharp_tpu_torch.nn import AAttn, ArchCfg, C2f, ConvBN, YoloNet

    version, size, task = ARCH[path]
    net = fold_bn(YoloNet(ArchCfg(version=version, size=size, task=task,
                                  nc=PATH_NC.get(path, 80))).eval())
    shapes = {}

    def conv_hook(m, inp, out):
        _, ci, h, w = inp[0].shape
        shapes[f"s{m.s}"].add((h, w, ci, m.conv.out_channels))

    def c2f_hook(m, inp, out):
        _, cin, h, w = inp[0].shape
        shapes["c2f"].add((h, w, cin, m.c, m.cv2.conv.out_channels))

    def attn_hook(m, inp, out):
        _, _, h, w = inp[0].shape
        shapes["attn"].add((m.area, m.num_heads, h * w // m.area,
                            m.head_dim))

    for m in net.modules():
        if isinstance(m, ConvBN) and m.kernel_route:
            m.register_forward_hook(conv_hook)
        elif isinstance(m, C2f) and m.fused_weights:
            m.register_forward_hook(c2f_hook)
        elif isinstance(m, AAttn):
            m.register_forward_hook(attn_hook)
    by_canvas = {}
    canvases = (CANVASES if path == "v12" else [CLS_CANVAS]
                if task == "classify" else CANVASES[:-1])
    for h, w in canvases:
        # the hooks fill this canvas's sets
        shapes = by_canvas[(h, w)] = {k: set() for k in KINDS}
        net(torch.zeros(1, 3, h, w).contiguous(
            memory_format=torch.channels_last))
    return by_canvas


def stem_variant(plan) -> str:
    """A stem plan (kernels/conv3x3.py StemPlan) as phases 2 and 17a print
    it."""
    return (f"stem tile {plan.rows}x{32 * plan.strips} ring {plan.ring} "
            f"blocks/SM {plan.blocks} cg {plan.cg}")


def variant(kind, dtype, batch, shape, sms) -> str:
    """What the launch picks for one call, as the wrappers pick it for a
    card of sms SMs: the 16-bit conv's N tile and its block's output rows x
    columns (or its stem plan), the float32 conv's tile and split, the
    C2f block's plan (its shape class, K chunk, N tile, m64 subtiles a
    warpgroup and 3x3 tile; no cluster: one block an SM) or float32 plan
    (each GEMM's N tile and split, the 3x3 tile), the attention's route by
    type and its splits, staged keys and warps; '' where the kernel is the
    same for every call."""
    from yolosharp_tpu_torch.kernels.attention import (f32_geometry,
                                                       launch_geometry)
    from yolosharp_tpu_torch.kernels.c2f import (c2f_plan, f32_c2f_plan,
                                                 plan_class)
    from yolosharp_tpu_torch.kernels.conv3x3 import (conv_plan, f32_plan,
                                                     f32_tile, padded)

    half = dtype in HALF
    if kind in ("s1", "s2") and half:
        H, W, ci, co = shape
        if ci <= 7:
            return stem_variant(conv_plan(batch, H, W, ci, co, int(kind[1]),
                                          sms))
        bn, rows, wt = conv_plan(batch, H, W, padded(ci), padded(co),
                                 int(kind[1]), sms)
        return f"BN {bn} tile {rows}x{wt}"
    if kind in ("s1", "s2"):
        H, W, ci, co = shape
        tn, sw, splits = f32_plan(batch, H, W, ci, co, int(kind[1]), sms)
        th, tw = f32_tile(tn, sw)
        return (f"f32 {'stem ' if ci <= 4 else ''}TN {tn} tile {th}x{tw} "
                f"splits {splits}")
    if kind == "c2f":
        H, W, cin, c, c2 = shape
        if not half:
            p = f32_c2f_plan(batch, H, W, cin, c, c2, sms)
            return (f"c={c} f32: cv1 TN {p.cv1.tn} splits {p.cv1.splits}, "
                    f"3x3 TN {p.m.tn} tile {p.m.rows}x{p.m.wt} splits "
                    f"{p.m.splits}, cv2 TN {p.cv2.tn} splits {p.cv2.splits}")
        bk, bn, ms, rows, wt = c2f_plan(batch, H, W, cin, c, c2, sms)
        return (f"c={c} {plan_class(c)}: BK {bk} BN {bn} MS {ms} tile "
                f"{rows}x{wt}, cluster 1")
    if kind == "attn":
        areas, nh, n, d = shape
        if not half:
            splits, keys, warps, group = f32_geometry(batch * areas * nh, n,
                                                      d, sms)
            return (f"f32 splits {splits} keys {keys} warps {warps} "
                    f"group {group}")
        splits, keys, warps = launch_geometry(batch * areas * nh, n, d, sms)
        return f"mma.sync splits {splits} keys {keys} warps {warps}"
    return ""


def phase_kernels(dev):
    from yolosharp_tpu_torch.kernels import (attention_bihd, attention_plain,
                                             c2f_fused, c2f_plain,
                                             conv3x3_plain, conv3x3_silu,
                                             conv3x3s2_silu, fused_attention)

    print(f"phase 2: kernels against their plain versions: every shape at "
          f"B={BATCH} in float32, bfloat16 and float16, the batch-32 shapes "
          f"in bfloat16 and float16, then any tile the served requests take "
          f"that was not checked yet", flush=True)
    print("  torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False", flush=True)
    recorded = {v: record_shapes(v) for v in PATHS}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def union(kind, canvases):
        """[(shape, [paths])] that kind takes on these canvases."""
        tagged = {}
        for v, by_canvas in recorded.items():
            for cv in canvases:
                for s in by_canvas.get(cv, {}).get(kind, ()):
                    tagged.setdefault(s, []).append(v)
        return sorted(((s, sorted(set(vs), key=list(PATHS).index))
                       for s, vs in tagged.items()),
                      key=lambda t: (-t[0][0], t[0]))

    # the convs and the C2f block at 640x640 and the classify models' 224x224;
    # the attention on every canvas
    conv_canvases = [CONV_CANVAS, CLS_CANVAS]
    shapes = {k: union(k, CANVASES if k == "attn" else conv_canvases)
              for k in KINDS}
    for kind in KINDS:
        print(f"  {kind} shapes recorded: " + ", ".join(
            f"{s} {'+'.join(vs)}" for s, vs in shapes[kind]), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    stats = {}
    for name in SOURCES:
        s = stats[name] = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0,
                           "max_abs_err_f16": 0.0, "shapes": 0}
        for (_, batch), suffix in SUFFIX.items():
            if batch == BLOCK_BATCH and name not in CONV_NAMES:
                continue    # only the conv kernels take phase 15's shapes
            s.update({"ms" + suffix: 0.0, "plain_ms" + suffix: 0.0,
                      "ms_eager" + suffix: 0.0, "bound_ms" + suffix: 0.0,
                      "library_ms" + suffix: None if name == "c2f_fused"
                      else 0.0})
    # per kernel and sum: the bound ms that bytes / operations set
    bound_parts = {}
    # per shape group (SHAPE_GROUPS), kernel and sum: (shapes, kernel,
    # plain, library and bound ms)
    group_sums = {}
    checked = set()     # (kind, dtype, variant) held against the plain version
    # the convs' bf16 b32 rows: (name, shape, variant, kernel, plain, library,
    # bound ms)
    conv_rows = []
    # the 16-bit stems' rows (Ci <= 7): (dtype, batch, name, shape, variant,
    # kernel, plain, library, bound ms)
    stem_rows = []

    def check(kind, dtype, batch, shape, vs, timed=True, act="silu"):
        """One kernel against its plain version at one shape (the convs
        with activation act): its error, the variant it ran and (timed)
        its, the plain version's and the library call's times, TFLOP/s and
        its bound."""
        dt = str(dtype)[6:]
        var = variant(kind, dtype, batch, shape, sms)
        extra = library = None
        size = torch.finfo(dtype).bits // 8
        if kind in ("s1", "s2"):
            stride = int(kind[1])
            wrapper = conv3x3_silu if stride == 1 else conv3x3s2_silu
            H, W, ci, co = shape
            x = randn(batch, H, W, ci).to(dtype)
            w = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5).to(dtype)
            b = randn(co, scale=0.1).to(dtype)
            name, tol = wrapper.__name__, "conv"
            desc = f"{H}x{W} {ci}->{co}" + (f" {act}" if act != "silu" else "")
            kernel = lambda: wrapper(x, w, b, act)  # noqa: E731
            plain = lambda: conv3x3_plain(x, w, b, act, stride)  # noqa: E731
            ref64 = lambda: conv3x3_plain(  # noqa: E731
                x.double(), w.double(), b.double(), act, stride)
            ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
            flop = 2 * batch * ho * wo * 9 * ci * co
            nbytes = size * (x.numel() + w.numel() + co + batch * ho * wo * co)
            # cuDNN on the channels-last NCHW view: conv + bias, no
            # activation
            xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            library = lambda: F.conv2d(xc, wc, b, stride=stride,  # noqa: E731
                                       padding=1)
        elif kind == "c2f":
            H, W, cin, c, c2 = shape
            args = [randn(batch, H, W, cin),
                    randn(cin, 2 * c, scale=cin ** -0.5),
                    randn(2 * c, scale=0.1),
                    randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                    randn(c, scale=0.1),
                    randn(3, 3, c, c, scale=(9 * c) ** -0.5),
                    randn(c, scale=0.1),
                    randn(3 * c, c2, scale=(3 * c) ** -0.5),
                    randn(c2, scale=0.1)]
            args = [a.to(dtype) for a in args]
            name, tol, desc = "c2f_fused", "c2f", f"{H}x{W} {cin}/{c}/{c2}"
            kernel = lambda: c2f_fused(*args)  # noqa: E731
            plain = lambda: c2f_plain(*args)  # noqa: E731
            ref64 = lambda: c2f_plain(*[a.double() for a in args])  # noqa
            # the block's GEMMs: cv1, the two 3x3s, cv2 over the concat
            flop = 2 * batch * H * W * (cin * 2 * c + 18 * c * c + 3 * c * c2)
            nbytes = size * (sum(a.numel() for a in args) + batch * H * W * c2)
        else:
            # as AAttn hands them over: strided q, k, v of one (B, N, H, 3D)
            # qkv tensor, B = batch images x areas
            areas, nh, n, d = shape
            qkv = randn(batch * areas, n, nh, 3 * d).to(dtype)
            q, k, v = qkv.split(d, dim=-1)
            bhnd = [t.transpose(1, 2) for t in (q, k, v)]
            scale = d ** -0.5
            name, tol = "fused_attention", "attn"
            desc = f"({batch * areas}, {nh}, {n}, {d})"
            kernel = lambda: attention_bihd(q, k, v, scale)  # noqa: E731
            plain = lambda: attention_plain(  # noqa: E731
                *bhnd, scale).transpose(1, 2)
            ref64 = lambda: attention_plain(  # noqa: E731
                *[t.double() for t in bhnd], scale).transpose(1, 2)
            extra = fused_attention(*[t.contiguous() for t in bhnd], scale)
            flop = 4 * batch * areas * nh * n * n * d   # q k^T and p v
            nbytes = size * (qkv.numel() + qkv.numel() // 3)   # qkv and o
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *bhnd, scale=scale)
        got, want, ref = kernel(), plain(), ref64()
        torch.cuda.synchronize()
        tag = (f"{name} {dt} B={batch} {desc}" + (f" [{var}]" if var else "")
               + f" [{'+'.join(vs)}]")
        err = compare(tag, got, want, dtype, tol, ref)
        if kind in ("s1", "s2", "c2f") and dtype == torch.float32:
            # no atomics, the splits added in a fixed order: the same bits
            # from one run to the next
            again = kernel()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise SystemExit(f"{tag}: two runs of the float32 kernel "
                                 f"differ")
        if extra is not None:
            compare(tag + " contiguous (B, H, N, D)", extra,
                    want.transpose(1, 2), dtype, tol, ref.transpose(1, 2))
        del ref
        checked.add((kind, dt, var))
        s = stats[name]
        s[ERR_KEY[dtype]] = max(s[ERR_KEY[dtype]], err)
        if not timed:
            return
        fns = {"plain": plain, "kernel": kernel}
        if library is not None:
            fns["library"] = library
        t, eager = time_calls(fns)
        ms, plain_ms = t["kernel"], t["plain"]
        bound_ms, by = bound(flop, nbytes, dtype)
        lib = (f"{t['library']:.4f} ms library"
               if library is not None else "no library call")
        print(f"    device (CUDA graph): {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain, {lib}; bound {bound_ms:.4f} ms by {by} "
              f"({nbytes / 1e6:.2f} MB, {flop / 1e9:.3f} GFLOP), "
              f"{bound_ms / ms:.3f} of it; {flop / ms / 1e9:.1f} / "
              f"{flop / plain_ms / 1e9:.1f} TFLOP/s", flush=True)
        print("    eager: " + ", ".join(f"{v:.4f} ms {k}"
                                        for k, v in eager.items()),
              flush=True)
        suffix = SUFFIX[(dtype, batch)]
        s["ms" + suffix] += ms
        s["plain_ms" + suffix] += plain_ms
        s["ms_eager" + suffix] += eager["kernel"]
        s["bound_ms" + suffix] += bound_ms
        if library is not None:
            s["library_ms" + suffix] += t["library"]
        part = bound_parts.setdefault((name, suffix), {})
        part[by] = part.get(by, 0.0) + bound_ms
        if suffix == "":
            s["shapes"] += 1
        if suffix == "_b32" and kind in ("s1", "s2"):
            conv_rows.append((name, desc, var, ms, plain_ms, t["library"],
                              bound_ms))
        if kind in ("s1", "s2") and shape[2] <= 7 and dtype in HALF:
            stem_rows.append((dtype, batch, name, desc, var, ms, plain_ms,
                              t["library"], bound_ms))
        for group, holds in SHAPE_GROUPS:
            if not holds(shape, vs):
                continue
            acc = group_sums.setdefault((group, name, suffix),
                                        [0, 0.0, 0.0, 0.0, 0.0])
            acc[0] += 1
            for j, v in enumerate((ms, plain_ms, t.get("library", 0.0),
                                   bound_ms), 1):
                acc[j] += v

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for kind in KINDS:
            for shape, vs in shapes[kind]:
                check(kind, dtype, BATCH, shape, vs)
    for dtype in HALF:
        print(f"  {str(dtype)[6:]} at B={SERVED_BATCH}, the shapes of the "
              f"served batch_predict", flush=True)
        for kind in KINDS:
            for shape, vs in union(kind, conv_canvases):
                check(kind, dtype, SERVED_BATCH, shape, vs)
    print(f"  float32 at B={SERVED_BATCH}, the classify shapes at 224",
          flush=True)
    for kind in KINDS:
        for shape, vs in union(kind, [CLS_CANVAS]):
            check(kind, torch.float32, SERVED_BATCH, shape, vs)
    # every (kind, dtype, variant) the served requests take, at the first
    # request that takes it
    served = {}
    for dtype, requests in SERVED.items():
        for batch, h, w in requests:
            for kind in KINDS:
                for shape, vs in union(kind, [(h, w)]):
                    served.setdefault(
                        (kind, str(dtype)[6:],
                         variant(kind, dtype, batch, shape, sms)),
                        (dtype, batch, shape, vs))
    missing = [key for key in served if key not in checked]
    print(f"  variants the served requests take: {len(served)}, not yet "
          f"checked: {len(missing)}", flush=True)
    for key in missing:
        check(key[0], *served[key], timed=False)
    if any(key not in checked for key in served):
        raise SystemExit("a variant of the served path was not checked")
    # phase 15's blocks: their 3x3 shapes with their activations (relu in
    # HGStem and HGBlock, identity in RepC3's RepConvs, Ci = 12 in Focus)
    blocks = record_block_shapes()
    print("  phase 15 block shapes recorded: " + ", ".join(
        f"{k} {s} {a} [{' + '.join(vs)}]" for (k, s, a), vs in blocks),
        flush=True)
    for dtype, batch in ((torch.float32, BATCH), (torch.bfloat16, BATCH),
                         (torch.float16, BATCH),
                         (torch.bfloat16, BLOCK_BATCH),
                         (torch.float16, BLOCK_BATCH)):
        print(f"  phase 15 block shapes, {str(dtype)[6:]} B={batch}",
              flush=True)
        for (kind, shape, act), vs in blocks:
            check(kind, dtype, batch, shape, vs, act=act)
    # the card tests' ragged stems (tests/test_torch_cuda.py): maps neither
    # 16 nor 32 divides, Co = 16 and 70 (the output's odd 16-byte units),
    # Ci = 7 (a row wider than a TMA box: the plain loads)
    print("  the 16-bit stem at the card tests' ragged shapes, B=3",
          flush=True)
    for dtype in HALF:
        for kind, shape, act in STEM_RAGGED:
            check(kind, dtype, 3, shape, ["ragged"], timed=False, act=act)
    print("  the 16-bit stems (Ci <= 7, csrc/stem.cuh), device ms: kernel / "
          "plain / F.conv2d / bound (the kernel's share of its bound)",
          flush=True)
    stem_sums = {}
    for dt, batch, name, desc, var, k, p, lib, bnd in stem_rows:
        print(f"    {name} {str(dt)[6:]} B={batch} {desc} [{var}]: {k:.4f} / "
              f"{p:.4f} / {lib:.4f} / {bnd:.4f} ({bnd / k:.3f})", flush=True)
        acc = stem_sums.setdefault((str(dt)[6:], batch), [0, 0.0, 0.0, 0.0,
                                                          0.0])
        for j, v in enumerate((1, k, p, lib, bnd)):
            acc[j] += v
    for (dt, batch), (n, k, p, lib, bnd) in sorted(stem_sums.items()):
        print(f"    stems {dt} B={batch}: {n} shapes, summed {k:.4f} / "
              f"{p:.4f} / {lib:.4f} / {bnd:.4f} ({bnd / k:.3f})", flush=True)
    print("  the convs' bfloat16 B=32 rows, device ms: kernel / plain / "
          "F.conv2d / bound, and the kernel against F.conv2d", flush=True)
    for name, desc, var, k, p, lib, bnd in conv_rows:
        print(f"    {name} {desc} [{var}]: {k:.4f} / {p:.4f} / {lib:.4f} / "
              f"{bnd:.4f}, {'beats' if k < lib else 'loses to'} F.conv2d "
              f"({k / lib:.3f}x)", flush=True)
    # what bounds each sum: the larger share of its bound
    for (name, suffix), part in bound_parts.items():
        stats[name]["bound_by" + suffix] = max(part, key=part.get)
    for (group, name, suffix), (n, k, p, lib, bnd) in sorted(
            group_sums.items()):
        print(f"  {group} shapes, {name}{suffix or '_bf16'}: {n} shapes, "
              f"device ms summed: kernel {k:.4f}, plain {p:.4f}, library "
              f"{lib:.4f}, bound {bnd:.4f}", flush=True)
    return stats


def synthetic_images(n, h, w, seed):
    """Smooth blobs plus noise, uint8 RGB, made from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        low = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        img = np.kron(low, np.ones((16, 16, 1), np.float32))[:h, :w]
        img += rng.normal(0, 20, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@torch.no_grad()
def seed_weights(net, seed: int = 3, scale: float = 2.5):
    """Random weights that give NMS-visible detections, the recipe of
    tests/test_golden_bus_predict.py:115-137: ConvBN kernels x `scale`
    (2.5; the segment head's Proto and cv4 towers and the pose head's cv4
    towers included), the head's final convs (box, class, a segment head's mask
    coefficients and a pose head's keypoints; a classify head's Linear)
    re-drawn from U(-0.3, 0.3), and BN statistics (and the conv biases of
    biased ConvBNs) jittered so that folding does real work."""
    from yolosharp_tpu_torch.ckpt import clone_one2one
    from yolosharp_tpu_torch.nn import ConvBN

    rng = np.random.default_rng(seed)

    def noise(t, fn):
        return torch.from_numpy(fn(t.shape).astype(np.float32)).to(t)

    for m in net.modules():
        if isinstance(m, ConvBN):
            m.conv.weight.mul_(scale)
            if m.conv.bias is not None:
                m.conv.bias.add_(noise(m.conv.bias,
                                       lambda s: rng.normal(0, 0.1, s)))
            m.bn.running_mean.add_(noise(m.bn.running_mean,
                                         lambda s: rng.normal(0, 0.05, s)))
            m.bn.running_var.mul_(noise(m.bn.running_var,
                                        lambda s: rng.uniform(0.8, 1.5, s))
                                  ).add_(0.02)
    head = net.model[-1]
    if hasattr(head, "linear"):
        finals = [head.linear]
    else:
        towers = [head.cv2, head.cv3] + ([head.cv4] if hasattr(head, "cv4")
                                         else [])
        finals = [branch[2] for tower in towers for branch in tower]
    for final in finals:
        for p in (final.weight, final.bias):
            p.copy_(noise(p, lambda s: rng.uniform(-0.3, 0.3, s)))
    clone_one2one(net)


def match(got, want):
    """Rows (boxes, scores, classes) of got against want: counts within 2
    (threshold-edge flips), each wanted row within 0.5 px and 1e-3 score.
    Returns (n_want, n_got, unmatched)."""
    gb, gs, gc = got
    wb, ws, wc = want
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, s, c in zip(wb, ws, wc):
        if not len(gb):
            unmatched += 1
            continue
        d = np.abs(gb - b).max(1) + 1e3 * (gc != c)
        j = int(np.argmin(d + 1e6 * used))
        if d[j] < 0.5 and abs(gs[j] - s) < 1e-3:
            used[j] = True
        else:
            unmatched += 1
    return len(wb), len(gb), unmatched


def rows_of(task, out, conf, i=0):
    """(boxes, scores, classes) of image i of a host predict output."""
    t = task.task
    if isinstance(out, dict):       # a segment output: rows and proto
        out = out["rows" if t.arch.end2end else "nms"]
    return t._rows(out, i, conf)[:3]


def path_name(path) -> str:
    """A path's model as the log names it: v8s ... v5us, v11m-seg, ..."""
    return path if "-" in path else f"{path}s"


def path_config(path, **cfg):
    """The Config of a path's model (ARCH) and classes (PATH_NC, unless
    cfg names number_class)."""
    from yolosharp_tpu_torch import Config, TaskType, YoloSize, YoloType

    version, size, task = ARCH[path]
    cfg = {"number_class": PATH_NC.get(path, 80), **cfg}
    return Config(task_type=TaskType(task), yolo_type=YoloType(version),
                  yolo_size=YoloSize(size), **cfg)


def build_tasks(dev, path, state, **cfg):
    from yolosharp_tpu_torch import YoloTask

    tasks = {}
    for e2e in (False, True):
        task = YoloTask(path_config(path, end2end=e2e, nms_pre_topk=512,
                                    **cfg), device=dev)
        net = task.task._ensure_variables()
        net.load_state_dict({k: v for k, v in state.items()
                             if e2e or "one2one" not in k}, strict=True)
        tasks[e2e] = task
    return tasks


def check_path_launches(version, counts, mode):
    """The path's kernels launched, and no other kernel."""
    for name in ALL_KERNELS:
        if (counts.get(name, 0) > 0) != (name in PATHS[version]):
            raise SystemExit(f"[{mode}] {name} launched "
                             f"{counts.get(name, 0)} times; the {version} "
                             f"path takes {PATHS[version]}")


def check_keypoints(results, mode):
    """Each pose result carries 17 KeyPoints with finite x, y and a
    visibility in [0, 1]."""
    bad = [(i, r.keypoints) for i, rs in enumerate(results) for r in rs
           if r.keypoints is None or len(r.keypoints) != 17
           or not all(np.isfinite([p.x, p.y, p.visibility]).all()
                      and 0.0 <= p.visibility <= 1.0 for p in r.keypoints)]
    if bad:
        raise SystemExit(f"[{mode}] keypoints not 17 finite: {bad[:1]}")


def check_masks(results, images, mode):
    """Each segment result carries a bool mask of its image's (h, w)."""
    bad = [(i, r.mask if r.mask is None else (r.mask.shape, r.mask.dtype))
           for i, (rs, im) in enumerate(zip(results, images)) for r in rs
           if r.mask is None or r.mask.shape != im.shape[:2]
           or r.mask.dtype != np.bool_]
    if bad:
        raise SystemExit(f"[{mode}] masks not (h, w) bool: {bad[:3]}")


# the head computes the angle (sigmoid - 0.25) pi in the compute dtype, as
# the JAX package does: in bfloat16 its ends round by up to half a step of
# [2, 4) (3 pi / 4 = 2.3562 rounds to 2.359375)
ANGLE_SLACK = 2.0 ** -7


def check_rotated(results, mode):
    """Each OBB result is a rotated box with w, h > 0 and an angle in the
    head's range [-pi/4, 3pi/4), widened by ANGLE_SLACK for bfloat16's
    rounding of its ends."""
    bad = [(i, r) for i, rs in enumerate(results) for r in rs
           if not (r.width > 0 and r.height > 0
                   and -np.pi / 4 - ANGLE_SLACK <= r.radian
                   <= 3 * np.pi / 4 + ANGLE_SLACK)]
    if bad:
        raise SystemExit(f"[{mode}] rotated rows out of range: {bad[:2]}")


def expected_launches(net, skip_one2many=False) -> dict:
    """The kernel launches one forward of a folded net makes, derived from
    its modules: each C2f block on the fused route launches the C2f kernel
    once (and its own convs none), each int8 ConvBN the int8 conv once and,
    but for a stem (route "stem": it quantises in the conv's own launch),
    the quantise pass once, each other 3x3 ConvBN on the kernel route its
    stride's conv kernel once and each AAttn the attention once;
    an End2End net's forward with skip_one2many (End2End predict) does not
    run the head's one2many towers (cv2, cv3, cv4)."""
    from yolosharp_tpu_torch.nn import AAttn, C2f, ConvBN

    head = f"model.{len(net.model) - 1}.cv"
    skip = skip_one2many and getattr(net.model[-1], "end2end", False)
    out = dict.fromkeys(ALL_KERNELS, 0)
    fused = [name + "." for name, m in net.named_modules()
             if isinstance(m, C2f) and m.fused_weights]
    out["c2f_fused"] = len(fused)
    for name, m in net.named_modules():
        if (skip and name.startswith(head)) or name.startswith(tuple(fused)):
            continue
        if isinstance(m, ConvBN) and m.i8_w is not None:
            out["quantize_int8"] += m.int8_route != "stem"
            out["int8_conv"] += 1
        elif isinstance(m, ConvBN) and m.kernel_route:
            out["conv3x3_silu" if m.s == 1 else "conv3x3s2_silu"] += 1
        elif isinstance(m, AAttn):
            out["fused_attention"] += 1
    return out


def phase_slice(dev, path, light=False):
    """The path's model at 640, nc=80, bf16 (the Config default), seeded
    weights: a few image_predict and batch_predict requests in both
    End2End modes (light: one NMS batch_predict). Returns (launches of the
    path's kernels, their launches in one b32 forward, state dict, conf)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)
    from yolosharp_tpu_torch.loss import flatten_levels

    name = path_name(path)
    segment, pose = ARCH[path][2] == "segment", ARCH[path][2] == "pose"
    obb = ARCH[path][2] == "obb"
    print(f"phase {PHASE[path]}: {name}-640 nc={PATH_NC.get(path, 80)} "
          f"YoloTask on cuda, bf16, seeded weights", flush=True)
    master = YoloTask(path_config(path, end2end=True), device=dev)
    net = master.task._ensure_variables()
    seed_weights(net)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    tasks = build_tasks(dev, path, state)

    singles = [synthetic_images(1, 640, 640, 10)[0],
               synthetic_images(1, 480, 640, 11)[0],
               synthetic_images(1, 500, 375, 12)[0]]    # not a multiple of 32
    batch = synthetic_images(SERVED_BATCH, 640, 640, 20)

    # conf: every image of the batch has at most CANDIDATES above it
    det = tasks[False].task
    x = torch.from_numpy(np.stack(batch)).to(dev).permute(0, 3, 1, 2)
    x = (x.float() / 255.0).to(det.dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        preds = det._predict_variables()(x)
    flat = flatten_levels(preds["one2many"]["cls"]).float().sigmoid()
    flat = flat.amax(-1).cpu().numpy()
    a = flat.shape[1]
    conf = float(np.quantile(flat, 1 - CANDIDATES / a, axis=1).max())
    counts = (flat > conf).sum(1)
    print(f"  conf {conf:.6f}: candidates per image min {counts.min()} mean "
          f"{counts.mean():.1f} max {counts.max()} of {a} anchors", flush=True)
    # the network forward alone, bf16, batch 32 at 640x640
    fwd = det._predict_variables()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        reset_launch_counts()
        fwd(x)
        per_forward = launch_counts()
        print(f"  [{path}] kernel launches of one b32 forward: "
              f"{per_forward}", flush=True)
        check_path_launches(path, per_forward, f"{path} b32 forward")
        if obb:
            # the NMS model's forward, the End2End model's (both branches)
            # and its served one (one2one towers only), each against the
            # counts its modules give
            e2e_fwd = tasks[True].task._predict_variables()
            for net_, skip, which in (
                    (fwd, False, "NMS model"),
                    (e2e_fwd, False, "End2End model, both branches"),
                    (e2e_fwd, True, "End2End predict, one2one towers")):
                reset_launch_counts()
                net_(x, skip_one2many=skip)
                got, want = launch_counts(), expected_launches(net_, skip)
                print(f"  [{path}] launches of one b32 forward ({which}): "
                      f"{got}, from the model's modules {want}", flush=True)
                if got != want:
                    raise SystemExit(f"[{path}] launches a forward differ "
                                     f"from the model's")
        start.record()
        for _ in range(5):
            fwd(x)
        end.record()
    torch.cuda.synchronize()
    print(f"  [{path}] network forward bf16 batch 32 640x640: "
          f"{start.elapsed_time(end) / 5:.2f} ms (CUDA events, mean of 5)",
          flush=True)
    del preds, x

    launches = {}
    for e2e, task in tasks.items():
        if light and e2e:
            continue
        mode = f"{path} {'end2end' if e2e else 'nms'}"
        task.image_predict(singles[0], conf)        # fold + warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        for img in singles[:0] if light else singles:
            t0 = time.perf_counter()
            res = task.image_predict(img, conf)
            ms = (time.perf_counter() - t0) * 1e3
            print(f"  [{mode}] image_predict {img.shape[0]}x{img.shape[1]}: "
                  f"{len(res)} detections, {ms:.2f} ms", flush=True)
            if not res:
                raise SystemExit(f"[{mode}] image_predict found nothing")
            if segment:
                check_masks([res], [img], mode)
            if pose:
                check_keypoints([res], mode)
            if obb:
                check_rotated([res], mode)
        for rep in range(1 if light else 3):
            t0 = time.perf_counter()
            res = task.batch_predict(batch, conf)
            s = time.perf_counter() - t0
            n = [len(r) for r in res]
            print(f"  [{mode}] batch_predict {len(batch)}x640x640 #{rep}: "
                  f"detections per image min {min(n)} mean {np.mean(n):.1f} "
                  f"max {max(n)}, {s * 1e3:.2f} ms, {len(batch) / s:.1f} "
                  f"img/s", flush=True)
            if len(res) != len(batch) or min(n) == 0 or not all(
                    np.isfinite([r.score, r.center_x, r.center_y, r.width,
                                 r.height]).all() for rs in res for r in rs):
                raise SystemExit(f"[{mode}] batch_predict results are wrong")
            if segment:
                check_masks(res, batch, mode)
            if pose:
                check_keypoints(res, mode)
            if obb:
                check_rotated(res, mode)
        if segment:
            print(f"  [{mode}] every result has a bool mask of its image's "
                  f"(h, w)", flush=True)
        if pose:
            print(f"  [{mode}] every result has 17 finite keypoints",
                  flush=True)
        if obb:
            print(f"  [{mode}] every result has w, h > 0 and an angle in "
                  f"[-pi/4, 3pi/4] (+- {ANGLE_SLACK} for bf16 rounding)",
                  flush=True)
        counts = launch_counts()
        print(f"  [{mode}] kernel launches: {counts}", flush=True)
        check_path_launches(path, counts, mode)
        for name in PATHS[path]:
            launches[name] = launches.get(name, 0) + counts[name]
    # truncation is checked per request: the NMS pool (512) held every
    # candidate
    t = tasks[False].task
    out = t._nms_of(t._predict_fn(t._predict_variables(),
                                  torch.from_numpy(np.stack(batch)).to(dev),
                                  conf, 0.7))
    if bool(out.truncated.any()):
        raise SystemExit("NMS candidate pool truncated")
    print(f"  truncated: False for all {len(batch)} images", flush=True)
    return launches, per_forward, state, conf


def phase_cpu_match(dev, path, state, conf):
    """The same model, float32, one 640x640 image: the card against the
    CPU's plain versions; a segment model's masks too (image_predict on
    both, each result matched by box and class)."""
    from yolosharp_tpu_torch import ScalarType

    name = path_name(path)
    print(f"phase {CPU_MATCH[path]}: {name} float32 on the card against "
          f"float32 on the CPU (plain versions)", flush=True)
    image = synthetic_images(1, 640, 640, 30)[0]
    img = torch.from_numpy(image[None])
    cuda = build_tasks(dev, path, state, scalar_type=ScalarType.float32)
    cpu = build_tasks("cpu", path, {k: v.cpu() for k, v in state.items()},
                      scalar_type=ScalarType.float32)
    # phase 4 runs twice: under this script's flags (TF32 off for the
    # library yardsticks) and under PyTorch's defaults (cuDNN's TF32 on),
    # which the port must turn off by itself around its own work
    flag_sets = [False, True] if path == "v8" else [False]
    for default_flags in flag_sets:
        torch.backends.cudnn.allow_tf32 = default_flags
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"  flags: torch.backends.cudnn.allow_tf32 = "
              f"{torch.backends.cudnn.allow_tf32}, "
              f"torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}"
              + (" (PyTorch's defaults)" if default_flags else ""),
              flush=True)
        try:
            _cpu_match_modes(dev, path, conf, image, img, cuda, cpu,
                             default_flags)
        finally:
            torch.backends.cudnn.allow_tf32 = False


def _cpu_match_modes(dev, path, conf, image, img, cuda, cpu, default_flags):
    """phase_cpu_match's NMS and End2End checks under the flags set; the
    caller's cuDNN flag must read the same after the port's call."""
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    for e2e in (False, True):
        c = 0.0 if e2e else conf
        reset_launch_counts()
        ct, ht = cuda[e2e].task, cpu[e2e].task
        got = ct._host(ct._predict_fn(ct._predict_variables(), img.to(dev),
                                      c, 0.7))
        used = launch_counts()
        if torch.backends.cudnn.allow_tf32 != default_flags:
            raise SystemExit("the port's predict left the caller's cuDNN "
                             "TF32 flag changed")
        want = ht._host(ht._predict_fn(ht._predict_variables(), img, c,
                                       0.7))
        mode = (f"{path} {'end2end' if e2e else 'nms'}"
                + (", PyTorch's default flags" if default_flags else ""))
        if ARCH[path][2] == "obb":
            n_want, n_got, unmatched, dbox, dang = match_rotated(
                ct._rboxes(got, 0, conf), ht._rboxes(want, 0, conf))
            print(f"  [{mode}] cpu {n_want} rotated rows, card {n_got} "
                  f"(within 2), unmatched {unmatched} (none allowed); "
                  f"matched rows: max "
                  f"|d cx, cy, w, h| {dbox:.3e} px (< 0.5), max |d angle| "
                  f"{dang:.3e} rad (< 1e-4) (kernel launches on the card: "
                  f"{used})", flush=True)
            if n_want < 5 or abs(n_got - n_want) > 2 or unmatched:
                raise SystemExit(f"[{mode}] card and CPU disagree")
            check_path_launches(path, used, mode + " float32")
            continue
        n_want, n_got, unmatched = match(rows_of(cuda[e2e], got, conf),
                                         rows_of(cpu[e2e], want, conf))
        print(f"  [{mode}] cpu {n_want} detections, card {n_got}, unmatched "
              f"{unmatched} (kernel launches on the card: {used})",
              flush=True)
        if n_want < 5 or abs(n_got - n_want) > 2 or unmatched > 2:
            raise SystemExit(f"[{mode}] card and CPU disagree")
        check_path_launches(path, used, mode + " float32")
        if ARCH[path][2] == "pose":
            n, dxy, dvis = matched_keypoints(
                cuda[e2e].task._rows(got, 0, conf),
                cpu[e2e].task._rows(want, 0, conf))
            print(f"  [{mode}] keypoints of {n} matched rows: max |dx|, "
                  f"|dy| {dxy:.3e} px (at most 0.5), max |d visibility| "
                  f"{dvis:.3e} (at most 1e-3)", flush=True)
            if n < n_want - unmatched or dxy > 0.5 or dvis > 1e-3:
                raise SystemExit(f"[{mode}] card and CPU keypoints "
                                 f"disagree")
        if ARCH[path][2] == "segment":
            same, total = matched_masks(cuda[e2e].image_predict(image, conf),
                                        cpu[e2e].image_predict(image, conf))
            print(f"  [{mode}] matched masks: {same} of {total} pixels "
                  f"equal ({same / max(total, 1):.6f}, at least 0.999)",
                  flush=True)
            if total == 0 or same < 0.999 * total:
                raise SystemExit(f"[{mode}] card and CPU masks disagree")


def match_rotated(got, want):
    """Rotated rows (xywhr (n, 5), scores, classes) of got against want:
    each wanted row matched by one of the same class with its centre and
    sides within 0.5 px, its angle within 1e-4 rad and its score within
    1e-3. Returns (n_want, n_got, unmatched, max |d cx, cy, w, h| and max
    |d angle| over the matched rows)."""
    gb, gs, gc = got
    wb, ws, wc = want
    used = np.zeros(len(gb), bool)
    unmatched, dbox, dang = 0, 0.0, 0.0
    for b, s, c in zip(wb, ws, wc):
        if not len(gb):
            unmatched += 1
            continue
        d4 = np.abs(gb[:, :4] - b[:4]).max(1)
        da = np.abs(gb[:, 4] - b[4])
        d = d4 + 1e3 * (gc != c) + 1e3 * (da >= 1e-4)
        j = int(np.argmin(d + 1e6 * used))
        if d[j] < 0.5 and abs(gs[j] - s) < 1e-3:
            used[j] = True
            dbox, dang = max(dbox, float(d4[j])), max(dang, float(da[j]))
        else:
            unmatched += 1
    return len(wb), len(gb), unmatched, dbox, dang


def matched_keypoints(got, want):
    """(rows matched, max |dx|, |dy| px, max |d visibility|) over the 17
    keypoints of the rows of `want` that match a row of `got` by match()'s
    rule; got and want are (boxes, scores, classes, keypoints) host
    arrays."""
    gb, gs, gc, gk = got
    n, dxy, dvis = 0, 0.0, 0.0
    used = np.zeros(len(gb), bool)
    for b, s, c, k in zip(*want):
        if not len(gb):
            break
        d = np.abs(gb - b).max(1) + 1e3 * (gc != c)
        j = int(np.argmin(d + 1e6 * used))
        if d[j] < 0.5 and abs(gs[j] - s) < 1e-3:
            used[j] = True
            diff = np.abs(gk[j] - k).reshape(17, 3)
            n, dxy = n + 1, max(dxy, float(diff[:, :2].max()))
            dvis = max(dvis, float(diff[:, 2].max()))
    return n, dxy, dvis


def matched_masks(got, want):
    """(pixels equal, pixels) over the masks of the results of `want`
    matched to `got`: the same class and box corners within 1.5 px (the
    results' boxes are integer-truncated)."""
    def corners(rs):
        return np.array([[r.center_x - r.width // 2,
                          r.center_y - r.height // 2,
                          r.center_x + r.width - r.width // 2,
                          r.center_y + r.height - r.height // 2]
                         for r in rs], float).reshape(-1, 4)

    gb, wb = corners(got), corners(want)
    same = total = 0
    for i, r in enumerate(want):
        if not len(got):
            break
        d = np.abs(gb - wb[i]).max(1) + 1e3 * np.array(
            [g.class_id != r.class_id for g in got])
        j = int(d.argmin())
        if d[j] <= 1.5:
            same += int((got[j].mask == r.mask).sum())
            total += r.mask.size
    return same, total


# ------------------------------------------------------------------ train
# the attention shapes of a v12s batch-16 640x640 train forward, (B, N, H, D)
TRAIN_ATTN = {"layer 6": (16 * 4, 400, 4, 32), "layer 8": (16, 400, 8, 32),
              # v12x-obb at batch 8: 12 heads, 384 and 96 sequences
              f"{OBB} b8 layer 6": (8 * 4, 400, 12, 32),
              f"{OBB} b8 layer 8": (8, 400, 12, 32)}
TRAIN_BATCH, TRAIN_SIZE = 16, 640


def time_eager(fns: dict, iters: int = 5) -> dict:
    """{name: ms a call}: CUDA events around iters eager calls, in turns
    (forward then backward order of fns), after one warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fns[name]()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / iters)
    return {name: float(np.mean(t)) for name, t in times.items()}


def attention64(q, k, v, g, scale):
    """(o, dq, dk, dv) of softmax(q k^T scale) v over (B, N, H, D) tensors
    for the output gradient g, evaluated in float64 on the given (rounded)
    inputs; (o,) where g is None."""
    qf, kf, vf = (t.double() for t in (q, k, v))
    s = torch.einsum("bihd,bjhd->bhij", qf * scale, kf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", p, vf)
    if g is None:
        return (o,)
    gf = g.double()
    dv = torch.einsum("bhij,bihd->bjhd", p, gf)
    dp = torch.einsum("bihd,bjhd->bhij", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (o, scale * torch.einsum("bhij,bjhd->bihd", ds, kf),
            scale * torch.einsum("bhij,bihd->bjhd", ds, qf), dv)


def sdpa_backward(q, k, v, g, scale):
    """One call of PyTorch's flash attention backward on (B, N, H, D)
    tensors, returning (dq, dk, dv) as (B, H, N, D) tensors; its output and
    logsumexp come from the op's own forward, run once here (not part of
    the call)."""
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, off, _ = (
        aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, False,
                                                 False, scale=scale))
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        gt, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, False, seed, off,
        scale=scale)


def phase_attention_autograd(dev, tag: str):
    """Phase 5; returns the bf16 sums of the three routes' forward +
    backward ms over the two shapes (fused_attention's stats) and the
    backward kernel's stats."""
    from yolosharp_tpu_torch.kernels import (attention_bihd,
                                             attention_bwd_plain,
                                             attention_plain,
                                             attention_stats_plain,
                                             fused_attention,
                                             fused_attention_bwd)
    from yolosharp_tpu_torch.kernels import attention as attn_mod
    from yolosharp_tpu_torch.kernels.attention import KINDS, attention_plan

    print("phase 5: fused_attention under autograd (kernel forward; "
          "float32: the plain backward, bfloat16 / float16: the kernel "
          "fused_attention_bwd) against plain autograd and float64, v12s "
          "b16 and v12x-obb b8 640x640 train shapes", flush=True)
    g = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # v12s's sums, as before, and v12x-obb's beside them
    sums = {f"autograd{sfx}_{route}": 0.0 for sfx in ("", "_v12x_obb")
            for route in ("ms", "plain_ms", "library_ms")}
    first = next(iter(TRAIN_ATTN))
    bwd = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0,
           "max_abs_err_f16": 0.0, "shapes": 0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "library_ms": 0.0, "ms_f16": 0.0,
           "plain_ms_f16": 0.0, "library_ms_f16": 0.0, "bound_ms_f16": 0.0,
           "f16_timed_shape": first,
           "fwd_bwd_ms": 0.0, "fwd_bwd_plain_ms": 0.0,
           "fwd_bwd_library_ms": 0.0, "fwd_bwd_ms_eager": 0.0,
           "fwd_bwd_library_ms_eager": 0.0}
    parts = {}
    plain_calls = []
    real_plain = attn_mod.attention_grads_plain

    def counted_plain(*a, **kw):
        plain_calls.append(a[0].dtype)
        return real_plain(*a, **kw)

    attn_mod.attention_grads_plain = counted_plain
    try:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            half = dtype != torch.float32
            dt = str(dtype)[6:]
            for layer, (b, n, h, d) in TRAIN_ATTN.items():
                var = variant("attn", dtype, b, (1, h, n, d), sms)
                scale = d ** -0.5
                qkv = torch.randn(b, n, h, 3 * d, generator=g,
                                  device=dev).to(dtype)
                grad_out = torch.randn(b, n, h, d, generator=g,
                                       device=dev).to(dtype)

                def bhnd(q, k, v):
                    return [x.transpose(1, 2) for x in (q, k, v)]

                routes = {
                    "plain": lambda q, k, v: attention_plain(
                        *bhnd(q, k, v), scale).transpose(1, 2),
                    "kernel": lambda q, k, v: attention_bihd(q, k, v, scale),
                    "library": lambda q, k, v: F.scaled_dot_product_attention(
                        *bhnd(q, k, v), scale=scale).transpose(1, 2)}

                def run(route):
                    t = qkv.clone().requires_grad_()
                    out = routes[route](*t.split(d, dim=-1))
                    out.backward(grad_out)
                    return out, t.grad

                before = (fused_attention.launches,
                          fused_attention_bwd.launches, len(plain_calls))
                out, got = run("kernel")
                torch.cuda.synchronize()
                after = (fused_attention.launches,
                         fused_attention_bwd.launches, len(plain_calls))
                want_bwd = (1, 1, 0) if half else (1, 0, 1)
                launched = tuple(a - z for a, z in zip(after, before))
                if out.grad_fn is None or launched != want_bwd:
                    raise SystemExit(
                        f"attention under autograd ({dt}): (forward, "
                        f"backward kernel, plain backward) calls "
                        f"{launched}, want {want_bwd}")
                tag_s = f"{layer} {dt} (B, N, H, D) = {(b, n, h, d)} [{var}]"
                if half:
                    tag_s += " [backward " + ", ".join(
                        f"{p.kind} grid {p.grid} stages {p.stages} rows "
                        f"{p.tile} units {p.units}"
                        for p in (attention_plan(kind, b * h, n, d, sms)
                                  for kind in KINDS)) + "]"
                want_out, want = run("plain")
                # float64 on the same rounded inputs: the output's reference
                # (the forward under autograd, at the rules of phase 2) and,
                # in 16 bits, the gradients'
                q, k, v = qkv.split(d, dim=-1)
                refs = attention64(q, k, v, grad_out if half else None,
                                   scale)
                compare(f"{tag_s} output", out.detach(), want_out.detach(),
                        dtype, "attn", refs[0])
                err = (got.float() - want.float()).abs()
                if not half:
                    bad = int((err > 1e-4 + 1e-4 * want.float().abs()).sum())
                    ok, rule = bad == 0, (f"|k-p| <= 1e-4 + 1e-4|p| ({bad} "
                                          f"outside)")
                else:
                    rel = float(err.max() / want.float().abs().max())
                    ok, rule = rel < 2e-2, (f"max|k-p|/max|p| = {rel:.3e} "
                                            f"< 2e-2")
                ok = ok and bool(torch.isfinite(got).all())
                print(f"  {tag_s}: dq dk dv against plain autograd "
                      f"max_abs_err {float(err.max()):.3e} {rule} "
                      f"{'OK' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise SystemExit("attention gradients disagree with "
                                     "plain autograd")
                if half:
                    # the backward kernel against float64, per gradient,
                    # beside the plain float32 backward's own distance
                    plain32 = real_plain(*(t.float() for t in (q, k, v)),
                                         grad_out.float(), scale)
                    u = UNIT[dtype]
                    kd, pd = [], []
                    for a, p32, r in zip(got.split(d, dim=-1), plain32,
                                         refs[1:]):
                        top = float(r.abs().max())
                        kd.append(float((a.double() - r).abs().max()) / top)
                        pd.append(float((p32.double() - r).abs().max()) / top)
                    ok = all(x <= max(TOL16["attn"] * u, 2 * y)
                             for x, y in zip(kd, pd))
                    del refs, plain32
                    # the kernel alone against its plain twin, on the same
                    # row statistics, and its bits in two calls
                    stats = attention_stats_plain(q, k, v, scale)
                    kern = fused_attention_bwd(q, k, v, grad_out, *stats,
                                               scale)
                    again = fused_attention_bwd(q, k, v, grad_out, *stats,
                                                scale)
                    same = all(bool(torch.equal(x, y))
                               for x, y in zip(kern, again))
                    print(f"    fused_attention_bwd vs float64 (max|k - ref| "
                          f"/ max|ref|, dq dk dv): kernel "
                          + ", ".join(f"{x / u:.3f}" for x in kd)
                          + " u, plain float32 "
                          + ", ".join(f"{y / u:.2e}" for y in pd)
                          + f" u; gate max({TOL16['attn']} u, 2 x plain); "
                          f"two calls equal bits: {same} "
                          f"{'OK' if ok and same else 'FAIL'}", flush=True)
                    if not ok or not same:
                        raise SystemExit("fused_attention_bwd fails its "
                                         "float64 gate or is not "
                                         "deterministic")
                    twin = attention_bwd_plain(q, k, v, grad_out, *stats,
                                               scale)
                    diff = max(float((a.float() - z.float()).abs().max())
                               for a, z in zip(kern, twin))
                    bwd[ERR_KEY[dtype]] = max(bwd[ERR_KEY[dtype]], diff)
                    bwd["max_abs_err"] = max(bwd["max_abs_err"], diff)
                    del twin, again
                # times: bf16 at every shape, f16 (within 2% of bf16 on
                # the H100) at the first; float32 forward + backward at each
                timed = dtype != torch.float16 or layer == first
                if half and timed:
                    lib = sdpa_backward(q, k, v, grad_out, scale)
                    lib_diff = max(
                        float((a.transpose(1, 2).float() - z.float()).abs()
                              .max()) for a, z in zip(lib(), kern))
                    tb, _ = time_calls({
                        "plain": lambda: attention_bwd_plain(
                            q, k, v, grad_out, *stats, scale),
                        "kernel": lambda: fused_attention_bwd(
                            q, k, v, grad_out, *stats, scale),
                        "library": lib})
                    seqs = b * h
                    size = 2
                    bound_ms, by = bound(5 * 2 * seqs * n * n * d,
                                         7 * seqs * n * d * size, dtype)
                    print(f"    backward alone, device (CUDA graph): "
                          f"{tb['kernel']:.4f} ms kernel, {tb['plain']:.4f} "
                          f"ms plain twin, {tb['library']:.4f} ms aten flash "
                          f"attention backward (max|lib - k| "
                          f"{lib_diff:.3e}); bound {bound_ms:.4f} ms by {by} "
                          f"({7 * seqs * n * d * size / 1e6:.1f} MB, "
                          f"{10 * seqs * n * n * d / 1e9:.2f} GFLOP), "
                          f"{bound_ms / tb['kernel']:.3f} of it; max|k - "
                          f"twin| {diff:.3e}", flush=True)
                    sfx = "" if dtype == torch.bfloat16 else "_f16"
                    bwd["ms" + sfx] += tb["kernel"]
                    bwd["plain_ms" + sfx] += tb["plain"]
                    bwd["library_ms" + sfx] += tb["library"]
                    bwd["bound_ms" + sfx] += bound_ms
                    parts[by] = parts.get(by, 0.0) + bound_ms
                    bwd["shapes"] += 1
                if half:
                    del kern, stats
                if not timed:
                    continue
                t, eager = time_calls({r: (lambda r=r: run(r))
                                       for r in routes})
                print(f"    {tag}: forward + backward, device (CUDA graph): "
                      f"{t['kernel']:.4f} ms kernel route, {t['plain']:.4f} "
                      f"ms plain autograd, {t['library']:.4f} ms SDPA; "
                      f"eager: {eager['kernel']:.3f} / {eager['plain']:.3f} "
                      f"/ {eager['library']:.3f} ms (CUDA events, mean of "
                      f"10)", flush=True)
                if dtype == torch.bfloat16:
                    sfx = "_v12x_obb" if layer.startswith(OBB) else ""
                    sums[f"autograd{sfx}_ms"] += eager["kernel"]
                    sums[f"autograd{sfx}_plain_ms"] += eager["plain"]
                    sums[f"autograd{sfx}_library_ms"] += eager["library"]
                    bwd["fwd_bwd_ms"] += t["kernel"]
                    bwd["fwd_bwd_plain_ms"] += t["plain"]
                    bwd["fwd_bwd_library_ms"] += t["library"]
                    bwd["fwd_bwd_ms_eager"] += eager["kernel"]
                    bwd["fwd_bwd_library_ms_eager"] += eager["library"]
    finally:
        attn_mod.attention_grads_plain = real_plain
    if any(dt != torch.float32 for dt in plain_calls):
        raise SystemExit(f"a 16-bit backward ran attention_grads_plain: "
                         f"{plain_calls}")
    bwd["bound_by"] = max(parts, key=parts.get)
    print(f"  fused_attention_bwd bf16 sums over the four shapes, device ms: "
          f"kernel {bwd['ms']:.4f}, plain twin {bwd['plain_ms']:.4f}, aten "
          f"flash backward {bwd['library_ms']:.4f}, bound "
          f"{bwd['bound_ms']:.4f} ({bwd['bound_by']}); f16 at {first}: "
          f"kernel {bwd['ms_f16']:.4f}, aten {bwd['library_ms_f16']:.4f}; "
          f"forward + backward "
          f"(CUDA graph) kernel route {bwd['fwd_bwd_ms']:.4f}, plain "
          f"{bwd['fwd_bwd_plain_ms']:.4f}, SDPA {bwd['fwd_bwd_library_ms']:.4f}"
          f"; eager kernel route {bwd['fwd_bwd_ms_eager']:.3f}, SDPA "
          f"{bwd['fwd_bwd_library_ms_eager']:.3f}", flush=True)
    return sums, bwd


def train_batch(n, size, seed, slots=3):
    """A uint8 batch with padded labels (1 to `slots` valid), numpy."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.25, 0.75, (n, slots, 2))
    wh = rng.uniform(0.1, 0.5, (n, slots, 2))
    mask = np.arange(slots)[None] < rng.integers(1, slots + 1, (n, 1))
    return {"images": np.stack(synthetic_images(n, size, size, seed)),
            "cls": rng.integers(0, 80, (n, slots)).astype(np.int32),
            "bboxes": np.where(mask[..., None], np.concatenate([c, wh], -1),
                               0).astype(np.float32),
            "mask_gt": mask}


def with_masks(batch, ratio=4):
    """The batch and its overlap-id masks at 1 / ratio: each valid box's
    region takes its slot's id + 1, later boxes over earlier ones."""
    n, h, w = batch["images"].shape[:3]
    masks = np.zeros((n, h // ratio, w // ratio), np.float32)
    for i in range(n):
        for j in np.flatnonzero(batch["mask_gt"][i]):
            cx, cy, bw, bh = batch["bboxes"][i, j] * [w, h, w, h] / ratio
            masks[i, int(cy - bh / 2):int(np.ceil(cy + bh / 2)),
                  int(cx - bw / 2):int(np.ceil(cx + bw / 2))] = j + 1
    return dict(batch, masks=masks)


def with_keypoints(batch, seed=42):
    """The batch and 17 keypoints a label (normalised x, y and visibility
    0, 1 or 2) inside each valid box; half of the invisible ones at
    (0, 0), as COCO writes them; zeros in the padding slots."""
    rng = np.random.default_rng(seed)
    n, m = batch["mask_gt"].shape
    cxy = batch["bboxes"][..., None, :2]
    wh = batch["bboxes"][..., None, 2:4]
    xy = cxy + (rng.uniform(0, 1, (n, m, 17, 2)) - 0.5) * wh
    vis = rng.integers(0, 3, (n, m, 17, 1)).astype(np.float32)
    xy[(vis[..., 0] == 0) & (rng.uniform(0, 1, (n, m, 17)) < 0.5)] = 0.0
    kpts = np.concatenate([xy, vis], -1) * batch["mask_gt"][..., None, None]
    return dict(batch, keypoints=kpts.astype(np.float32))


def with_angles(batch, seed=43):
    """The batch's boxes as rotated boxes (B, M, 5): the same normalised
    centre and sides and an angle from [-pi/2, 0) (minAreaRect's range) a
    label; zeros in the padding slots."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi / 2, 0, batch["mask_gt"].shape + (1,))
    rb = np.concatenate([batch["bboxes"], ang], -1) \
        * batch["mask_gt"][..., None]
    return dict(batch, bboxes=rb.astype(np.float32))


def zero_gradient_leaves(net) -> set:
    """Parameters whose gradient in a train-mode step is 0 by construction:
    the bias of a conv that a train-mode BN follows (the BN subtracts the
    batch mean, bias included), and the BN bias of SPPF's cv1, which has no
    activation (the max pools commute with a per-channel shift, and cv2's
    train-mode BN removes the shift that its 1x1 conv makes of it)."""
    from yolosharp_tpu_torch.nn.common import SPPF, ConvBN

    names = set()
    for name, m in net.named_modules():
        if isinstance(m, ConvBN) and m.conv.bias is not None:
            names.add(f"{name}.conv.bias")
        elif isinstance(m, SPPF) and m.cv1.act == "identity":
            names.add(f"{name}.cv1.bn.bias")
    return names


def phase_train_step_cpu_match(dev):
    """Phase 6."""
    from yolosharp_tpu_torch import (Config, ScalarType, TaskType, YoloSize,
                                     YoloTask, YoloType)
    from yolosharp_tpu_torch.data import to_device
    from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                           make_train_step)

    print("phase 6: one float32 train step (End2End) at 128x128, batch 2, "
          "card and CPU against the CPU's float64 step, same seeded weights "
          "and batch: v8n, v12n, v11n-seg, v11n-pose, v12n-obb", flush=True)
    base = train_batch(2, 128, 40)
    for version, task_type in (("v8", "detect"), ("v12", "detect"),
                               ("v11", "segment"), ("v11", "pose"),
                               ("v12", "obb")):
        cfg = Config(task_type=TaskType(task_type),
                     yolo_type=YoloType(version), yolo_size=YoloSize.n,
                     number_class=80, scalar_type=ScalarType.float32)
        label = f"{version}n" + {"detect": "", "segment": "-seg",
                                 "pose": "-pose", "obb": "-obb"}[task_type]
        batch = {"detect": lambda b: b, "segment": with_masks,
                 "pose": with_keypoints, "obb": with_angles}[task_type](base)
        # the loss items' bound: the OBB step's 1e-5, the others' 1e-4
        items_tol = 1e-5 if task_type == "obb" else 1e-4
        if task_type == "pose":
            vis = batch["keypoints"][batch["mask_gt"]][..., 2]
            print(f"  [{label}] label keypoints by visibility 0 / 1 / 2: "
                  f"{np.bincount(vis.astype(int).ravel(), minlength=3)}",
                  flush=True)
        res = []
        # the card, the CPU, and the CPU in float64 (the reference of both
        # float32 steps)
        for d, dt in ((dev, torch.float32), (torch.device("cpu"),
                                             torch.float32),
                      (torch.device("cpu"), torch.float64)):
            task = YoloTask(cfg, device=d)
            net = task.task._ensure_variables().to(
                dtype=dt, memory_format=torch.channels_last)
            opt, scheds = make_optimizer(net, nc=80, epochs=1,
                                         steps_per_epoch=1)
            state = TrainState(net, opt, scheds)
            before = {n: p.detach().clone() for n, p in net.named_parameters()
                      if p.requires_grad}
            _, items = make_train_step(task.task._loss_fns()[0],
                                       compute_dtype=dt)(
                state, to_device(batch, d), {})
            # parameter changes in float32, the parameters' own type: the
            # float64 step's new parameters are rounded to float32 first
            # (its first AdamW update, lr * g / (|g| + eps) at the warm-up
            # lr of 1.19e-8, is below float32's spacing at |p| ~ 1, where
            # both float32 steps round it away)
            res.append({
                "items": items.cpu(),
                "delta": {n: (p.detach().float() - before[n].float()).cpu()
                          for n, p in net.named_parameters() if n in before},
                "grad": {n: p.grad.cpu() for n, p in net.named_parameters()
                         if n in before},
                "stats": {k: v.cpu() for k, v in net.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}})
        card, cpu, f64 = res
        if task_type == "pose":
            print(f"  [{label}] cv4 towers "
                  f"{net.model[-1].cv4[0][0].conv.out_channels} channels "
                  f"wide", flush=True)
        # Each device's float32 step is held against the CPU's float64 step
        # (the bounds are those that held the card to the CPU's float32
        # step): the CPU's float32 gradients move with its thread count
        # alone by up to ~1e-3 of a tensor's largest value on a one-element
        # bias (v12n-obb's model.21.cv4.1.2.bias, the card's by ~6e-5), so
        # the float64 step is the reference both float32 runs are compared
        # with. The CPU's own distance is printed beside the card's.
        zero = zero_gradient_leaves(net)
        g_all = max(float(g.abs().max()) for g in f64["grad"].values())
        # the leaves whose gradient is 0 by construction: rounding noise on
        # both devices, held to 1e-6 G, their updates lr * sign(noise)
        noise = {n: (float(card["grad"][n].abs().max()),
                     float(cpu["grad"][n].abs().max())) for n in sorted(zero)}
        noise_bad = sum(max(v) > 1e-6 * g_all for v in noise.values())
        print(f"  [{label}] {len(zero)} leaves with a zero gradient by "
              f"construction, max|g| card / cpu in units of G = {g_all:.3e} "
              f"(the float64 net's largest gradient), <= 1e-6: " + ", ".join(
                  f"{n} {c / g_all:.1e} / {h / g_all:.1e}"
                  for n, (c, h) in noise.items()), flush=True)

        def against_f64(run):
            """run's distance from the float64 step: (loss items' max rel,
            gradient elements outside 1e-3 max|g| per tensor, (largest
            |dg| / max|g|, its tensor), largest |dp| / max|dp|, parameter
            changes outside 1e-3 max|dp| + 1e-8, those of them where the
            gradients fix the update)."""
            # the semseg item is 0 on both: 0 / tiny, not 0 / 0
            rel = float(((run["items"].double() - f64["items"]).abs()
                         / f64["items"].abs().clamp_min(1e-30)).max())
            outside = unexplained = grad_bad = 0
            worst = 0.0
            grad_worst = (0.0, "")
            for name, want in f64["delta"].items():
                if name in zero:
                    continue
                g_ref = f64["grad"][name]
                dg = (run["grad"][name].double() - g_ref).abs()
                gmax = float(g_ref.abs().max())
                grad_bad += int((dg > 1e-3 * gmax).sum())
                grad_worst = max(grad_worst, (float(dg.max())
                                              / (gmax + 1e-30), name))
                err = (run["delta"][name] - want).abs()
                worst = max(worst, float((err / (want.abs().max() + 1e-30))
                                         .max()))
                bad = err > 1e-3 * want.abs().max() + 1e-8
                # AdamW's first update is lr * g / (|g| + 1e-8): it is
                # fixed to the rule where the two gradients' difference dg
                # can neither flip the sign (|g| > 2 dg) nor move
                # g / (|g| + eps) by 5e-4 (eps * dg / g^2 < 5e-4)
                g = g_ref.abs()
                fixed = (g > 2 * dg) & (2e3 * 1e-8 * dg < g * g)
                outside += int(bad.sum())
                unexplained += int((bad & fixed).sum())
            return rel, grad_bad, grad_worst, worst, outside, unexplained

        rel, grad_bad, grad_worst, worst, outside, unexplained = \
            against_f64(card)
        c_rel, c_grad_bad, c_grad_worst, c_worst, c_outside, c_unexpl = \
            against_f64(cpu)
        print(f"  [{label}] loss items card {card['items'].tolist()} cpu "
              f"{cpu['items'].tolist()} float64 {f64['items'].tolist()}: "
              f"max rel from float64 card {rel:.3e} < {items_tol:g} (CPU "
              f"float32 {c_rel:.3e})", flush=True)
        n_params = sum(v.numel() for n, v in f64["delta"].items()
                       if n not in zero)
        print(f"  [{label}] the other leaves against float64: gradients "
              f"{grad_bad} elements outside |g - g_f64| <= 1e-3 max|g_f64| "
              f"per tensor (largest |g - g_f64| / max|g_f64| "
              f"{grad_worst[0]:.3e}, {grad_worst[1]}; CPU float32 "
              f"{c_grad_bad} outside, largest {c_grad_worst[0]:.3e}, "
              f"{c_grad_worst[1]}); parameter changes: max |dp - dp_f64| / "
              f"max|dp_f64| {worst:.3e} (CPU float32 {c_worst:.3e}), "
              f"{outside} of {n_params} elements outside 1e-3 max|dp| + "
              f"1e-8 (CPU float32 {c_outside}), {unexplained} of them "
              f"where the gradients fix the update (CPU float32 "
              f"{c_unexpl})", flush=True)
        # running means near 0 (a channel's batch mean times 0.03) carry
        # the float32 rounding of sums far larger than themselves. Each
        # tensor is held at its own scale against the float64 statistics:
        # the card's max |d| / (|ref| + max|ref|) within 1e-5, or within
        # twice the CPU's float32 distance where that is larger (the CPU is
        # 4e-6 to 9e-6 of that scale from them in the deep head towers of
        # v8n, v12n and v11n-seg, so 1e-5 alone would hold the card nearer
        # to float64 than float32 rounding allows)
        def stat_dist(a, kind):
            """{name: (max |a - ref| / (|ref| + max|ref|), max |a - ref| /
            |ref|)} over the tensors of `kind`, ref the float64 run's."""
            out = {}
            for k, v in f64["stats"].items():
                if k.endswith(kind):
                    v = v.double()
                    d = (a["stats"][k].double() - v).abs()
                    out[k] = (float((d / (v.abs() + v.abs().max())).max()),
                              float((d / v.abs().clamp_min(1e-30)).max()))
            return out

        stat_err, stat_rel, stat_bad = {}, {}, 0
        for kind in ("running_mean", "running_var"):
            got, ref = stat_dist(card, kind), stat_dist(cpu, kind)
            bound = {k: max(1e-5, 2 * ref[k][0]) for k in got}
            stat_bad += sum(got[k][0] > bound[k] for k in got)
            worst_k = max(got, key=lambda k: got[k][0] / bound[k])
            stat_err[kind] = (got[worst_k][0], bound[worst_k],
                              ref[worst_k][0], worst_k)
            stat_rel[kind] = max((v[1], k) for k, v in got.items())
        for kind, (err, bnd, ref_err, k) in stat_err.items():
            print(f"  [{label}] BN {kind} against the float64 run, the "
                  f"tensor nearest its bound: card max |d| / (|ref| + "
                  f"max|ref|) {err:.3e} <= {bnd:.3e} (CPU float32 "
                  f"{ref_err:.3e}; {k}); max |d| / |ref| "
                  f"{stat_rel[kind][0]:.3e} ({stat_rel[kind][1]})",
                  flush=True)
        if rel >= items_tol or noise_bad or grad_bad or unexplained \
                or stat_bad or not all(torch.isfinite(v).all()
                                       for v in card["delta"].values()):
            raise SystemExit(f"[{label}] card train step disagrees with "
                             f"the CPU's float64 step")


# ------------------------------------------------------------- float16
def phase_fp16(dev, states, confs) -> dict:
    """Phase 6b. Returns the kernel launches of its float16 predicts."""
    from yolosharp_tpu_torch import Config, YoloSize, YoloTask, YoloType
    from yolosharp_tpu_torch.data import to_device
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from yolosharp_tpu_torch.nn import attention as nn_attention
    from yolosharp_tpu_torch.train import (MAX_LOSS_SCALE, TrainState,
                                           make_optimizer, make_train_step)

    print("phase 6b: true_fp16 (float16 compute): v8s and v12s b32 640x640 "
          "batch_predict through every kernel of the path in float16, then "
          "v12n train steps at 128x128", flush=True)
    batch = synthetic_images(SERVED_BATCH, 640, 640, 20)
    launches = {}
    for version in ("v8", "v12"):
        task = build_tasks(dev, version, states[version],
                           true_fp16=True)[False]
        net = task.task._predict_variables()
        if task.task.dtype != torch.float16:
            raise SystemExit(f"true_fp16 computes in {task.task.dtype}")
        # the largest |x| each layer of the float16 forward reaches
        peaks = {}
        hooks = [m.register_forward_hook(
            lambda m, i, o, j=j: peaks.__setitem__(
                j, float(o.float().abs().max())))
            for j, m in enumerate(net.model[:-1])]
        x = torch.from_numpy(np.stack(batch)).to(dev).permute(0, 3, 1, 2)
        with torch.no_grad():
            net((x.float() / 255.0).half().contiguous(
                memory_format=torch.channels_last))
        for h in hooks:
            h.remove()
        top = max(peaks, key=peaks.get)
        over = [j for j, v in peaks.items() if not v <= 65504.0]
        print(f"  [{version}s f16] largest |x| of a layer output: "
              f"{peaks[top]:.1f} (layer {top}); layers past float16's "
              f"65504: {over or 'none'}", flush=True)
        reset_launch_counts()
        for rep in range(3):
            t0 = time.perf_counter()
            res = task.batch_predict(batch, confs[version])
            dt = time.perf_counter() - t0
            n = [len(r) for r in res]
            print(f"  [{version}s f16] batch_predict {len(batch)}x640x640 "
                  f"#{rep}: detections per image min {min(n)} mean "
                  f"{np.mean(n):.1f} max {max(n)}, {dt * 1e3:.2f} ms",
                  flush=True)
        counts = launch_counts()
        print(f"  [{version}s f16] kernel launches: {counts}", flush=True)
        check_path_launches(version, counts, f"{version}s f16")
        if len(res) != len(batch) or not all(
                np.isfinite([r.score, r.center_x, r.center_y, r.width,
                             r.height]).all() for rs in res for r in rs):
            raise SystemExit(f"[{version}s f16] batch_predict results are "
                             f"wrong")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    cfg = Config(yolo_type=YoloType.v12, yolo_size=YoloSize.n,
                 number_class=80, true_fp16=True)
    det = YoloTask(cfg, device=dev).task
    net = det._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=80, epochs=1, steps_per_epoch=18)
    state = TrainState(net, opt, scheds, init_scale=MAX_LOSS_SCALE)
    step = make_train_step(det._loss_fns()[0], compute_dtype=det.dtype,
                           dynamic_loss_scale=True)
    tb = to_device(train_batch(2, 128, 41), dev)
    seen = []
    real = nn_attention.attention_bihd

    def traced(q, k, v, scale):
        out = real(q, k, v, scale)
        seen.append((out.dtype, out.grad_fn is not None))
        return out

    nn_attention.attention_bihd = traced
    try:
        # the scale halves after each step whose float16 gradients
        # overflow (the step skipped), until one applies; then one more
        for i in range(18):
            reset_launch_counts()
            _, items = step(state, tb, {})
            n = launch_counts()["fused_attention"]
            nb = launch_counts()["fused_attention_bwd"]
            print(f"  [v12n true_fp16 train] step {i + 1}: loss items "
                  f"{items.tolist()}, updates applied {state.count}, loss "
                  f"scale {state.loss_scale:g} after it, attention launches "
                  f"{n}, its float16 backward kernel {nb}", flush=True)
            if n != 8 or nb != 8 or not bool(torch.isfinite(items).all()):
                raise SystemExit("true_fp16 train step: not 8 attention "
                                 "forward and backward launches, or a loss "
                                 "not finite")
            if state.count >= 2:
                break
    finally:
        nn_attention.attention_bihd = real
    if state.count < 2:
        raise SystemExit("true_fp16 train: no two updates applied in 18 "
                         "steps")
    net.eval()
    print(f"  attention outputs in the steps: {len(seen)}, dtypes "
          f"{sorted({str(d) for d, _ in seen})}, all with a grad_fn: "
          f"{all(g for _, g in seen)}", flush=True)
    if not seen or any(d != torch.float16 or not g for d, g in seen):
        raise SystemExit("the attention did not run in float16 under "
                         "autograd")
    return launches


def write_dataset(root, n_train, n_val, seed=7) -> np.ndarray:
    """Images of 480-800 px a side, a noisy background and 1-8 solid
    rectangles, with YOLO txt labels (80 classes), under
    root/images/{train,val} and root/labels/{train,val}, as PNG with
    adaptive row filters (the port's encode_png, zlib level 1). Returns the
    count of rows of each filter type."""
    from yolosharp_tpu_torch.data.image_ops import encode_png

    rng = np.random.default_rng(seed)
    mix = np.zeros(5, np.int64)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "labels", split))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(480, 801, 2))
            img = np.clip(rng.normal(rng.uniform(40, 215), 20, (h, w, 3)),
                          0, 255).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 9))):
                bw, bh = rng.uniform(0.05, 0.5, 2)
                cx = rng.uniform(bw / 2, 1 - bw / 2)
                cy = rng.uniform(bh / 2, 1 - bh / 2)
                img[int((cy - bh / 2) * h):int((cy + bh / 2) * h),
                    int((cx - bw / 2) * w):int((cx + bw / 2) * w)] = \
                    rng.integers(0, 256, 3)
                rows.append(f"{rng.integers(80)} {cx:.6f} {cy:.6f} "
                            f"{bw:.6f} {bh:.6f}")
            data = encode_png(img, level=1)
            with open(os.path.join(root, "images", split, f"{i:04d}.png"),
                      "wb") as f:
                f.write(data)
            mix += np.bincount(np.frombuffer(zlib.decompress(
                data[data.index(b"IDAT") + 4:]), np.uint8).reshape(
                h, 3 * w + 1)[:, 0], minlength=5)
            with open(os.path.join(root, "labels", split, f"{i:04d}.txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")
    return mix


def _train_config(root, version, **kw):
    from yolosharp_tpu_torch import Config, YoloSize, YoloType

    kw = {"epochs": 1, "yolo_size": YoloSize.s, "image_size": TRAIN_SIZE,
          "batch_size": TRAIN_BATCH, **kw}
    return Config(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", yolo_type=YoloType(version),
                  number_class=80, **kw)


def epoch_line(st, tag, batch=TRAIN_BATCH) -> str:
    """One epoch of epoch_stats: steps, median step ms after the first two,
    img/s at it and over the loop, the loader-wait share, peak memory."""
    steps = len(st["step_s"])
    med = float(np.median(st["step_s"][2:])) * 1e3
    wait, loop = sum(st["wait_s"]), st["loop_s"]
    tail = sum(st["wait_s"][2:]) / (sum(st["wait_s"][2:])
                                    + sum(st["step_s"][2:]))
    return (f"{tag}: epoch {st['epoch']}: {steps} steps, {med:.1f} ms a step "
            f"(median after the first two; first two "
            f"{st['step_s'][0] * 1e3:.0f}, {st['step_s'][1] * 1e3:.0f} ms), "
            f"{batch / med * 1e3:.1f} img/s at that median, "
            f"{steps * batch / loop:.1f} img/s over the step loop "
            f"({loop:.2f} s); loader wait {wait / loop:.3f} of the loop (the "
            f"first batch {st['wait_s'][0]:.2f} s; after the first two steps "
            f"{tail:.3f}); val {st['val_s']:.2f} s; peak device memory "
            f"{st['peak_bytes'] / 2**30:.2f} GiB")


def phase_train(dev, root, tag: str) -> dict:
    """Phase 7: YoloTask.train() of v8s. Returns its launch counts."""
    from yolosharp_tpu_torch import Config, YoloSize, YoloTask
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 7: YoloTask.train() of v8s, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"batch {TRAIN_BATCH}, bf16, 1 epoch", flush=True)
    out = os.path.join(root, "run_v8s")
    task = YoloTask(_train_config(root, "v8", output_path=out), device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    task.train()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = task.task.epoch_stats[0]
    steps = len(st["step_s"])
    print("  " + epoch_line(st, f"{tag}: v8s"), flush=True)
    print(f"  train() {wall:.1f} s; kernel launches during train(): "
          f"{counts}", flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    values = dict(zip([h.strip() for h in rows[0]], rows[-1]))
    print(f"  log.csv: {values}", flush=True)
    losses = [float(v) for k, v in values.items() if "loss" in k]
    files = ["config.txt", "log.csv", "weights/best.bin", "weights/last.bin",
             "weights/last_state.npz"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    if missing or not np.isfinite(losses).all() or steps != 10:
        raise SystemExit(f"v8s train(): missing {missing}, losses {losses}, "
                         f"{steps} steps")
    if counts["conv3x3_silu"] or counts["conv3x3s2_silu"] or \
            counts["c2f_fused"]:
        raise SystemExit("an unfolded train-mode conv ran through a "
                         "predict kernel")
    fresh = YoloTask(Config(yolo_size=YoloSize.s, number_class=80),
                     device=dev)
    fresh.load_model(os.path.join(out, "weights", "best.bin"))
    res = fresh.image_predict(synthetic_images(1, 640, 640, 50)[0], 0.0)
    print(f"  best.bin in a fresh YoloTask: image_predict gave {len(res)} "
          f"rows", flush=True)
    if not res:
        raise SystemExit("image_predict of the trained weights returned "
                         "nothing")
    return counts


def phase_train_v12(dev, root, tag: str) -> dict:
    """Phase 7b: an epoch of v12s through the port's train step. Returns
    its launch counts."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.data import (DataLoader, YoloDataset,
                                          device_prefetch)
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from yolosharp_tpu_torch.train import (TrainState, make_optimizer,
                                           make_train_step)

    print(f"phase 7b: v12s train steps, {TRAIN_SIZE}x{TRAIN_SIZE}, batch "
          f"{TRAIN_BATCH}, bf16, through the port's train step", flush=True)
    cfg = _train_config(root, "v12")
    det = YoloTask(cfg, device=dev).task
    t0 = time.perf_counter()
    ds = YoloDataset(cfg)
    print(f"  {tag}: YoloDataset of {len(ds)} train PNGs (decode without "
          f"cv2, resize to {TRAIN_SIZE}) built in "
          f"{time.perf_counter() - t0:.2f} s on the host", flush=True)
    loader = DataLoader(ds, cfg.batch_size, workers=cfg.workers,
                        max_labels=ds.max_label_count)
    ds.close_mosaic(True)
    net = det._ensure_variables().to(memory_format=torch.channels_last)
    opt, scheds = make_optimizer(net, nc=80, epochs=1,
                                 steps_per_epoch=len(loader))
    state = TrainState(net, opt, scheds)
    step = make_train_step(det._loss_fns()[0], compute_dtype=det.dtype)
    times, items = [], []
    reset_launch_counts()
    for batch in device_prefetch(loader, det._to_device):
        t0 = time.perf_counter()
        _, it = step(state, batch, {})
        times.append(time.perf_counter() - t0)
        items.append(it)
    counts = launch_counts()
    net.eval()
    items = torch.stack(items).cpu()
    med = float(np.median(times[2:])) * 1e3
    print(f"  {tag}: v12s {len(times)} steps, {med:.1f} ms a step (median "
          f"after the first two; each ends in its host sync), "
          f"{TRAIN_BATCH / med * 1e3:.1f} img/s; loss items of the last "
          f"step {items[-1].tolist()}", flush=True)
    print(f"  kernel launches: {counts} ({len(times)} forwards)", flush=True)
    if counts["fused_attention"] != 8 * len(times) or counts[
            "fused_attention_bwd"] != 8 * len(times) or not bool(
            torch.isfinite(items).all()) or len(times) != 10:
        raise SystemExit("v12s train: not 8 attention forward and backward "
                         "launches a step, or a loss not finite")
    return counts


# ---------------------------------------------------------------- mosaic
def phase_render(dev, root, tag):
    """Phase 8a, the render: one planned batch on the card and on the
    CPU."""
    from yolosharp_tpu_torch.data import YoloDataset
    from yolosharp_tpu_torch.data.device_augment import PLAN_KEYS, render_batch

    print(f"phase 8a: the mosaic's device render of one planned b{TRAIN_BATCH} "
          f"{TRAIN_SIZE}x{TRAIN_SIZE} batch (degrees 10, shear 2, perspective "
          f"5e-4), card against CPU, float32", flush=True)
    cfg = _train_config(root, "v11", degrees=10.0, shear=2.0,
                        perspective=5e-4)
    ds = YoloDataset(cfg)
    batch = ds.device_batch(np.arange(TRAIN_BATCH), ds.max_label_count)
    keys = ("aug_pool",) + PLAN_KEYS
    on_card = {k: torch.from_numpy(batch[k]).to(dev) for k in keys}
    got = render_batch(on_card)
    want = render_batch({k: torch.from_numpy(batch[k]) for k in keys})
    d = (got.cpu() - want).abs()
    frac = float((d > 1e-2).float().mean())
    print(f"  card vs CPU: {frac:.3e} of {d.numel()} values more than 1e-2 "
          f"apart (at most 1e-3), max |d| {float(d.max()):.3e}; output "
          f"{tuple(got.shape)} {got.dtype}, range [{float(got.min()):.1f}, "
          f"{float(got.max()):.1f}]", flush=True)
    if frac > 1e-3 or not bool(torch.isfinite(got).all()):
        raise SystemExit("the device render disagrees with the CPU's")
    ms = time_eager({"render": lambda: render_batch(on_card)}, iters=10)
    print(f"  {tag}: render {ms['render']:.3f} ms a b{TRAIN_BATCH} "
          f"{TRAIN_SIZE}x{TRAIN_SIZE} batch (CUDA events, eager, mean of 20)",
          flush=True)


def phase_train_mosaic(dev, root, tag):
    """Phase 8a, train: v11s through the mosaic, then letterbox. Returns
    (train launches, predict launches of the served best.bin)."""
    from yolosharp_tpu_torch import Config, YoloSize, YoloTask, YoloType
    from yolosharp_tpu_torch.data import device_augment
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 8a: YoloTask.train() of v11s, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"batch {TRAIN_BATCH}, bf16, close_mosaic=1, 2 epochs", flush=True)
    out = os.path.join(root, "run_v11s")
    task = YoloTask(_train_config(root, "v11", output_path=out,
                                  close_mosaic=1, epochs=2), device=dev)
    renders = []
    real = device_augment.render_batch
    device_augment.render_batch = lambda b: renders.append(1) or real(b)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        task.train()
    finally:
        device_augment.render_batch = real
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = task.task.epoch_stats
    for st in stats:
        print("  " + epoch_line(st, f"{tag}: v11s"), flush=True)
    print(f"  renders {len(renders)} (epoch 1 steps "
          f"{len(stats[0]['step_s'])}); train() {wall:.1f} s; kernel "
          f"launches during train(): {counts}", flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    losses = [float(v) for r in rows[1:] for h, v in zip(rows[0], r)
              if "loss" in h]
    print(f"  log.csv losses: {losses}", flush=True)
    if ([s["epoch"] for s in stats] != [1, 2]
            or len(renders) != len(stats[0]["step_s"]) or not renders
            or not np.isfinite(losses).all() or any(counts.values())):
        raise SystemExit("v11s mosaic train(): wrong epochs, renders, "
                         "losses or a kernel launch in training")
    fresh = YoloTask(Config(yolo_type=YoloType.v11, yolo_size=YoloSize.s,
                            number_class=80), device=dev)
    fresh.load_model(os.path.join(out, "weights", "best.bin"))
    reset_launch_counts()
    res = fresh.image_predict(synthetic_images(1, 640, 640, 51)[0], 0.0)
    served = launch_counts()
    print(f"  best.bin in a fresh v11s YoloTask: image_predict gave "
          f"{len(res)} rows, kernel launches {served}", flush=True)
    if not res:
        raise SystemExit("image_predict of the trained v11s returned "
                         "nothing")
    check_path_launches("v11", served, "v11s best.bin")
    return counts, served


def phase_train_host_mosaic(dev, root, tag):
    """Phase 8b: v8s with the host mosaic at mosaic=0.5. Returns its
    launch counts."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.data import augment
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 8b: YoloTask.train() of v8s, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"batch {TRAIN_BATCH}, bf16, 1 epoch, device_augment=False, "
          f"mosaic=0.5 (host mosaic4 + random_perspective, and letterbox)",
          flush=True)
    out = os.path.join(root, "run_v8s_host_mosaic")
    task = YoloTask(_train_config(root, "v8", output_path=out,
                                  close_mosaic=1, device_augment=False,
                                  mosaic=0.5), device=dev)
    calls = {"mosaic4": 0, "letterbox": 0}
    real = {k: getattr(augment, k) for k in calls}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    for name in calls:
        setattr(augment, name, counted(name))
    reset_launch_counts()
    try:
        task.train()
    finally:
        for name, fn in real.items():
            setattr(augment, name, fn)
    counts = launch_counts()
    st = task.task.epoch_stats[0]
    print("  " + epoch_line(st, f"{tag}: v8s host mosaic"), flush=True)
    print(f"  images through mosaic4 {calls['mosaic4']}, through letterbox "
          f"{calls['letterbox']}; kernel launches {counts}", flush=True)
    if not calls["mosaic4"] or not calls["letterbox"] or any(counts.values()):
        raise SystemExit("host mosaic train(): no mosaic or no letterbox "
                         "image, or a kernel launch in training")
    return counts


# --------------------------------------------------------------- segment
SEG_BATCH = 8


def write_seg_dataset(root, n_train, n_val, seed=8):
    """Images of 480-800 px a side, a noisy background and 1-8 polygons of
    3-12 vertices (star-shaped about a random centre, overlapping, clipped
    to the image) filled in solid colours, with YOLO segment labels (80
    classes: the class, then the polygon's normalised x y pairs) under
    root/images/{train,val} and root/labels/{train,val}, as PNG (zlib
    level 1)."""
    from yolosharp_tpu_torch.data.image_ops import encode_png, fill_poly

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "labels", split))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(480, 801, 2))
            img = np.clip(rng.normal(rng.uniform(40, 215), 20, (h, w, 3)),
                          0, 255).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 9))):
                k = int(rng.integers(3, 13))
                ang = np.sort(rng.uniform(0, 2 * np.pi, k))
                rad = rng.uniform(0.05, 0.3) * rng.uniform(0.5, 1.0, k)
                pts = np.clip(rng.uniform(0.15, 0.85, 2) + rad[:, None]
                              * np.stack([np.cos(ang), np.sin(ang)], -1),
                              0, 1)
                shape = np.zeros((h, w), np.uint8)
                fill_poly(shape, (pts * [w, h]).astype(np.int32), 1)
                img[shape > 0] = rng.integers(0, 256, 3)
                rows.append(f"{rng.integers(80)} " + " ".join(
                    f"{v:.6f}" for v in pts.reshape(-1)))
            with open(os.path.join(root, "images", split, f"{i:04d}.png"),
                      "wb") as f:
                f.write(encode_png(img, level=1))
            with open(os.path.join(root, "labels", split, f"{i:04d}.txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


def _seg_train_config(root, **kw):
    kw = {"epochs": 1, **kw}
    return path_config(SEG, root_path=root, train_data_path="images/train",
                       val_data_path="images/val", image_size=TRAIN_SIZE,
                       batch_size=SEG_BATCH, **kw)


def phase_seg_render(dev, root, tag):
    """Phase 9c: one planned v11m-seg batch's masks rendered on the card and
    on the CPU."""
    from yolosharp_tpu_torch.data import YoloDataset
    from yolosharp_tpu_torch.data.device_augment import (PLAN_KEYS,
                                                         render_batch,
                                                         render_masks)

    print(f"phase 9c: the device render of one planned b{SEG_BATCH} "
          f"{TRAIN_SIZE}x{TRAIN_SIZE} segment batch's masks (degrees 10, "
          f"shear 2, perspective 5e-4), card against CPU", flush=True)
    ds = YoloDataset(_seg_train_config(root, degrees=10.0, shear=2.0,
                                       perspective=5e-4))
    batch = ds.device_batch(np.arange(SEG_BATCH), ds.max_label_count)
    keys = ("aug_pool", "aug_mask_pool", "aug_mask_lut") + PLAN_KEYS
    on_card = {k: torch.from_numpy(batch[k]).to(dev) for k in keys}
    got = render_masks(on_card)
    want = render_masks({k: torch.from_numpy(batch[k]) for k in keys})
    frac = float((got.cpu() != want).float().mean())
    print(f"  card vs CPU: {frac:.3e} of {want.numel()} mask ids differ (at "
          f"most 1e-3); output {tuple(got.shape)} {got.dtype}, ids up to "
          f"{int(got.max())}, {int((got > 0).sum())} foreground", flush=True)
    if frac > 1e-3 or not int(got.max()):
        raise SystemExit("the device render of the masks disagrees with the "
                         "CPU's, or is empty")
    ms = time_eager({"images": lambda: render_batch(on_card),
                     "masks": lambda: render_masks(on_card)}, iters=10)
    print(f"  {tag}: render {ms['images']:.3f} ms images + {ms['masks']:.3f} "
          f"ms masks a b{SEG_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE} batch (CUDA "
          f"events, eager, mean of 20)", flush=True)


def phase_seg_train(dev, root, tag):
    """Phase 9d: YoloTask.train() of v11m-seg through the mosaic, then
    letterbox. Returns (train launches, predict launches of the served
    best.bin)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.data import device_augment
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 9d: YoloTask.train() of {SEG}, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"batch {SEG_BATCH}, bf16, close_mosaic=1, 2 epochs", flush=True)
    out = os.path.join(root, "run_v11m_seg")
    task = YoloTask(_seg_train_config(root, output_path=out, close_mosaic=1,
                                      epochs=2), device=dev)
    renders = []
    real = device_augment.render_masks
    device_augment.render_masks = lambda b: renders.append(1) or real(b)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        task.train()
    finally:
        device_augment.render_masks = real
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = task.task.epoch_stats
    for st in stats:
        print("  " + epoch_line(st, f"{tag}: {SEG}", SEG_BATCH), flush=True)
    print(f"  mask renders {len(renders)} (epoch 1 steps "
          f"{len(stats[0]['step_s'])}); train() {wall:.1f} s; kernel "
          f"launches during train(): {counts}", flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    head = [h.strip() for h in rows[0]]
    for r in rows[1:]:
        print(f"  log.csv epoch {r[0]}: " + ", ".join(
            f"{h} {v.strip()}" for h, v in zip(head[2:], r[2:])), flush=True)
    losses = [float(v) for r in rows[1:] for h, v in zip(head, r)
              if "loss" in h or "semseg" in h]
    metrics = [h for h in head if h.startswith("metrics/")]
    if ([s["epoch"] for s in stats] != [1, 2]
            or len(renders) != len(stats[0]["step_s"]) or not renders
            or not np.isfinite(losses).all() or len(metrics) != 8
            or any(counts.values())):
        raise SystemExit(f"{SEG} train(): wrong epochs, renders, losses or "
                         f"metrics, or a kernel launch in training")
    fresh = YoloTask(path_config(SEG), device=dev)
    fresh.load_model(os.path.join(out, "weights", "best.bin"))
    image = synthetic_images(1, 640, 640, 52)[0]
    reset_launch_counts()
    res = fresh.image_predict(image, 0.0)
    served = launch_counts()
    print(f"  best.bin in a fresh {SEG} YoloTask: image_predict gave "
          f"{len(res)} rows with masks, kernel launches {served}",
          flush=True)
    if not res:
        raise SystemExit(f"image_predict of the trained {SEG} returned "
                         f"nothing")
    check_masks([res], [image], f"{SEG} best.bin")
    check_path_launches(SEG, served, f"{SEG} best.bin")
    return counts, served


# the self-labelled val set of phase 9e: images, labels an image, the
# smallest mask labelled (pixels), the least share of its row-span polygon
# the mask must fill, and the most of a label's polygon an earlier one of
# the image may cover
SELF_VAL, SELF_LABELS, SELF_MIN_PX, SELF_FILL, SELF_OVERLAP = (8, 8, 400,
                                                               0.8, 0.1)
# the eight val metrics, card f32 against CPU f32: at most this far apart
VAL_TOL = 0.02


def row_span_polygon(mask):
    """The polygon around a bool mask's row spans: down the left ends of
    its rows, up the right ends (pixel edges), (n, 2) float image
    coordinates."""
    ys = np.flatnonzero(mask.any(1))
    left = np.array([np.flatnonzero(mask[y])[0] for y in ys], float)
    right = np.array([np.flatnonzero(mask[y])[-1] + 1 for y in ys], float)
    down = np.stack([np.repeat(left, 2),
                     np.stack([ys, ys + 1], 1).reshape(-1)], 1)
    up = np.stack([np.repeat(right, 2),
                   np.stack([ys + 1, ys], 1).reshape(-1)], 1)[::-1]
    return np.concatenate([down, up])


def write_self_labelled(root, task, conf):
    """SELF_VAL 640x640 val images labelled with task's own predictions:
    per image up to SELF_LABELS of its highest-scored results whose mask
    has at least SELF_MIN_PX pixels, fills at least SELF_FILL of its
    row-span polygon and lies at most SELF_OVERLAP under the labels taken
    before it; each is written as its class and that polygon. Returns the
    labels written."""
    from yolosharp_tpu_torch.data.image_ops import encode_png, fill_poly

    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub, "val"))
    total = 0
    for i, img in enumerate(synthetic_images(SELF_VAL, 640, 640, 60)):
        h, w = img.shape[:2]
        taken = np.zeros((h, w), np.uint8)
        rows = []
        for r in sorted(task.image_predict(img, conf), key=lambda r: -r.score):
            if len(rows) == SELF_LABELS:
                break
            if r.mask.sum() < SELF_MIN_PX:
                continue
            poly = row_span_polygon(r.mask)
            region = np.zeros((h, w), np.uint8)
            fill_poly(region, poly.astype(np.int32), 1)
            area = int(region.sum())
            if (r.mask.sum() < SELF_FILL * area
                    or (taken & region).sum() > SELF_OVERLAP * area):
                continue
            taken |= region
            rows.append(f"{r.class_id} " + " ".join(
                f"{v:.6f}" for v in (poly / [w, h]).reshape(-1)))
        total += len(rows)
        with open(os.path.join(root, "images", "val", f"{i:04d}.png"),
                  "wb") as f:
            f.write(encode_png(img, level=1))
        with open(os.path.join(root, "labels", "val", f"{i:04d}.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    return total


def phase_seg_val(dev, root, state, conf):
    """Phase 9e: Segmenter.val of the seeded v11m-seg in float32 on the card
    and on the CPU, on a val set labelled with its own predictions."""
    from yolosharp_tpu_torch import ScalarType

    print(f"phase 9e: {SEG} val, seeded weights, float32, card against CPU, "
          f"on {SELF_VAL} 640x640 images labelled with its own predictions",
          flush=True)
    cfg = dict(scalar_type=ScalarType.float32, root_path=root,
               train_data_path="images/val", val_data_path="images/val",
               image_size=640, batch_size=SELF_VAL)
    cuda = build_tasks(dev, SEG, state, **cfg)
    n = write_self_labelled(root, cuda[False], conf)
    print(f"  {n} labels (at most {SELF_LABELS} an image)", flush=True)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    names = cuda[False].task.metric_names
    for e2e, ratio in ((False, 4), (True, 2)):
        mode = (f"{SEG} {'end2end' if e2e else 'nms'}, mask_ratio {ratio}"
                + (" (the ground truth's masks resized nearest to the "
                   "proto grid)" if ratio != 4 else ""))
        got, want = (build_tasks(d, SEG, st, mask_ratio=ratio, **cfg)[e2e]
                     .val()[1] for d, st in ((dev, state),
                                             ("cpu", cpu_state)))
        print(f"  [{mode}] card / CPU: " + ", ".join(
            f"{k} {g:.4f} / {c:.4f}" for k, g, c in zip(names, got, want)),
            flush=True)
        gap = max(abs(g - c) for g, c in zip(got, want))
        print(f"  [{mode}] largest gap {gap:.4f} (at most {VAL_TOL}); "
              f"mAP50 box / mask above 0 on both", flush=True)
        if (gap > VAL_TOL or len(got) != 8
                or min(got[2], got[6], want[2], want[6]) <= 0):
            raise SystemExit(f"[{mode}] val on the card and on the CPU "
                             f"disagree, or a mAP50 is 0")


# ------------------------------------------------------------------ pose
POSE_BATCH = 8


def write_pose_dataset(root, n_train, n_val, seed=9):
    """Images of 480-800 px a side, a noisy background and 1-8 solid
    rectangles, with YOLO pose labels (one class: the class, the box's
    normalised xywh, then 17 keypoints inside the box of x, y and a
    visibility drawn from {0, 1, 2}; half of the invisible ones at (0, 0),
    as COCO writes them) under root/images/{train,val} and
    root/labels/{train,val}, as PNG (zlib level 1)."""
    from yolosharp_tpu_torch.data.image_ops import encode_png

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "labels", split))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(480, 801, 2))
            img = np.clip(rng.normal(rng.uniform(40, 215), 20, (h, w, 3)),
                          0, 255).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 9))):
                bw, bh = rng.uniform(0.05, 0.5, 2)
                cx = rng.uniform(bw / 2, 1 - bw / 2)
                cy = rng.uniform(bh / 2, 1 - bh / 2)
                img[int((cy - bh / 2) * h):int((cy + bh / 2) * h),
                    int((cx - bw / 2) * w):int((cx + bw / 2) * w)] = \
                    rng.integers(0, 256, 3)
                xy = np.stack([rng.uniform(cx - bw / 2, cx + bw / 2, 17),
                               rng.uniform(cy - bh / 2, cy + bh / 2, 17)], -1)
                vis = rng.integers(0, 3, 17)
                xy[(vis == 0) & (rng.uniform(0, 1, 17) < 0.5)] = 0.0
                pts = np.concatenate([xy, vis[:, None]], -1)
                rows.append(f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f} "
                            + " ".join(f"{v:.6f}" for v in pts.reshape(-1)))
            with open(os.path.join(root, "images", split, f"{i:04d}.png"),
                      "wb") as f:
                f.write(encode_png(img, level=1))
            with open(os.path.join(root, "labels", split, f"{i:04d}.txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


def _pose_train_config(root, **kw):
    kw = {"epochs": 1, **kw}
    return path_config(POSE, root_path=root, train_data_path="images/train",
                       val_data_path="images/val", image_size=TRAIN_SIZE,
                       batch_size=POSE_BATCH, **kw)


def phase_pose_train(dev, root, tag):
    """Phase 10c: YoloTask.train() of v11m-pose through the mosaic, then
    letterbox. Returns (train launches, predict launches of the served
    best.bin)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.data import device_augment
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 10c: YoloTask.train() of {POSE}, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"batch {POSE_BATCH}, bf16, close_mosaic=1, 2 epochs", flush=True)
    out = os.path.join(root, "run_v11m_pose")
    task = YoloTask(_pose_train_config(root, output_path=out, close_mosaic=1,
                                       epochs=2), device=dev)
    visible = []    # the visible keypoints of each planned batch
    real = device_augment.render_batch
    device_augment.render_batch = lambda b: visible.append(
        int((b["keypoints"][..., 2] > 0).sum())) or real(b)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        task.train()
    finally:
        device_augment.render_batch = real
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = task.task.epoch_stats
    for st in stats:
        print("  " + epoch_line(st, f"{tag}: {POSE}", POSE_BATCH), flush=True)
    print(f"  renders {len(visible)} (epoch 1 steps "
          f"{len(stats[0]['step_s'])}), visible keypoints a planned batch "
          f"{visible}; train() {wall:.1f} s; kernel launches during "
          f"train(): {counts}", flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    head = [h.strip() for h in rows[0]]
    for r in rows[1:]:
        print(f"  log.csv epoch {r[0]}: " + ", ".join(
            f"{h} {v.strip()}" for h, v in zip(head[2:], r[2:])), flush=True)
    losses = [float(v) for r in rows[1:] for h, v in zip(head, r)
              if "loss" in h]
    metrics = [h for h in head if h.startswith("metrics/")]
    if ([s["epoch"] for s in stats] != [1, 2]
            or len(visible) != len(stats[0]["step_s"]) or not visible
            or not all(visible) or not np.isfinite(losses).all()
            or len(metrics) != 8 or any(counts.values())):
        raise SystemExit(f"{POSE} train(): wrong epochs, renders, "
                         f"keypoints, losses or metrics, or a kernel launch "
                         f"in training")
    fresh = YoloTask(path_config(POSE), device=dev)
    fresh.load_model(os.path.join(out, "weights", "best.bin"))
    image = synthetic_images(1, 640, 640, 53)[0]
    reset_launch_counts()
    res = fresh.image_predict(image, 0.0)
    served = launch_counts()
    print(f"  best.bin in a fresh {POSE} YoloTask: image_predict gave "
          f"{len(res)} rows with keypoints, kernel launches {served}",
          flush=True)
    if not res:
        raise SystemExit(f"image_predict of the trained {POSE} returned "
                         f"nothing")
    check_keypoints([res], f"{POSE} best.bin")
    check_path_launches(POSE, served, f"{POSE} best.bin")
    return counts, served


# the self-labelled val set of phase 10d: a keypoint is written visible (2)
# where its predicted visibility is above POSE_VIS, else 0; a label keeps
# at least POSE_MIN_VIS visible (its most visible ones)
POSE_VIS, POSE_MIN_VIS = 0.5, 3


def write_self_labelled_pose(root, task, conf):
    """SELF_VAL 640x640 val images labelled with task's own predictions:
    per image its SELF_LABELS highest-scored results, each written as its
    class, its box and its 17 keypoints (visibility by POSE_VIS and
    POSE_MIN_VIS). Returns (labels written, visible keypoints)."""
    from yolosharp_tpu_torch.data.image_ops import encode_png

    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub, "val"))
    total = visible = 0
    for i, img in enumerate(synthetic_images(SELF_VAL, 640, 640, 61)):
        h, w = img.shape[:2]
        rows = []
        for r in sorted(task.image_predict(img, conf),
                        key=lambda r: -r.score)[:SELF_LABELS]:
            kp = np.array([(p.x, p.y, p.visibility) for p in r.keypoints])
            vis = kp[:, 2] > POSE_VIS
            vis[np.argsort(-kp[:, 2])[:POSE_MIN_VIS]] = True
            kp[:, 2] = np.where(vis, 2.0, 0.0)
            kp[:, :2] /= [w, h]
            visible += int(vis.sum())
            rows.append(f"{r.class_id} {r.center_x / w:.6f} "
                        f"{r.center_y / h:.6f} {r.width / w:.6f} "
                        f"{r.height / h:.6f} " + " ".join(
                            f"{v:.6f}" for v in kp.reshape(-1)))
        total += len(rows)
        with open(os.path.join(root, "images", "val", f"{i:04d}.png"),
                  "wb") as f:
            f.write(encode_png(img, level=1))
        with open(os.path.join(root, "labels", "val", f"{i:04d}.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    return total, visible


def phase_pose_val(dev, root, state, conf):
    """Phase 10d: PoseDetector.val of the seeded v11m-pose in float32 on the
    card and on the CPU, on a val set labelled with its own predictions."""
    from yolosharp_tpu_torch import ScalarType

    print(f"phase 10d: {POSE} val, seeded weights, float32, card against "
          f"CPU, on {SELF_VAL} 640x640 images labelled with its own "
          f"predictions", flush=True)
    cfg = dict(scalar_type=ScalarType.float32, root_path=root,
               train_data_path="images/val", val_data_path="images/val",
               image_size=640, batch_size=SELF_VAL)
    cuda = build_tasks(dev, POSE, state, **cfg)
    n, visible = write_self_labelled_pose(root, cuda[False], conf)
    print(f"  {n} labels (at most {SELF_LABELS} an image), {visible} of "
          f"{17 * n} keypoints visible", flush=True)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    names = cuda[False].task.metric_names
    for e2e in (False, True):
        mode = f"{POSE} {'end2end' if e2e else 'nms'}"
        got, want = (build_tasks(d, POSE, st, **cfg)[e2e].val()[1]
                     for d, st in ((dev, state), ("cpu", cpu_state)))
        print(f"  [{mode}] card / CPU: " + ", ".join(
            f"{k} {g:.4f} / {c:.4f}" for k, g, c in zip(names, got, want)),
            flush=True)
        gap = max(abs(g - c) for g, c in zip(got, want))
        print(f"  [{mode}] largest gap {gap:.4f} (at most {VAL_TOL}); "
              f"mAP50 box / pose above 0 on both", flush=True)
        if (gap > VAL_TOL or len(got) != 8
                or min(got[2], got[6], want[2], want[6]) <= 0):
            raise SystemExit(f"[{mode}] val on the card and on the CPU "
                             f"disagree, or a mAP50 is 0")


# ------------------------------------------------------------------- obb
# phase 11c's batches (4: the JAX bench's workload 5; and 8) and data;
# phase 11d's self-labelled images (fewer than SELF_VAL: the CPU's float32
# val of v12x-obb runs the rotated NMS over every anchor above 0.01)
OBB_BATCHES, OBB_TRAIN, OBB_VAL, OBB_SELF_VAL = (4, 8), 48, 8, 4
# phase 11d: the four box metrics, card f32 against CPU f32, at most this
# far apart
OBB_VAL_TOL = 0.005


def rect_corners(cx, cy, w, h, angle) -> np.ndarray:
    """The 4 corners (4, 2) of a rotated rectangle, in the order of the
    port's xywhr2xyxyxyxy."""
    c, s = np.cos(angle), np.sin(angle)
    v1 = np.array([w / 2 * c, w / 2 * s])
    v2 = np.array([-h / 2 * s, h / 2 * c])
    ct = np.array([cx, cy])
    return np.stack([ct + v1 + v2, ct + v1 - v2, ct - v1 - v2, ct - v1 + v2])


def write_obb_dataset(root, n_train, n_val, seed=11):
    """Images of 480-800 px a side, a noisy background and 1-8 solid
    rotated rectangles drawn by the port's fill_poly, with YOLO OBB labels
    (15 classes: the class and the rectangle's 4 corners, normalised; some
    corners outside the image) under root/images/{train,val} and
    root/labels/{train,val}, as PNG (zlib level 1)."""
    from yolosharp_tpu_torch.data.image_ops import encode_png, fill_poly

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "labels", split))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(480, 801, 2))
            img = np.clip(rng.normal(rng.uniform(40, 215), 20, (h, w, 3)),
                          0, 255).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 9))):
                bw, bh = rng.uniform(0.05, 0.4, 2) * min(h, w)
                cor = rect_corners(rng.uniform(0.1, 0.9) * w,
                                   rng.uniform(0.1, 0.9) * h, bw, bh,
                                   rng.uniform(-np.pi, np.pi))
                plane = np.zeros((h, w), np.uint8)
                fill_poly(plane, cor.astype(np.int32), 1)
                img[plane > 0] = rng.integers(0, 256, 3)
                rows.append(f"{rng.integers(15)} " + " ".join(
                    f"{v:.6f}" for v in (cor / [w, h]).reshape(-1)))
            with open(os.path.join(root, "images", split, f"{i:04d}.png"),
                      "wb") as f:
                f.write(encode_png(img, level=1))
            with open(os.path.join(root, "labels", split, f"{i:04d}.txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")


def phase_obb_train(dev, root, tag, batch):
    """Phase 11c: YoloTask.train() of v12x-obb through the mosaic (the
    device render), then letterbox. Returns (train launches, predict
    launches of the served best.bin)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.data import device_augment
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 11c: YoloTask.train() of {OBB} (End2End), "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}, batch {batch}, bf16, close_mosaic=1, "
          f"2 epochs, {OBB_TRAIN} train and {OBB_VAL} val images",
          flush=True)
    out = os.path.join(root, f"run_v12x_obb_b{batch}")
    task = YoloTask(path_config(
        OBB, end2end=True, root_path=root, train_data_path="images/train",
        val_data_path="images/val", image_size=TRAIN_SIZE, batch_size=batch,
        output_path=out, close_mosaic=1, epochs=2), device=dev)
    labels = []     # the labels of each planned batch
    real = device_augment.render_batch
    device_augment.render_batch = lambda b: labels.append(
        int(b["mask_gt"].sum())) or real(b)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state = task.train()
    finally:
        device_augment.render_batch = real
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = task.task.epoch_stats
    name = f"{OBB} b{batch}"
    for st in stats:
        print("  " + epoch_line(st, f"{tag}: {name}", batch), flush=True)
    print(f"  renders {len(labels)} (epoch 1 steps "
          f"{len(stats[0]['step_s'])}), labels a planned batch {labels}; "
          f"{state.count} updates applied in {state.step} steps (a step "
          f"with a non-finite gradient is skipped); train() {wall:.1f} s; "
          f"kernel launches during train(): {counts}", flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    head = [h.strip() for h in rows[0]]
    for r in rows[1:]:
        print(f"  log.csv epoch {r[0]}: " + ", ".join(
            f"{h} {v.strip()}" for h, v in zip(head[2:], r[2:])), flush=True)
    losses = [float(v) for r in rows[1:] for h, v in zip(head, r)
              if "loss" in h]
    metrics = [h for h in head if h.startswith("metrics/")]
    if ([s["epoch"] for s in stats] != [1, 2]
            or len(labels) != len(stats[0]["step_s"]) or not all(labels)
            or not np.isfinite(losses).all() or len(metrics) != 4
            or "train/angle_loss" not in head
            or counts["conv3x3_silu"] or counts["conv3x3s2_silu"]
            or not counts["fused_attention"]
            or not counts["fused_attention_bwd"]):
        raise SystemExit(f"{name} train(): wrong epochs, renders, labels, "
                         f"losses or metrics, a conv kernel launch in "
                         f"training or no attention forward or backward "
                         f"launch")
    fresh = YoloTask(path_config(OBB, end2end=True), device=dev)
    fresh.load_model(os.path.join(out, "weights", "best.bin"))
    image = synthetic_images(1, 640, 640, 54)[0]
    reset_launch_counts()
    res = fresh.image_predict(image, 0.0)
    served = launch_counts()
    print(f"  best.bin in a fresh {OBB} YoloTask: image_predict gave "
          f"{len(res)} rotated rows, kernel launches {served}", flush=True)
    if not res:
        raise SystemExit(f"image_predict of the trained {name} returned "
                         f"nothing")
    check_rotated([res], f"{name} best.bin")
    check_path_launches(OBB, served, f"{name} best.bin")
    return counts, served


def write_self_labelled_obb(root, task, conf):
    """OBB_SELF_VAL 640x640 val images labelled with task's own
    predictions: per image its SELF_LABELS highest-scored results, each
    written as its class and the 4 corners of its rotated box. Returns the
    labels written."""
    from yolosharp_tpu_torch.data.image_ops import encode_png

    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub, "val"))
    total = 0
    for i, img in enumerate(synthetic_images(OBB_SELF_VAL, 640, 640, 62)):
        h, w = img.shape[:2]
        rows = []
        for r in sorted(task.image_predict(img, conf),
                        key=lambda r: -r.score)[:SELF_LABELS]:
            cor = rect_corners(r.center_x, r.center_y, r.width, r.height,
                               r.radian)
            rows.append(f"{r.class_id} " + " ".join(
                f"{v:.6f}" for v in (cor / [w, h]).reshape(-1)))
        total += len(rows)
        with open(os.path.join(root, "images", "val", f"{i:04d}.png"),
                  "wb") as f:
            f.write(encode_png(img, level=1))
        with open(os.path.join(root, "labels", "val", f"{i:04d}.txt"),
                  "w") as f:
            f.write("\n".join(rows) + "\n")
    return total


def phase_obb_val(dev, root, state, conf):
    """Phase 11d: Obber.val of the seeded v12x-obb in float32 on the card
    and on the CPU, on a val set labelled with its own predictions."""
    from yolosharp_tpu_torch import ScalarType

    print(f"phase 11d: {OBB} val, seeded weights, float32, card against "
          f"CPU, both on the same {OBB_SELF_VAL} 640x640 images labelled "
          f"with its own predictions", flush=True)
    cfg = dict(scalar_type=ScalarType.float32, root_path=root,
               train_data_path="images/val", val_data_path="images/val",
               image_size=640, batch_size=OBB_SELF_VAL)
    cuda = build_tasks(dev, OBB, state, **cfg)
    n = write_self_labelled_obb(root, cuda[False], conf)
    print(f"  {n} labels (at most {SELF_LABELS} an image)", flush=True)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    names = cuda[False].task.metric_names
    for e2e in (False, True):
        mode = f"{OBB} {'end2end' if e2e else 'nms'}"
        seconds, results = [], []
        for d, st in ((dev, state), ("cpu", cpu_state)):
            t0 = time.perf_counter()
            results.append(build_tasks(d, OBB, st, **cfg)[e2e].val()[1])
            seconds.append(time.perf_counter() - t0)
        got, want = results
        print(f"  [{mode}] card / CPU ({seconds[0]:.1f} / {seconds[1]:.1f} "
              f"s): " + ", ".join(f"{k} {g:.4f} / {c:.4f}"
                                  for k, g, c in zip(names, got, want)),
              flush=True)
        gap = max(abs(g - c) for g, c in zip(got, want))
        print(f"  [{mode}] largest gap {gap:.4f} (at most {OBB_VAL_TOL}); "
              f"box mAP50 above 0 on both", flush=True)
        if gap > OBB_VAL_TOL or len(got) != 4 or min(got[2], want[2]) <= 0:
            raise SystemExit(f"[{mode}] val on the card and on the CPU "
                             f"disagree, or the mAP50 is 0")


# --------------------------------------------------------------- classify
# phase 12c's set: classes, train and val images a class, their sides
CLS_CLASSES, CLS_TRAIN, CLS_VAL, CLS_SIDES = 10, 32, 8, (160, 401)
CLS_TRAIN_BATCH = 32
# the classify models' ConvBN kernel scale in seed_weights: at 2.5 the
# trunk's activations shrink ~12x by layer 8 and every image takes the
# same top 1 (logits 0.0035 apart across images, 0.28 across classes); at
# 2.8 the logits vary across images (0.72 against 1.27), at 2.9 they
# saturate (measured on the CPU in float32 at 224)
CLS_SEED_SCALE = 2.8
# phase 12b: the float32 probabilities, card against CPU, at most this far
# apart; top-5 orders are compared where neighbouring scores differ more
CLS_PROB_TOL = 1e-5


def cls_task(dev, path, state=None, **cfg):
    """A classify YoloTask of the path's model (ARCH, PATH_NC) at 224 on
    `dev`, with `state` loaded where given."""
    from yolosharp_tpu_torch import YoloTask

    task = YoloTask(path_config(path, image_size=CLS_CANVAS[0], **cfg),
                    device=dev)
    if state is not None:
        task.task._ensure_variables().load_state_dict(state, strict=True)
    return task


def check_top5(results, mode, nc):
    """Each classify result is min(5, nc) distinct classes of [0, nc) with
    finite scores in (0, 1], in descending order."""
    k = min(5, nc)
    bad = [i for i, rs in enumerate(results)
           if len(rs) != k or len({r.class_id for r in rs}) != k
           or not all(0 <= r.class_id < nc and 0 < r.score <= 1
                      for r in rs)
           or any(a.score < b.score for a, b in zip(rs, rs[1:]))]
    if bad:
        raise SystemExit(f"[{mode}] top-5 results wrong for images {bad}: "
                         f"{results[bad[0]]}")


def cls_input(dev, images, dtype):
    """uint8 (B, 224, 224, 3) images as the predict copy's input."""
    x = torch.from_numpy(np.stack(images)).to(dev).permute(0, 3, 1, 2)
    return (x.float() / 255.0).to(dtype).contiguous(
        memory_format=torch.channels_last)


def phase_cls_slice(dev):
    """Phase 12a: v8s-cls (nc = 1000) at 224, bf16, seeded weights: the b32
    forward and its launches against the model's modules, batch_predict
    b32 and image_predict at three sizes, a float16 b32 batch_predict, a
    v11s-cls b32 batch_predict. Returns (launches of the requests, the
    launches of one b32 forward by path, the v8s-cls state dict)."""
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 12a: {CLS} nc=1000 YoloTask on cuda, bf16, 224x224, seeded "
          f"weights", flush=True)
    task = cls_task(dev, CLS)
    seed_weights(task.task._ensure_variables(), scale=CLS_SEED_SCALE)
    state = {k: v.detach().clone()
             for k, v in task.task.net.state_dict().items()}
    batch = synthetic_images(SERVED_BATCH, 224, 224, 60)
    fwd = task.task._predict_variables()
    x = cls_input(dev, batch, task.task.dtype)
    per_forward = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        reset_launch_counts()
        fwd(x)
        got, want = launch_counts(), expected_launches(fwd)
        print(f"  [{CLS}] kernel launches of one b32 forward: {got}, from "
              f"the model's modules {want}", flush=True)
        if got != want or (got["conv3x3_silu"], got["conv3x3s2_silu"],
                           got["c2f_fused"], got["fused_attention"]) != (
                               8, 5, 2, 0):
            raise SystemExit(f"[{CLS}] launches a forward are not the "
                             f"modules' 8 s1 + 5 s2 + 2 C2f")
        per_forward[CLS] = got
        start.record()
        for _ in range(10):
            fwd(x)
        end.record()
    torch.cuda.synchronize()
    print(f"  [{CLS}] network forward bf16 batch 32 224x224: "
          f"{start.elapsed_time(end) / 10:.3f} ms (CUDA events, mean of 10)",
          flush=True)
    singles = [synthetic_images(1, 224, 224, 61)[0],
               synthetic_images(1, 480, 640, 62)[0],
               synthetic_images(1, 500, 375, 63)[0]]
    task.image_predict(singles[0])      # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    for img in singles:
        t0 = time.perf_counter()
        res = task.image_predict(img)
        ms = (time.perf_counter() - t0) * 1e3
        check_top5([res], f"{CLS} image_predict", 1000)
        print(f"  [{CLS}] image_predict {img.shape[0]}x{img.shape[1]}: top 5 "
              f"{[(r.class_id, round(r.score, 5)) for r in res]}, {ms:.2f} "
              f"ms", flush=True)
    for rep in range(3):
        t0 = time.perf_counter()
        res = task.batch_predict(batch)
        s = time.perf_counter() - t0
        check_top5(res, f"{CLS} batch_predict", 1000)
        print(f"  [{CLS}] batch_predict {len(batch)}x224x224 #{rep}: "
              f"{s * 1e3:.2f} ms, {len(batch) / s:.1f} img/s; top-1 scores "
              f"min {min(r[0].score for r in res):.4f} max "
              f"{max(r[0].score for r in res):.4f}", flush=True)
    launches = launch_counts()
    print(f"  [{CLS}] kernel launches: {launches}", flush=True)
    check_path_launches(CLS, launches, f"{CLS} bf16")

    f16 = cls_task(dev, CLS, state, true_fp16=True)
    if f16.task.dtype != torch.float16:
        raise SystemExit(f"true_fp16 computes in {f16.task.dtype}")
    f16.batch_predict(batch)
    reset_launch_counts()
    res16 = f16.batch_predict(batch)
    counts = launch_counts()
    check_top5(res16, f"{CLS} float16", 1000)
    same = np.mean([a[0].class_id == b[0].class_id
                    for a, b in zip(res16, res)])
    print(f"  [{CLS}] float16 b32 batch_predict: kernel launches {counts}; "
          f"top-1 class as bf16's on {same:.3f} of the images", flush=True)
    check_path_launches(CLS, counts, f"{CLS} float16")
    for name in ALL_KERNELS:
        launches[name] += counts[name]

    t11 = cls_task(dev, CLS11)
    seed_weights(t11.task._ensure_variables(), scale=CLS_SEED_SCALE)
    with torch.no_grad():
        reset_launch_counts()
        t11.task._predict_variables()(x)
        per_forward[CLS11] = launch_counts()
    print(f"  [{CLS11}] kernel launches of one b32 forward: "
          f"{per_forward[CLS11]}", flush=True)
    t11.batch_predict(batch)
    reset_launch_counts()
    t0 = time.perf_counter()
    res11 = t11.batch_predict(batch)
    s = time.perf_counter() - t0
    counts = launch_counts()
    check_top5(res11, CLS11, 1000)
    print(f"  [{CLS11}] batch_predict {len(batch)}x224x224: {s * 1e3:.2f} ms, "
          f"kernel launches {counts}", flush=True)
    check_path_launches(CLS11, counts, CLS11)
    for name in ALL_KERNELS:
        launches[name] += counts[name]
    return launches, per_forward, state


def phase_cls_cpu_match(dev, state):
    """Phase 12b: v8s-cls in float32, the card against the CPU's plain
    versions: the softmax of 8 squashed images within CLS_PROB_TOL, and
    batch_predict's top 5 the same classes wherever neighbouring scores
    are more than CLS_PROB_TOL apart."""
    from yolosharp_tpu_torch import ScalarType
    from yolosharp_tpu_torch.data.image_ops import resize_linear
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 12b: {CLS} float32 on the card against float32 on the CPU "
          f"(plain versions), 8 images", flush=True)
    images = (synthetic_images(4, 224, 224, 64)
              + synthetic_images(2, 480, 640, 65)
              + synthetic_images(2, 500, 375, 66))
    squashed = np.stack([resize_linear(im, 224, 224) for im in images])
    cuda = cls_task(dev, CLS, state, scalar_type=ScalarType.float32)
    cpu = cls_task("cpu", CLS, {k: v.cpu() for k, v in state.items()},
                   scalar_type=ScalarType.float32)
    reset_launch_counts()
    got = cuda.task._probs(cuda.task._predict_variables(),
                           torch.from_numpy(squashed).to(dev)).cpu().numpy()
    got_res = cuda.batch_predict(images)
    used = launch_counts()
    want = cpu.task._probs(cpu.task._predict_variables(),
                           torch.from_numpy(squashed)).numpy()
    want_res = cpu.batch_predict(images)
    dp = float(np.abs(got - want).max())
    swapped = 0
    for g, w in zip(got_res, want_res):
        ws = [r.score for r in w]
        for i, (a, b) in enumerate(zip(g, w)):
            gap = min([abs(ws[i] - ws[j]) for j in (i - 1, i + 1)
                       if 0 <= j < 5])
            if a.class_id != b.class_id and gap > CLS_PROB_TOL:
                swapped += 1
    print(f"  max |p card - p cpu| {dp:.3e} (at most {CLS_PROB_TOL}), top-5 "
          f"entries that differ where the gap to a neighbour exceeds "
          f"{CLS_PROB_TOL}: {swapped} (none allowed); top-1 "
          f"{[r[0].class_id for r in got_res]}; kernel launches on the "
          f"card {used}", flush=True)
    if dp > CLS_PROB_TOL or swapped or got.shape != (8, 1000):
        raise SystemExit(f"[{CLS}] card and CPU probabilities disagree")
    check_path_launches(CLS, used, f"{CLS} float32")
    return used


def write_cls_dataset(root, seed=14):
    """A folder-per-class PNG set under root/{train,val}/class{c}:
    CLS_CLASSES classes, CLS_TRAIN + CLS_VAL images each of CLS_SIDES px a
    side; each class one pattern (stripes of its own period, direction and
    colour) over a noisy background of a random grey."""
    from yolosharp_tpu_torch.data.image_ops import encode_png

    rng = np.random.default_rng(seed)
    for c in range(CLS_CLASSES):
        colour = np.random.default_rng(200 + c).integers(0, 256, 3)
        period = 6 + 3 * c
        for split, n in (("train", CLS_TRAIN), ("val", CLS_VAL)):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                h, w = (int(v) for v in rng.integers(*CLS_SIDES, 2))
                img = rng.normal(rng.uniform(60, 200), 25, (h, w, 3))
                yy, xx = np.mgrid[0:h, 0:w]
                on = ((xx if c % 2 else yy) // (period // 2)) % 2 == 0
                img[on] = colour
                with open(os.path.join(d, f"{i:03d}.png"), "wb") as f:
                    f.write(encode_png(np.clip(img, 0, 255).astype(np.uint8),
                                       level=1))


def _cls_train_config(root, **kw):
    from yolosharp_tpu_torch import Config, TaskType, YoloSize, YoloType

    kw = {"batch_size": CLS_TRAIN_BATCH, **kw}
    return Config(task_type=TaskType.classify, yolo_type=YoloType.v8,
                  yolo_size=YoloSize.s, number_class=CLS_CLASSES,
                  root_path=root, train_data_path="train",
                  val_data_path="val", image_size=CLS_CANVAS[0], **kw)


def phase_cls_train(dev, root, tag):
    """Phase 12c: YoloTask.train() of v8s-cls, bf16, 224, b32, 2 epochs, the
    default augment stack (RandomResizedCrop, flips, AutoAugment, erasing
    0.4). Returns (train launches, predict launches of the served best.bin,
    best.bin's path)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 12c: YoloTask.train() of {CLS} (nc={CLS_CLASSES}), 224x224, "
          f"batch {CLS_TRAIN_BATCH}, bf16, 2 epochs, AutoAugment", flush=True)
    out = os.path.join(root, "run_v8s_cls")
    task = YoloTask(_cls_train_config(root, output_path=out, epochs=2),
                    device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    task.train()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = task.task.epoch_stats
    for st in stats:
        print("  " + epoch_line(st, f"{tag}: {CLS}", CLS_TRAIN_BATCH),
              flush=True)
    print(f"  train() {wall:.1f} s; kernel launches during train(): "
          f"{counts}", flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    head = [h.strip() for h in rows[0]]
    for r in rows[1:]:
        print(f"  log.csv epoch {r[0]}: " + ", ".join(
            f"{h} {v.strip()}" for h, v in zip(head[2:], r[2:])), flush=True)
    losses = [float(v) for r in rows[1:] for h, v in zip(head, r)
              if "loss" in h]
    files = ["config.txt", "log.csv", "weights/best.bin", "weights/last.bin",
             "weights/last_state.npz"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    steps = CLS_CLASSES * CLS_TRAIN // CLS_TRAIN_BATCH
    if ([s["epoch"] for s in stats] != [1, 2] or missing
            or any(len(s["step_s"]) != steps for s in stats)
            or not np.isfinite(losses).all()
            or head[4:6] != ["metrics/top1", "metrics/top5"]
            or any(counts.values())):
        raise SystemExit(f"{CLS} train(): wrong epochs or steps, missing "
                         f"{missing}, losses {losses}, columns {head}, or a "
                         f"kernel launch in training")
    best = os.path.join(out, "weights", "best.bin")
    fresh = YoloTask(_cls_train_config(root), device=dev)
    fresh.load_model(best)
    images = synthetic_images(8, 224, 224, 67)
    reset_launch_counts()
    res = fresh.batch_predict(images)
    served = launch_counts()
    check_top5(res, f"{CLS} best.bin", CLS_CLASSES)
    print(f"  best.bin in a fresh {CLS} YoloTask: batch_predict of 8 gave "
          f"top-1 {[r[0].class_id for r in res]}, kernel launches {served}",
          flush=True)
    check_path_launches(CLS, served, f"{CLS} best.bin")
    return counts, served, best


def phase_cls_val(dev, root, best):
    """Phase 12d: Classifier.val of the trained v8s-cls in float32 on the
    card and on the CPU (plain versions): top1 and top5 equal."""
    from yolosharp_tpu_torch import ScalarType, YoloTask

    print(f"phase 12d: {CLS} val of best.bin, float32, card against CPU, "
          f"{CLS_CLASSES * CLS_VAL} val images", flush=True)
    out = []
    for d in (dev, "cpu"):
        task = YoloTask(_cls_train_config(
            root, scalar_type=ScalarType.float32, batch_size=16), device=d)
        task.load_model(best)
        t0 = time.perf_counter()
        items, metrics = task.val()
        out.append((items, metrics))
        print(f"  [{d}] val loss {float(items[0]):.6f}, top1 "
              f"{metrics[0]:.4f}, top5 {metrics[1]:.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    (gi, gm), (ci, cm) = out
    if gm != cm or abs(float(gi[0]) - float(ci[0])) > 1e-4 * abs(float(ci[0])):
        raise SystemExit(f"[{CLS}] val on the card and on the CPU disagree")


# --------------------------------------------------------------- stream
# phase 13: each family's served model and End2End mode (v12x-obb End2End,
# the others with NMS), the images' sizes (at most the canvas: no row is
# scaled up), the float32 stream's images
STREAM_PATHS = (("v8", False), (SEG, False), (POSE, False), (OBB, True),
                (CLS, False))
STREAM_SIZES = ((480, 640), (640, 480), (640, 640), (360, 500), (500, 360),
                (300, 300), (427, 640), (640, 427))
STREAM_N = 64


def stream_images(n, seed):
    """n synthetic images of the STREAM_SIZES in turn."""
    return [synthetic_images(1, *STREAM_SIZES[i % len(STREAM_SIZES)],
                             seed + i)[0] for i in range(n)]


def match_stream(got, want, path):
    """One image's stream results, card (got) against CPU (want): counts
    within 2, each wanted row matched by one of the same class with its
    centre and size within 1 px (both truncate to integers) and its score
    within 1e-3 (at most 2 unmatched; OBB none, its angle within 1e-4 rad);
    a pose row's keypoints within 0.5 px, visibility 1e-3; a segment row's
    float32 mask > 0.5 equal on 99.9% of its pixels. Returns (n_want,
    n_got, unmatched, equal mask pixels, mask pixels)."""
    task = ARCH[path][2]
    used = [False] * len(got)
    unmatched = same = total = 0
    for w in want:
        best = None
        for j, g in enumerate(got):
            if used[j] or g.class_id != w.class_id or abs(
                    g.score - w.score) >= 1e-3 or max(
                    abs(g.center_x - w.center_x), abs(g.center_y - w.center_y),
                    abs(g.width - w.width), abs(g.height - w.height)) > 1:
                continue
            if task == "obb" and abs(g.radian - w.radian) >= 1e-4:
                continue
            if best is None or abs(g.score - w.score) < abs(
                    got[best].score - w.score):
                best = j
        if best is None:
            unmatched += 1
            continue
        used[best] = True
        g = got[best]
        if task == "pose":
            d = np.abs(np.array([[p.x, p.y, p.visibility]
                                 for p in g.keypoints])
                       - [[p.x, p.y, p.visibility] for p in w.keypoints])
            if d[:, :2].max() > 0.5 or d[:, 2].max() > 1e-3:
                unmatched += 1
        if task == "segment":
            same += int(((g.mask > 0.5) == (w.mask > 0.5)).sum())
            total += w.mask.size
    return len(want), len(got), unmatched, same, total


def phase_stream(dev, states, confs):
    """Phase 13: YoloTask.predict_stream of each family's served model: 8
    images of mixed sizes in float32 at batch STREAM_F32_BATCH (a partial
    last batch) on the card and on the CPU, their rows matched
    (match_stream; classify: phase 12b's rule on the top 5); then
    STREAM_N images in bf16 at batch STREAM_BATCH on the card, img/s beside
    batch_predict's of the same letterboxed canvases (classify: the same
    images squashed) in calls of STREAM_BATCH. Returns the launches of the
    card's streams."""
    from yolosharp_tpu_torch import ScalarType
    from yolosharp_tpu_torch.data.augment import _resize_pad
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print(f"phase 13: predict_stream of each family: 8 images float32 card "
          f"against CPU at batch {STREAM_F32_BATCH}, then {STREAM_N} images "
          f"bf16 at batch {STREAM_BATCH}", flush=True)
    launches = dict.fromkeys(ALL_KERNELS, 0)
    small = stream_images(8, 70)
    many = stream_images(STREAM_N, 80)
    for path, e2e in STREAM_PATHS:
        name = path_name(path)
        mode = f"{name} {'end2end' if e2e else 'nms'}"
        cls = ARCH[path][2] == "classify"
        conf = None if cls else confs[path]
        f32 = dict(scalar_type=ScalarType.float32)
        cpu_state = {k: v.cpu() for k, v in states[path].items()}
        if cls:
            card, cpu = (cls_task(dev, path, states[path], **f32),
                         cls_task("cpu", path, cpu_state, **f32))
        else:
            card = build_tasks(dev, path, states[path], **f32)[e2e]
            cpu = build_tasks("cpu", path, cpu_state, **f32)[e2e]
        kw = dict(batch_size=STREAM_F32_BATCH, predict_threshold=conf,
                  iou_threshold=0.7)
        reset_launch_counts()
        got = list(card.predict_stream(iter(small), **kw))
        used = launch_counts()
        want = list(cpu.predict_stream(iter(small), **kw))
        if not len(got) == len(want) == len(small):
            raise SystemExit(f"[{mode}] stream gave {len(got)} / {len(want)} "
                             f"lists for {len(small)} images")
        check_path_launches(path, used, mode + " float32 stream")
        for name_k in ALL_KERNELS:
            launches[name_k] += used[name_k]
        if cls:
            dp = max(abs(a.score - b.score) for g, w in zip(got, want)
                     for a, b in zip(g, w))
            top1 = sum(g[0].class_id == w[0].class_id
                       for g, w in zip(got, want))
            print(f"  [{mode}] float32 stream: max |d score| {dp:.3e} (at "
                  f"most {CLS_PROB_TOL}), top-1 equal on {top1} of 8; kernel "
                  f"launches {used}", flush=True)
            if dp > CLS_PROB_TOL or top1 != 8:
                raise SystemExit(f"[{mode}] card and CPU streams disagree")
        else:
            res = [match_stream(g, w, path) for g, w in zip(got, want)]
            n_want, n_got, unmatched, same, total = (sum(r[k] for r in res)
                                                     for k in range(5))
            bad = [i for i, r in enumerate(res) if abs(r[0] - r[1]) > 2
                   or r[2] > (0 if ARCH[path][2] == "obb" else 2)]
            print(f"  [{mode}] float32 stream: cpu {n_want} rows, card "
                  f"{n_got}, unmatched {unmatched}, images outside the rule "
                  f"{bad}" + (f", mask pixels equal {same} of {total}"
                              if total else "")
                  + f"; kernel launches {used}", flush=True)
            if n_want < 8 or bad or (ARCH[path][2] == "segment"
                                     and same < 0.999 * total):
                raise SystemExit(f"[{mode}] card and CPU streams disagree")
        # bfloat16: the stream against batch_predict of the same canvases
        if cls:
            task = cls_task(dev, path, states[path])
            inputs = many
        else:
            task = build_tasks(dev, path, states[path])[e2e]
            inputs = [_resize_pad(im, 640, 640, 640, 640, 114)[2]
                      for im in many]
        list(task.predict_stream(iter(many[:STREAM_BATCH]),
                                 batch_size=STREAM_BATCH,
                                 predict_threshold=conf))      # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = list(task.predict_stream(iter(many), batch_size=STREAM_BATCH,
                                       predict_threshold=conf))
        t_stream = time.perf_counter() - t0
        used = launch_counts()
        t0 = time.perf_counter()
        ref = [r for i in range(0, STREAM_N, STREAM_BATCH)
               for r in task.batch_predict(inputs[i:i + STREAM_BATCH], conf)]
        t_batch = time.perf_counter() - t0
        rows = sum(len(r) for r in out)
        print(f"  [{mode}] bf16 stream of {STREAM_N} at b{STREAM_BATCH}: "
              f"{t_stream:.3f} s, {STREAM_N / t_stream:.1f} img/s ({rows} "
              f"rows); batch_predict of the same "
              f"{'images' if cls else 'letterboxed canvases'} in calls of "
              f"{STREAM_BATCH}: {t_batch:.3f} s, {STREAM_N / t_batch:.1f} "
              f"img/s ({sum(len(r) for r in ref)} rows); kernel launches of "
              f"the stream {used}", flush=True)
        if not cls:
            # without the stream: each chunk letterboxed in the caller's
            # thread, then batch_predict
            t0 = time.perf_counter()
            for i in range(0, STREAM_N, STREAM_BATCH):
                task.batch_predict(
                    [_resize_pad(im, 640, 640, 640, 640, 114)[2]
                     for im in many[i:i + STREAM_BATCH]], conf)
            t_serial = time.perf_counter() - t0
            print(f"  [{mode}] letterbox then batch_predict in the caller's "
                  f"thread, calls of {STREAM_BATCH}: {t_serial:.3f} s, "
                  f"{STREAM_N / t_serial:.1f} img/s", flush=True)
        if len(out) != STREAM_N or (not cls and rows == 0):
            raise SystemExit(f"[{mode}] bf16 stream results are wrong")
        if cls:
            check_top5(out, mode + " stream", PATH_NC[path])
        check_path_launches(path, used, mode + " bf16 stream")
        for name_k in ALL_KERNELS:
            launches[name_k] += used[name_k]
    return launches


# ------------------------------------------------------------------ images
FIXTURE_DIRS = [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data_torch", d)
                for d in ("jpeg", "images")]
JPEG_DIR = FIXTURE_DIRS[0]
JPEG_BIG = "s420_q75_641x479.jpg"
# the files 14a times over 50 reads: the baseline and progressive 641x479
# fixtures, the LZW TIFF, the ASCII P3 and the GIF it writes, the 640x480
# WebPs and the 640x480 lossy JPEG 2000
TIMED_50 = (JPEG_BIG, "progressive_q75_641x479.jpg", "lzw_pred2_640x480.tif",
            "webp_lossy_q80_640x480.webp",
            "webp_lossless_48colours_640x480.webp", "ascii_640x480.ppm",
            "gif_332_640x480.gif", "jp2_lossy_r16_640x480.jp2")
WEBP_AS_JPG = "webp_bytes_64x48.jpg"   # 14b's WebP image_predict path
# kinds read through libjpeg's and libtiff's recovery and rarer codecs that
# lead 14b's and 14c's cycle: every served batch, train list and classify
# set holds them
FIRST_KINDS = ("jp2_lossy_named_64x48.jpg", "gif_global_64x48.gif",
               "ras_cv2_rgb_63x48.ras", "hdr_rle_64x48.hdr",
               "pfm_le_64x48.pfm", "dhtless_baseline_420_64x48.jpg",
               "cut_baseline_q75_64x48.jpg", "ccitt_g3_2d_64x48.tif",
               "jpeg_ycbcr420_64x48.tif", "cmyk_lzw_64x48.tif")
# the extensions the loaders admit (the JAX package's IMG_EXTS)
LOADER_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
JPEG_LIST = 128           # entries of 14b's train list (the fixtures cycled)
JPEG_CLS_TRAIN = 16       # 14c's train images a class


def image_fixtures():
    """The committed fixtures of both folders: path -> manifest entry."""
    out = {}
    for d in FIXTURE_DIRS:
        with open(os.path.join(d, "manifest.json")) as f:
            for name, entry in json.load(f).items():
                out[os.path.join(d, name)] = entry
    return out


def write_lzw_tiff(root):
    """A 640x480 RGB TIFF, LZW with the horizontal predictor in strips of 16
    rows, written by tests/data_torch/images/writers.py from one of
    synthetic_images; returns (path, the pixels)."""
    sys.path.insert(0, FIXTURE_DIRS[1])
    from writers import write_tiff

    img = synthetic_images(1, 480, 640, 14)[0]
    path = os.path.join(root, TIMED_50[2])
    with open(path, "wb") as f:
        f.write(write_tiff(img, compression=5, predictor=2,
                           rows_per_strip=16))
    return path, img


def write_ascii_ppm(root):
    """A 640x480 ASCII P3 (maxval 255, one row a line) of one of
    synthetic_images, written by tests/data_torch/images/writers.py;
    returns (path, the pixels)."""
    sys.path.insert(0, FIXTURE_DIRS[1])
    from writers import write_pnm

    img = synthetic_images(1, 480, 640, 16)[0]
    path = os.path.join(root, TIMED_50[5])
    with open(path, "wb") as f:
        f.write(write_pnm(img, 3))
    return path, img


def write_gif_332(root):
    """A 640x480 GIF of one of synthetic_images in a 3-3-2 palette (256
    colours), written by tests/data_torch/images/writers.py; returns
    (path, the pixels)."""
    sys.path.insert(0, FIXTURE_DIRS[1])
    from writers import write_gif

    img = synthetic_images(1, 480, 640, 18)[0]
    idx = ((img[..., 0] >> 5) << 5 | (img[..., 1] >> 5) << 2
           | img[..., 2] >> 6).astype(np.uint8)
    v = np.arange(256)
    palette = np.stack([(v >> 5) * 255 // 7, (v >> 2 & 7) * 255 // 7,
                        (v & 3) * 85], -1).astype(np.uint8)
    path = os.path.join(root, TIMED_50[6])
    with open(path, "wb") as f:
        f.write(write_gif([dict(indices=idx)], 640, 480, palette))
    return path, palette[idx]


def phase_image_decode(root, tag):
    """Phase 14a: every fixture read by read_image_rgb, its RGB bytes'
    SHA-256 against the manifest; the written LZW TIFF and ASCII P3
    against their pixels; the host decode ms. Returns the paths of the fixtures of 32 px
    a side or more, in the order of the cycle."""
    import hashlib

    from yolosharp_tpu_torch.data.image_ops import read_image_rgb

    print(f"phase 14a: the image fixtures of {', '.join(FIXTURE_DIRS)} "
          f"through read_image_rgb (host decode, {tag})", flush=True)
    usable = []

    def timed_read(path):
        reps = 50 if os.path.basename(path) in TIMED_50 else 5
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            img = read_image_rgb(path)
            times.append(time.perf_counter() - t)
        return img, (f"host decode {np.median(times) * 1e3:.3f} ms (median "
                     f"of {reps}; {tag})")

    for path, entry in sorted(image_fixtures().items()):
        img, ms = timed_read(path)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        name = os.path.basename(path)
        if list(img.shape) != entry["shape"] or digest != entry["sha256"]:
            raise SystemExit(f"{name}: decoded {img.shape} {digest}, the "
                             f"manifest (cv2) has {entry['shape']} "
                             f"{entry['sha256']}")
        print(f"  {name}: {entry['bytes']} bytes, {img.shape[1]}x"
              f"{img.shape[0]}, SHA-256 equal to cv2's; {ms}", flush=True)
        if min(img.shape[:2]) >= 32:
            usable.append(path)
    for write in (write_lzw_tiff, write_ascii_ppm, write_gif_332):
        path, want = write(root)
        img, ms = timed_read(path)
        if not np.array_equal(img, want):
            raise SystemExit(f"{path}: decoded pixels differ from those "
                             f"written ({int((img != want).sum())} values)")
        print(f"  {os.path.basename(path)}: {os.path.getsize(path)} bytes, "
              f"640x480, equal to the pixels written; {ms}", flush=True)
    # the cycle: FIRST_KINDS, then one file of each extension (the JPEG
    # folder's apart) in turn, so that every kind is in the first 32
    first = [os.path.join(FIXTURE_DIRS[1], n) for n in FIRST_KINDS]
    if not set(first) <= set(usable):
        raise SystemExit(f"14a: {FIRST_KINDS} are not all usable fixtures")
    groups = {}
    for p in usable:
        if p in first:
            continue
        key = ("jpeg dir" if p.startswith(JPEG_DIR)
               else os.path.splitext(p)[1].lower())
        groups.setdefault(key, []).append(p)
    lists = [groups[k] for k in sorted(groups)]
    cycle = list(first)
    for i in range(max(len(v) for v in lists)):
        cycle += [v[i] for v in lists if i < len(v)]
    return cycle


def dataset_name(path):
    """A fixture's name in a dataset: its own, or for an extension the
    loaders do not admit (PNM, PAM, WebP, JPEG 2000, GIF, Sun raster, PFM,
    HDR) the name with ``.png`` after its
    extension's letters (``p6_64x48_ppm.png``): cv2 and the port read it
    by its content."""
    stem, ext = os.path.splitext(os.path.basename(path))
    return stem + ext if ext.lower() in LOADER_EXTS else f"{stem}_{ext[1:]}.png"


def write_image_detect_set(root, paths, seed=15):
    """root/images/{train,val}/<fixture> copies of the fixtures with 1-3
    random boxes each in root/labels, and root/train.txt listing them
    JPEG_LIST times over (cycled), root/val.txt 16 times."""
    import shutil

    rng = np.random.default_rng(seed)
    names = [dataset_name(p) for p in paths]
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, "images", split))
        os.makedirs(os.path.join(root, "labels", split))
        for path, name in zip(paths, names):
            shutil.copy(path, os.path.join(root, "images", split, name))
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                bw, bh = rng.uniform(0.1, 0.6, 2)
                cx = rng.uniform(bw / 2, 1 - bw / 2)
                cy = rng.uniform(bh / 2, 1 - bh / 2)
                rows.append(f"{rng.integers(80)} {cx:.6f} {cy:.6f} "
                            f"{bw:.6f} {bh:.6f}")
            with open(os.path.join(root, "labels", split,
                                   os.path.splitext(name)[0] + ".txt"),
                      "w") as f:
                f.write("\n".join(rows) + "\n")
        n = JPEG_LIST if split == "train" else 16
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(f"./images/{split}/{names[i % len(names)]}"
                              for i in range(n)) + "\n")


def write_image_cls_set(root, paths):
    """root/image_cls/{train,val}/class{c}/<i><ext>: copies of the fixtures
    (cycled, each keeping its extension), JPEG_CLS_TRAIN train and 2 val a
    class. Returns the paths the train copies came from."""
    import shutil

    k, train = 0, []
    for c in range(CLS_CLASSES):
        for split, n in (("train", JPEG_CLS_TRAIN), ("val", 2)):
            d = os.path.join(root, "image_cls", split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                path = paths[k % len(paths)]
                shutil.copy(path, os.path.join(
                    d, f"{i}{os.path.splitext(dataset_name(path))[1]}"))
                if split == "train":
                    train.append(path)
                k += 1
    return train


def _kinds(paths):
    """'n .ext' counts of a list of paths."""
    exts = [os.path.splitext(p)[1] for p in paths]
    return ", ".join(f"{exts.count(e)} {e}" for e in sorted(set(exts)))


def phase_images(dev, root, state, conf, tag):
    """Phase 14: image input on the card (the module docstring's 14a-14c).
    Returns (launches of 14b's requests, launches of its training)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.data.image_ops import read_image_rgb
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    paths = phase_image_decode(root, tag)
    print("phase 14b: v8s-640 bf16 serves JPEG, PNG, TIFF, BMP, PNM, PAM, "
          "WebP, JPEG 2000, GIF, Sun raster, HDR and PFM files", flush=True)
    task = build_tasks(dev, "v8", state)[False]
    big = os.path.join(JPEG_DIR, JPEG_BIG)
    webp_jpg = os.path.join(FIXTURE_DIRS[1], WEBP_AS_JPG)
    reset_launch_counts()
    by_path = task.image_predict(big, conf)
    by_webp_path = task.image_predict(webp_jpg, conf)
    batch = [paths[i % len(paths)] for i in range(SERVED_BATCH)]
    images = [read_image_rgb(p) for p in batch]
    t = time.perf_counter()
    results = task.batch_predict(images, conf)
    call = time.perf_counter() - t
    served = launch_counts()
    by_array = task.image_predict(read_image_rgb(big), conf)
    by_webp_array = task.image_predict(read_image_rgb(webp_jpg), conf)

    def rows_of(res):
        return [(r.class_id, r.score, r.center_x, r.center_y, r.width,
                 r.height) for r in res]

    if rows_of(by_path) != rows_of(by_array) or \
            rows_of(by_webp_path) != rows_of(by_webp_array):
        raise SystemExit("image_predict of a file's path and of its decoded "
                         "array disagree (the JPEG or the WebP named .jpg)")
    boxes = np.array([[r.center_x, r.center_y, r.width, r.height]
                      for rs in results for r in rs], np.float64)
    if len(results) != SERVED_BATCH or not boxes.size \
            or not np.isfinite(boxes).all():
        raise SystemExit(f"image batch_predict: {len(results)} lists, "
                         f"{len(boxes)} rows")
    print(f"  image_predict({JPEG_BIG}): {len(by_path)} rows, "
          f"image_predict({WEBP_AS_JPG}): {len(by_webp_path)} rows, each "
          f"equal to its decoded array's; batch_predict of {SERVED_BATCH} decoded "
          f"fixtures ({_kinds(batch)}): {len(boxes)} rows, "
          f"{call * 1e3:.1f} ms; kernel launches {served}", flush=True)
    check_path_launches("v8", served, "v8s image predict")
    print(f"  the batch, the train list and 14c's class 0 lead with "
          f"{', '.join(FIRST_KINDS)}", flush=True)

    write_image_detect_set(root, paths)
    print(f"phase 14b: YoloTask.train() of v8s, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"batch {TRAIN_BATCH}, bf16, 2 epochs on {JPEG_LIST} listed files "
          f"({len(paths)} fixtures cycled: {_kinds(paths)}), val on 16",
          flush=True)
    from yolosharp_tpu_torch import Config, YoloSize, YoloType

    out = os.path.join(root, "run_images")
    cfg = Config(root_path=root, train_data_path="train.txt",
                 val_data_path="val.txt", yolo_type=YoloType.v8,
                 yolo_size=YoloSize.s, number_class=80,
                 image_size=TRAIN_SIZE, batch_size=TRAIN_BATCH, epochs=2,
                 output_path=out)
    t = time.perf_counter()
    trainer = YoloTask(cfg, device=dev)
    reset_launch_counts()
    trainer.train()
    train_counts = launch_counts()
    for st in trainer.task.epoch_stats:
        print("  " + epoch_line(st, f"{tag}: v8s images"), flush=True)
    items, metrics = trainer.val()
    with open(os.path.join(out, "log.csv")) as f:
        logged = list(csv.reader(f))
    head = [h.strip() for h in logged[0]]
    losses = [float(v) for r in logged[1:] for h, v in zip(head, r)
              if "loss" in h] + [float(v) for v in items]
    print(f"  train() and val {time.perf_counter() - t:.1f} s; val loss "
          f"items {[round(float(v), 4) for v in items]}, metrics "
          f"{[round(float(m), 4) for m in metrics]}; kernel launches in "
          f"training {train_counts}", flush=True)
    steps = JPEG_LIST // TRAIN_BATCH
    if [len(st["step_s"]) for st in trainer.task.epoch_stats] != [steps] * 2 \
            or not np.isfinite(losses).all():
        raise SystemExit(f"image train(): steps "
                         f"{[len(st['step_s']) for st in trainer.task.epoch_stats]}"
                         f", losses {losses}")

    train = write_image_cls_set(root, paths)
    n_train = len(train)
    print(f"phase 14c: YoloTask.train() of {CLS} (nc={CLS_CLASSES}), "
          f"{CLS_CANVAS[0]}x{CLS_CANVAS[1]}, batch {CLS_TRAIN_BATCH}, bf16, 1 "
          f"epoch on a folder set of {n_train} train images "
          f"({_kinds(train)}; each decoded at every get)", flush=True)
    t = time.perf_counter()
    cls = YoloTask(_cls_train_config(
        os.path.join(root, "image_cls"), epochs=1,
        output_path=os.path.join(root, "run_image_cls")), device=dev)
    cls.train()
    st = cls.task.epoch_stats[0]
    print("  " + epoch_line(st, f"{tag}: {CLS} images", CLS_TRAIN_BATCH),
          flush=True)
    print(f"  train() {time.perf_counter() - t:.1f} s", flush=True)
    if len(st["step_s"]) != n_train // CLS_TRAIN_BATCH:
        raise SystemExit(f"{CLS} image train(): {len(st['step_s'])} steps")
    return served, train_counts


# Phase 15: the library blocks no zoo model builds, each alone at the input
# shape a published configuration gives it (Ultralytics rtdetr-l.yaml,
# yolov10s.yaml at width 0.5, yolov8-ghost.yaml at scale s, YOLOv5 v5.0's
# yolov5s.yaml, yolov3-spp.yaml, YOLOv5's yolov5s-transformer.yaml), the
# rest at v8s's P3 stage (128 wide at 80x80), since no published config
# builds them: (name, class in yolosharp_tpu_torch.nn, its arguments, input
# (C, H, W), where the shape comes from, conv kernel launches a forward)
BLOCKS15 = (
    ("HGStem(32, 48)", "HGStem", (3, 32, 48), (3, 640, 640),
     "rtdetr-l.yaml layer 0", {"conv3x3s2_silu": 2}),
    ("HGBlock(48, 128, k=3, n=6)", "HGBlock", (48, 48, 128, 3, 6),
     (48, 160, 160), "rtdetr-l.yaml layer 1", {"conv3x3_silu": 6}),
    ("HGBlock(96, 512, k=3, n=6)", "HGBlock", (128, 96, 512, 3, 6),
     (128, 80, 80), "rtdetr-l.yaml layer 3", {"conv3x3_silu": 6}),
    ("HGBlock(192, 1024, k=5, n=6, lightconv)", "HGBlock",
     (512, 192, 1024, 5, 6, True), (512, 40, 40), "rtdetr-l.yaml layer 5",
     {}),
    ("RepC3(256, n=3) 80x80", "RepC3", (512, 256, 3), (512, 80, 80),
     "rtdetr-l.yaml layer 21", {"conv3x3_silu": 3}),
    ("RepC3(256, n=3) 40x40", "RepC3", (512, 256, 3), (512, 40, 40),
     "rtdetr-l.yaml layer 16", {"conv3x3_silu": 3}),
    ("SCDown(256, 3, 2)", "SCDown", (256, 256, 3, 2), (256, 80, 80),
     "yolov10s.yaml [512, 3, 2] at width 0.5", {}),
    ("C2fCIB(512, True, True)", "C2fCIB", (512, 512, 1, True, True),
     (512, 20, 20), "yolov10s.yaml [1024, True, True] at width 0.5", {}),
    ("GhostConv(64, 3, 2)", "GhostConv", (32, 64, 3, 2), (32, 320, 320),
     "yolov8-ghost.yaml scale s", {"conv3x3s2_silu": 1}),
    ("C3Ghost(64)", "C3Ghost", (64, 64, 1), (64, 160, 160),
     "yolov8-ghost.yaml scale s", {}),
    ("Focus(32, 3)", "Focus", (3, 32, 3), (3, 640, 640),
     "YOLOv5 v5.0 yolov5s.yaml", {"conv3x3_silu": 1}),
    ("SPP(512, (5, 9, 13))", "SPP", (1024, 512, (5, 9, 13)), (1024, 20, 20),
     "yolov3-spp.yaml", {}),
    ("C3TR(512)", "C3TR", (512, 512, 1), (512, 20, 20),
     "yolov5s-transformer.yaml", {}),
    ("Conv2(128)", "Conv2", (128, 128), (128, 80, 80), "v8s P3",
     {"conv3x3_silu": 1}),
    ("LightConv(128, k=5)", "LightConv", (128, 128, 5), (128, 80, 80),
     "v8s P3", {}),
    ("ConvTranspose(128)", "ConvTranspose", (128, 128), (128, 80, 80),
     "v8s P3", {}),
    ("DWConvTranspose2d(128, k=4, s=2, p=1)", "DWConvTranspose2d",
     (128, 128, 4, 2, 1), (128, 80, 80), "v8s P3", {}),
    ("CBAM(128)", "CBAM", (128,), (128, 80, 80), "v8s P3", {}),
    ("C1(128)", "C1", (128, 128), (128, 80, 80), "v8s P3",
     {"conv3x3_silu": 1}),
    ("C2(128)", "C2", (128, 128, 1), (128, 80, 80), "v8s P3",
     {"conv3x3_silu": 2}),
    ("C3x(128)", "C3x", (128, 128, 1), (128, 80, 80), "v8s P3",
     {"conv3x3_silu": 1}),
    ("RepVGGDW(128)", "RepVGGDW", (128,), (128, 80, 80), "v8s P3", {}),
    ("AGLU", "AGLU", (), (128, 80, 80), "v8s P3", {}),
    ("Index(1)", "Index", (1,), (128, 80, 80), "v8s P3", {}),
)
BLOCK_NAMES = tuple(spec[0] for spec in BLOCKS15)
BLOCK_TRAIN_BATCH = 2
# float32 predict, card against CPU: the block's output within 1e-4 of its
# largest value (each conv sums in another order; chains of up to 8
# layers). Train: the card's and the CPU's float32 output and gradients
# each against float64 on the card, per tensor as ||d|| / ||ref||: the card
# within 1e-4 (output) or 1e-3 (gradients), or within 4 times the CPU's
# own distance where that is larger (a train-mode BatchNorm's backward
# cancels: deep in HGBlock's chain both devices' float32 gradients sit
# 1e-3 to 1e-2 from float64, each summing in its own order). A gradient
# that float64 puts under 1e-9 of the block's largest is zero by
# construction and must read under 1e-6 of it on both devices.
BLOCK_F32_TOL, BLOCK_GRAD_TOL, BLOCK_CPU_FACTOR = 1e-4, 1e-3, 4.0
BLOCK_ZERO, BLOCK_ZERO_TOL = 1e-9, 1e-6


def make_block(spec, seed: int = 3, scale: float = 2.5):
    """One BLOCKS15 block with phase 3's recipe for a block alone: torch's
    default init drawn from a seeded generator (nn.MultiheadAttention's
    in-projection and AGLU's scalars too), ConvBN kernels x scale, every
    BatchNorm's statistics jittered so that folding does real work."""
    from torch import nn

    from yolosharp_tpu_torch import nn as port_nn
    from yolosharp_tpu_torch.nn import ConvBN
    from yolosharp_tpu_torch.nn.model import init_weights

    _, cls, args, *_ = spec
    block = getattr(port_nn, cls)(*args)
    g = torch.Generator().manual_seed(seed)
    init_weights(block, g)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, nn.MultiheadAttention):
                bound = m.embed_dim ** -0.5
                m.in_proj_weight.uniform_(-bound, bound, generator=g)
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(scale)
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.add_(torch.from_numpy(
                    rng.normal(0, 0.05, c).astype(np.float32)))
                m.running_var.mul_(torch.from_numpy(
                    rng.uniform(0.8, 1.5, c).astype(np.float32))).add_(0.02)
        for p in (getattr(block, "lambd", None), getattr(block, "kappa", None)):
            if p is not None:
                p.uniform_(0, 1, generator=g)
    return block


def block_input(spec, batch: int, seed: int = 0) -> torch.Tensor:
    """A float32 CPU input of the block's shape: U(0, 1) for the RGB blocks,
    N(0, 1) otherwise, channels-last."""
    c, h, w = spec[3]
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(batch, c, h, w, generator=g) if c == 3
         else torch.randn(batch, c, h, w, generator=g))
    return x.contiguous(memory_format=torch.channels_last)


def run_block(block, x):
    """The block's forward; Index takes a list."""
    from yolosharp_tpu_torch.nn import Index

    return block([x, x * 2]) if isinstance(block, Index) else block(x)


def kernel_convs(block) -> list:
    """(wrapper name, activation, Ci) of each ConvBN of a folded block on
    the conv kernel's route, in module order."""
    from yolosharp_tpu_torch.nn import ConvBN

    return [("conv3x3_silu" if m.s == 1 else "conv3x3s2_silu", m.act,
             m.conv.in_channels) for m in block.modules()
            if isinstance(m, ConvBN) and m.kernel_route]


@torch.no_grad()
def record_block_shapes() -> list:
    """[((kind, (H, W, Ci, Co), act), [blocks])] of the 3x3 convs on the
    kernel route in the folded BLOCKS15 blocks at their input shapes, from
    forward hooks run at B=1 on the CPU (the routing is the card's)."""
    from yolosharp_tpu_torch.ckpt import fold_bn
    from yolosharp_tpu_torch.nn import C2f, ConvBN

    tagged = {}
    for spec in BLOCKS15:
        block = fold_bn(make_block(spec).eval())
        if any(isinstance(m, C2f) for m in block.modules()):
            raise SystemExit(f"{spec[0]} holds a C2f")

        def hook(m, inp, out, name=spec[0]):
            _, ci, h, w = inp[0].shape
            key = (f"s{m.s}", (h, w, ci, m.conv.out_channels), m.act)
            tagged.setdefault(key, []).append(name)

        handles = [m.register_forward_hook(hook) for m in block.modules()
                   if isinstance(m, ConvBN) and m.kernel_route]
        run_block(block, block_input(spec, 1))
        for h in handles:
            h.remove()
    return sorted(((k, sorted(set(v))) for k, v in tagged.items()),
                  key=lambda t: (t[0][0], -t[0][1][0], t[0][1], t[0][2]))


def _max_rel(got, want) -> float:
    return float((got.float().cpu() - want.float()).abs().max()) / (
        float(want.float().abs().max()) + 1e-30)


def phase_blocks(dev, tag) -> dict:
    """Phase 15 (a)-(c): each BLOCKS15 block at its published input shape.
    Returns the conv kernel launches of its bf16 predict forwards."""
    import copy

    from yolosharp_tpu_torch.ckpt import fold_bn
    from yolosharp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)

    print(f"phase 15a-c: {len(BLOCKS15)} library blocks no zoo model builds, "
          f"each alone at a published input shape, seeded as phase 3: (a) "
          f"bf16 folded predict b{BLOCK_BATCH} on the card, its kernel "
          f"launches against the block's list; (b) float32 folded predict "
          f"b{BLOCK_TRAIN_BATCH}, card against CPU; (c) one float32 "
          f"train-mode forward + backward b{BLOCK_TRAIN_BATCH}, card "
          f"against CPU: output, input and parameter gradients ({tag})",
          flush=True)
    total = dict.fromkeys(ALL_KERNELS, 0)
    for spec in BLOCKS15:
        name, _, _, chw, source, want = spec
        master = make_block(spec)
        folded = fold_bn(copy.deepcopy(master).eval())
        convs = kernel_convs(folded)
        counted = {n: sum(1 for c in convs if c[0] == n)
                   for n in ALL_KERNELS}
        want = {n: want.get(n, 0) for n in ALL_KERNELS}
        if counted != want:
            raise SystemExit(f"{name}: its modules put {counted} on the "
                             f"kernel route, expected {want}")
        # (a) bf16 folded predict on the card
        pred = copy.deepcopy(folded).to(dev, torch.bfloat16)
        x = block_input(spec, BLOCK_BATCH).to(dev, torch.bfloat16)
        with torch.no_grad():
            run_block(pred, x)
            torch.cuda.synchronize()
            reset_launch_counts()
            out = run_block(pred, x)
            torch.cuda.synchronize()
            got = launch_counts()
            if got != want:
                raise SystemExit(f"{name}: one forward launched {got}, "
                                 f"expected {want}")
            if not bool(torch.isfinite(out.float()).all()):
                raise SystemExit(f"{name}: bf16 output not finite")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run_block(pred, x)
            end.record()
            torch.cuda.synchronize()
            for n, c in launch_counts().items():
                total[n] += c
        ms = start.elapsed_time(end) / 10
        # (b) float32 folded predict, card against CPU
        x2 = block_input(spec, BLOCK_TRAIN_BATCH, seed=1)
        with torch.no_grad():
            want_f32 = run_block(folded, x2)
            got_f32 = run_block(copy.deepcopy(folded).to(dev), x2.to(dev))
        d_pred = _max_rel(got_f32, want_f32)
        # (c) float32 train-mode forward + backward, card and CPU each
        # against float64 on the card
        r = torch.randn(want_f32.shape, generator=torch.Generator()
                        .manual_seed(2)) / want_f32.numel() ** 0.5
        runs = {}
        for label, device, dtype in (("ref", dev, torch.float64),
                                     ("cpu", "cpu", torch.float32),
                                     ("card", dev, torch.float32)):
            m = copy.deepcopy(master).to(device, dtype).train()
            xt = x2.to(device, dtype, copy=True).requires_grad_(True)
            o = run_block(m, xt)
            (o * r.to(device, dtype)).sum().backward()
            runs[label] = {k: None if g is None else g.detach().cpu().double()
                           for k, g in (("output", o), ("input", xt.grad),
                                        *((k, p.grad) for k, p in
                                          m.named_parameters()))}
        ref = runs["ref"]
        top = max(float(g.abs().max()) for k, g in ref.items()
                  if k != "output" and g is not None)
        zero, worst, worst_key, d_train = [], 0.0, "", 0.0
        for k, g in ref.items():
            if g is None:
                continue
            big = float(g.abs().max())
            if k != "output" and big <= BLOCK_ZERO * top:
                # a gradient that is zero by construction (a shift that a
                # train-mode BatchNorm downstream removes)
                zero.append(k)
                got_max = max(float(runs[n][k].abs().max())
                              for n in ("cpu", "card"))
                if got_max > BLOCK_ZERO_TOL * top:
                    raise SystemExit(f"{name}: {k}'s gradient is zero by "
                                     f"construction but reads {got_max:.2e}"
                                     f" (G = {top:.2e})")
                continue
            d_card, d_cpu = (float((runs[n][k] - g).norm() / g.norm())
                             for n in ("card", "cpu"))
            tol = max(BLOCK_F32_TOL if k == "output" else BLOCK_GRAD_TOL,
                      BLOCK_CPU_FACTOR * d_cpu)
            if k == "output":
                d_train = d_card
            elif d_card / tol > worst:
                worst, worst_key = d_card / tol, f"{k} {d_card:.2e} (CPU " \
                    f"{d_cpu:.2e})"
            if d_card > tol:
                raise SystemExit(f"{name}: {k}: the card's float32 is "
                                 f"{d_card:.2e} from float64, the CPU's "
                                 f"{d_cpu:.2e} (limit {tol:.2e})")
        acts = ", ".join(f"{'s1' if n == 'conv3x3_silu' else 's2'} {a} "
                         f"Ci={ci}" for n, a, ci in convs)
        launched = {k: v for k, v in got.items() if v}
        print(f"  {name} [{source}] b{BLOCK_BATCH}x{chw[0]}x{chw[1]}x{chw[2]} "
              f"-> {tuple(out.shape[1:])}: bf16 forward {ms:.4f} ms (CUDA "
              f"events, mean of 10); launches {launched} "
              f"({acts or 'no kernel conv'}); f32 predict "
              f"card vs CPU max|d|/max|ref| {d_pred:.2e}; train, against "
              f"float64: output {d_train:.2e}, {len(ref) - 1} gradients, "
              f"the nearest its limit {worst_key or 'none'}, zero by "
              f"construction {zero or 'none'}", flush=True)
        if d_pred > BLOCK_F32_TOL:
            raise SystemExit(f"{name}: float32 predict, card and CPU "
                             f"disagree ({d_pred:.2e})")
    print(f"  kernel launches of phase 15a's forwards: {total}", flush=True)
    return total


def phase_convert(dev, state, conf) -> dict:
    """Phase 15d: convert_checkpoint on the card's host: phase 3's seeded
    v8s state dict written by torch.save and as .safetensors, each
    converted to .bin in float32 and float16, loaded into a YoloTask and
    served phase 3's b32 batch; float32 must equal the directly loaded
    weights' results, float16 those of the state rounded to float16.
    Returns the kernel launches."""
    from yolosharp_tpu_torch import YoloTask, convert_checkpoint
    from yolosharp_tpu_torch.ckpt import save_safetensors
    from yolosharp_tpu_torch.kernels import (launch_counts,
                                             reset_launch_counts)

    print("phase 15d: convert_checkpoint of phase 3's v8s weights (.pt by "
          "torch.save, .safetensors) to .bin float32 and float16, each "
          "served a b32 batch against the directly loaded weights",
          flush=True)
    batch = synthetic_images(SERVED_BATCH, 640, 640, 20)
    # the NMS model's weights: phase 3's End2End master without one2one
    cpu_state = {k: v.detach().cpu() for k, v in state.items()
                 if "one2one" not in k}
    counts = dict.fromkeys(ALL_KERNELS, 0)

    def serve(load):
        task = YoloTask(path_config("v8", end2end=False, nms_pre_topk=512),
                        device=dev)
        load(task)
        reset_launch_counts()
        res = task.batch_predict(batch, conf)
        for n, c in launch_counts().items():
            counts[n] += c
        return [[(r.class_id, r.score, r.center_x, r.center_y, r.width,
                  r.height) for r in rs] for rs in res]

    def direct(sd):
        return lambda t: t.task._ensure_variables().load_state_dict(
            {k: v.to(dev) for k, v in sd.items()}, strict=True)

    half = {k: (v.half().float() if v.is_floating_point() else v)
            for k, v in cpu_state.items()}
    want = {None: serve(direct(cpu_state)), np.float16: serve(direct(half))}
    with tempfile.TemporaryDirectory() as d:
        srcs = {"pt": os.path.join(d, "v8s.pt"),
                "safetensors": os.path.join(d, "v8s.safetensors")}
        torch.save(cpu_state, srcs["pt"])
        save_safetensors(srcs["safetensors"], cpu_state)
        for fmt, src in srcs.items():
            for dtype in (None, np.float16):
                dst = os.path.join(d, f"v8s_{fmt}_{dtype}.bin")
                t = time.perf_counter()
                n = convert_checkpoint(src, dst, dtype)
                s = time.perf_counter() - t
                got = serve(lambda task: task.load_model(dst))
                rows = sum(len(r) for r in got)
                same = got == want[dtype]
                print(f"  {fmt} -> .bin {np.dtype(dtype or np.float32)}: "
                      f"{n} tensors, {os.path.getsize(dst)} bytes in "
                      f"{s * 1e3:.1f} ms; served {rows} rows, equal to the "
                      f"directly loaded {'float16-rounded ' if dtype else ''}"
                      f"weights': {same}", flush=True)
                if not same or n != len(cpu_state) or not rows:
                    raise SystemExit(f"convert_checkpoint {fmt} {dtype}: "
                                     f"results differ")
    return counts


def phase_profile(dev, root, tag):
    """Phase 15e: Config.profile_dir on the card: v8n-320 b8, one epoch of
    six steps; the trace must exist, hold CUDA kernel events and span
    steps 2-5."""
    from yolosharp_tpu_torch import YoloSize, YoloTask

    print("phase 15e: profile_dir: v8n-320 b8 train(), one epoch of 6 "
          "steps on 48 PNGs, torch.profiler over steps 2-5", flush=True)
    prof = os.path.join(root, "prof")
    task = YoloTask(_train_config(root, "v8", yolo_size=YoloSize.n,
                                  image_size=320, batch_size=8,
                                  profile_dir=prof,
                                  output_path=os.path.join(root, "run")),
                    device=dev)
    t = time.perf_counter()
    task.train()
    path = task.task.trace_path
    steps = len(task.task.epoch_stats[0]["step_s"])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    # each span is a CPU event and, with CUDA activities, a GPU annotation
    spans = sorted({int(e["name"].split()[-1]) for e in events
                    if str(e.get("name", "")).startswith("train step ")})
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(float(e.get("dur", 0)) for e in kernels) / 1e3
    print(f"  {tag}: train() {time.perf_counter() - t:.1f} s, {steps} steps; "
          f"trace {path} ({os.path.getsize(path)} bytes): step spans "
          f"{spans}, {len(kernels)} CUDA kernel events, {busy:.2f} ms of "
          f"kernel time", flush=True)
    if steps != 6 or spans != [2, 3, 4, 5] or not kernels:
        raise SystemExit("profile_dir: the trace does not hold steps 2-5 "
                         "with CUDA kernels")


def phase_unported(dev, root):
    """Phase 15f: int8_predict without calibration stats predicts in float,
    as the JAX package does (phase 17 runs int8); fsdp,
    resume_format="orbax" and mesh_shape run as in the JAX package (v8n
    train() at 128x128, batch 8, one epoch: FSDP over the visible cards,
    unsharded on one; the torch.distributed.checkpoint directory; the mesh
    shape read nowhere)."""
    from yolosharp_tpu_torch import YoloSize, YoloTask
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts

    print("phase 15f: int8_predict without stats predicts float; fsdp, "
          "resume_format='orbax' and mesh_shape run", flush=True)
    img = synthetic_images(1, 64, 64, 1)[0]
    plain = YoloTask(path_config("v8"), device=dev)
    int8 = YoloTask(path_config("v8", int8_predict=True), device=dev)
    int8.task._ensure_variables().load_state_dict(
        plain.task._ensure_variables().state_dict())
    reset_launch_counts()
    rows = int8.image_predict(img, 0.0)
    used = launch_counts()
    if rows != plain.image_predict(img, 0.0) or used["int8_conv"]:
        raise SystemExit("int8_predict=True without stats is not the float "
                         "predict")
    print(f"  int8_predict=True without stats: {len(rows)} rows, those of "
          f"the float predict; launches {used}", flush=True)
    rows = YoloTask(path_config("v8", mesh_shape=(1, 2)),
                    device=dev).image_predict(img)
    print(f"  mesh_shape=(1, 2) at predict: {len(rows)} rows", flush=True)
    for field, value in (("fsdp", True), ("resume_format", "orbax"),
                         ("mesh_shape", (2,))):
        out = os.path.join(root, f"run_{field}")
        task = YoloTask(_train_config(root, "v8", yolo_size=YoloSize.n,
                                      image_size=128, batch_size=8,
                                      output_path=out, **{field: value}),
                        device=dev)
        task.train()
        files = sorted(os.listdir(os.path.join(out, "weights")))
        print(f"  {field}={value!r} at train(): weights {files}", flush=True)
        state = ("last_state.dcp" if field == "resume_format"
                 else "last_state.npz")
        if state not in files:
            raise SystemExit(f"{field}={value!r}: no {state}")


# ------------------------------------------------------------ phase 16
MESH_BATCH, MESH_STREAM_BATCH = 32, 16
DP_SIZE = 128          # 16b-d's float32 steps


def dp_train_epochs() -> int:
    """16b's train() epochs: 2 over several cards, 1 where two gloo ranks
    share one card (every path, no scaling number, at ~0.5 s a step)."""
    return 2 if torch.cuda.device_count() > 1 else 1


def mesh_devices():
    """(the devices of 16b-d's ranks, how they are joined): every card
    under NCCL where there are several; two gloo ranks sharing cuda:0
    where there is one (no scaling number)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return ([torch.device("cuda", i) for i in range(n)],
                f"NCCL over {n} cards")
    return ([torch.device("cuda", 0)] * 2,
            "two gloo ranks sharing cuda:0 (one card: not a scaling number)")


@torch.no_grad()
def recheck_kernels(card: torch.device):
    """Phase 2's rule on one card other than cuda:0, a handful of v8s /
    v12s shapes in bfloat16: each kernel against the plain version
    evaluated in float64 on the same rounded inputs."""
    from yolosharp_tpu_torch.kernels import (attention_plain, c2f_fused,
                                             c2f_plain, conv3x3_plain,
                                             conv3x3_silu, conv3x3s2_silu,
                                             fused_attention)

    g = torch.Generator(device="cpu").manual_seed(int(card.index))

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            card, torch.bfloat16)

    dt = torch.bfloat16
    for stride, (h, w, ci, co) in ((1, (80, 80, 128, 128)),
                                   (1, (40, 40, 256, 256)),
                                   (2, (160, 160, 64, 128)),
                                   (2, (640, 640, 3, 32))):
        x, wt, b = rnd(2, h, w, ci), rnd(3, 3, ci, co, scale=0.05), \
            rnd(co, scale=0.1)
        fn = conv3x3_silu if stride == 1 else conv3x3s2_silu
        ref = conv3x3_plain(x.double(), wt.double(), b.double(), "silu",
                            stride)
        compare(f"[{card}] {fn.__name__} {h}x{w} {ci}->{co} b2 bf16",
                fn(x, wt, b), conv3x3_plain(x, wt, b, "silu", stride), dt,
                "conv", ref)
    cin, c, c2 = 64, 32, 64
    args = [rnd(2, 160, 160, cin), rnd(cin, 2 * c, scale=0.1),
            rnd(2 * c, scale=0.1), rnd(3, 3, c, c, scale=0.05),
            rnd(c, scale=0.1), rnd(3, 3, c, c, scale=0.05),
            rnd(c, scale=0.1), rnd(3 * c, c2, scale=0.1), rnd(c2, scale=0.1)]
    compare(f"[{card}] c2f_fused 160x160 {cin}->{c2} b2 bf16",
            c2f_fused(*args), c2f_plain(*args), dt, "c2f",
            c2f_plain(*[a.double() for a in args]))
    q, k, v = (rnd(2, 4, 400, 32) for _ in range(3))
    scale = 32 ** -0.5
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    ref = torch.matmul(torch.softmax(s, -1), v.double())
    compare(f"[{card}] fused_attention (2, 4, 400, 32) bf16",
            fused_attention(q, k, v, scale),
            attention_plain(q, k, v, scale), dt, "attn", ref)


def phase_mesh_serve(dev, state, conf, tag):
    """Phase 16a. Returns the kernel launches of its bf16 mesh serving."""
    from yolosharp_tpu_torch import ScalarType
    from yolosharp_tpu_torch.kernels import (launch_counts,
                                             launch_counts_by_device,
                                             reset_launch_counts)
    from yolosharp_tpu_torch.parallel import create_mesh

    mesh = create_mesh()
    n = mesh.size
    print(f"phase 16a: mesh serving, v8s-640 nc=80 over create_mesh() = "
          f"{n} card(s) {[str(d) for d in mesh.devices]}", flush=True)
    for card in mesh.devices[1:]:
        recheck_kernels(card)
    if n == 1:
        print("  one card: phase 2's kernels were checked on cuda:0 only",
              flush=True)
    tasks = build_tasks(dev, "v8", state)
    task = tasks[False]
    batch = synthetic_images(MESH_BATCH + 1, 640, 640, 60)
    reset_launch_counts()
    for images in (batch[:MESH_BATCH], batch):
        res = task.batch_predict(images, conf, mesh=mesh)
        if len(res) != len(images) or not all(res):
            raise SystemExit(f"mesh batch_predict of {len(images)} images "
                             f"gave {[len(r) for r in res]}")
    stream = stream_images(STREAM_N, 70)
    got = list(task.predict_stream(iter(stream), MESH_STREAM_BATCH,
                                   predict_threshold=conf, mesh=mesh))
    if len(got) != STREAM_N or not all(got):
        raise SystemExit(f"mesh predict_stream gave {len(got)} results")
    counts, by_card = launch_counts(), launch_counts_by_device()
    print(f"  {tag}: launches while serving b{MESH_BATCH}, b{MESH_BATCH + 1} "
          f"and a {STREAM_N}-image stream (b{MESH_STREAM_BATCH}) over the "
          f"mesh: {counts}; by card {by_card}", flush=True)
    for name in PATHS["v8"]:
        missing = [d.index for d in mesh.devices
                   if not by_card[name].get(d.index)]
        if missing:
            raise SystemExit(f"{name} launched on no card of {missing}")
    check_path_launches("v8", counts, "16a mesh serving")

    # float32 rows of every image, sharded and whole, by phase 3's rule
    t32 = build_tasks(dev, "v8", state,
                      scalar_type=ScalarType.float32)[False].task
    canvas = torch.from_numpy(np.stack(batch[:n + 1]))
    one = t32._host(t32._predict_fn(t32._predict_variables(),
                                    canvas.to(dev), conf, 0.7))
    parts = t32._mesh_outputs(canvas, mesh, lambda net, x: t32._host(
        t32._predict_fn(net, x, conf, 0.7)))
    worst = (0, 0)
    for out, lo, hi in parts:
        for i in range(hi - lo):
            nw, ng, bad = match(rows_of(tasks[False], out, conf, i),
                                rows_of(tasks[False], one, conf, lo + i))
            worst = max(worst, (bad, nw))
            if abs(nw - ng) > 2 or bad > max(2, nw // 50):
                raise SystemExit(f"float32 mesh rows of image {lo + i}: "
                                 f"{ng} against {nw}, {bad} unmatched")
    print(f"  float32, {n + 1} images over the mesh against one forward on "
          f"cuda:0: rows match (0.5 px, 1e-3 score; worst {worst[0]} "
          f"unmatched of {worst[1]})", flush=True)

    def seconds(fn, images):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(images)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    b32 = batch[:MESH_BATCH]
    calls = {"cuda:0": lambda im: task.batch_predict(im, conf),
             "mesh": lambda im: task.batch_predict(im, conf, mesh=mesh)}
    times = {k: [] for k in calls}
    for k in ("cuda:0", "mesh") * 2 + ("mesh", "cuda:0") * 4:
        times[k].append(seconds(calls[k], b32))
    # the median of each one's calls after its first, in turns
    single, meshed = (MESH_BATCH / float(np.median(times[k][1:]))
                      for k in ("cuda:0", "mesh"))
    t = time.perf_counter()
    list(task.predict_stream(iter(stream), MESH_STREAM_BATCH,
                             predict_threshold=conf, mesh=mesh))
    streamed = STREAM_N / (time.perf_counter() - t)
    print(f"  {tag}: bf16 b{MESH_BATCH} batch_predict {single:.1f} img/s on "
          f"cuda:0, {meshed:.1f} img/s over {n} card(s) ({meshed / single:.2f}"
          f"x; medians of 5 calls each, in turns); predict_stream over the "
          f"mesh {streamed:.1f} img/s", flush=True)
    return counts


def step_spec(version, size, batch, dtype=None, **cfg):
    """run_steps' spec of a float32 (or dtype's) detect step from the
    task's seeded weights on `batch`."""
    from yolosharp_tpu_torch import (Config, ScalarType, YoloSize, YoloTask,
                                     YoloType)

    config = Config(yolo_type=YoloType(version), yolo_size=YoloSize(size),
                    number_class=80, scalar_type=dtype or ScalarType.float32,
                    image_size=DP_SIZE, **cfg)
    net = YoloTask(config, device="cpu").task._ensure_variables()
    sd = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return dict(config=config, state_dict=sd, batch=batch), \
        zero_gradient_leaves(net)


def hold_step(label, got, want, init, zero, grads_got=None,
              second=False):
    """Phase 6's rule between two runs of one step: loss and items to 1e-4
    relative; the leaves whose gradient is 0 by construction read |g| <=
    1e-6 G; the others' gradients |g_got - g_want| <= 1e-3 max|g_want|
    per tensor (where got has gradients: DP; under FSDP each rank holds
    slices, and dg is taken as that bound); parameter changes |dp_got -
    dp_want| <= 1e-3 max|dp_want| + 1e-8 + the parameter's float32
    spacing wherever the gradients fix AdamW's update; BN statistics
    |d| <= 1e-5 (|ref| + max|ref|), a mean's max|ref| at least its
    layer's largest standard deviation. second: a second step (the AdamW
    update m / sqrt(v) no longer follows the gradient's sign alone), the
    parameter changes printed, not held; want without gradients takes
    got's."""
    items_rel = float(np.max(np.abs(got["items"] - want["items"])
                             / np.maximum(np.abs(want["items"]), 1e-30)))
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    gw = want.get("grads") or got["grads"]
    big = max(float(g.abs().max()) for g in gw.values())
    noise_bad = grad_bad = unexplained = 0
    for name, g in gw.items():
        if name in zero:
            noise_bad += float(g.abs().max()) > 1e-6 * big
            if grads_got is not None:
                noise_bad += float(grads_got[name].abs().max()) > 1e-6 * big
            continue
        gmax = float(g.abs().max())
        if grads_got is not None:
            dg = (grads_got[name] - g).abs()
            grad_bad += int((dg > 1e-3 * gmax).sum())
        else:
            dg = torch.full_like(g, 1e-3 * gmax)
        d_got = got["state_dict"][name] - init[name]
        d_want = want["state_dict"][name] - init[name]
        # plus one float32 spacing of the parameter: a change near lr
        # (1e-8 early in the warm-up) is a fraction of it
        spacing = torch.from_numpy(np.spacing(init[name].abs().numpy()))
        bad = (d_got - d_want).abs() > (1e-3 * d_want.abs().max() + 1e-8
                                        + spacing)
        fixed = (g.abs() > 2 * dg) & (2e3 * 1e-8 * dg < g * g)
        if (bad & fixed).any() and not unexplained:
            i = int(torch.nonzero((bad & fixed).flatten())[0])
            print(f"    first outside: {name}[{i}] g "
                  f"{float(g.flatten()[i]):.3e}"
                  f" dg {float(dg.flatten()[i]):.3e} dp "
                  f"{float(d_got.flatten()[i]):.6e} / "
                  f"{float(d_want.flatten()[i]):.6e} (max|dp| "
                  f"{float(d_want.abs().max()):.3e})", flush=True)
        unexplained += int((bad & fixed).sum())
    stat_bad, stat_worst = 0, 0.0
    sd_w = want["state_dict"]
    for k, ref in sd_w.items():
        if not k.endswith(("running_mean", "running_var")):
            continue
        scale = float(ref.abs().max())
        if k.endswith("running_mean"):
            scale = max(scale, float(sd_w[k[:-4] + "var"].sqrt().max()))
        rel = float(((got["state_dict"][k] - ref).abs()
                     / (ref.abs() + scale)).max())
        stat_worst = max(stat_worst, rel)
        stat_bad += rel > 1e-5
    print(f"  [{label}] loss {got['loss']:.6f} / {want['loss']:.6f} (rel "
          f"{loss_rel:.2e}), items max rel {items_rel:.2e}; gradients "
          f"{grad_bad} elements outside 1e-3, zero leaves {noise_bad} above "
          f"1e-6 G; parameter changes {unexplained} outside the rule where "
          f"the gradients fix them"
          f"{' (a second step: not held)' if second else ''}"
          f"; BN statistics worst {stat_worst:.2e}", flush=True)
    if second:
        unexplained = 0
    if loss_rel > 1e-4 or items_rel > 1e-4 or noise_bad or grad_bad \
            or unexplained or stat_bad:
        raise SystemExit(f"[{label}] the steps disagree")


def trace_collectives(path) -> dict:
    """{kind: ms summed over the traced steps} of the collectives in a
    torch.profiler Chrome trace: NCCL kernels on the card, the c10d /
    gloo ops on the host."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = str(e.get("name", ""))
        low = name.lower()
        if e.get("cat") == "kernel" and "nccl" in low:
            key = "card: " + name.split("(")[0][:48]
        elif e.get("cat") == "cpu_op" and ("c10d::" in low or "gloo" in low):
            key = "host: " + name[:48]
        else:
            continue
        out[key] = out.get(key, 0.0) + float(e.get("dur", 0)) / 1e3
    return out


def phase_dp(dev, root, tag) -> dict:
    """Phases 16b-d. Returns the kernel launches of 16b's train() on this
    process (rank 0)."""
    from yolosharp_tpu_torch import ScalarType
    from yolosharp_tpu_torch.graft_entry import run_steps

    devices, how = mesh_devices()
    d = len(devices)
    print(f"phase 16b: data-parallel train, {how}", flush=True)
    batch = train_batch(2 * d, DP_SIZE, 80)
    v8n, zero8 = step_spec("v8", "n", batch)
    v12n, zero12 = step_spec("v12", "n", batch)
    v8s, zero8s = step_spec("v8", "s", batch)
    # a bfloat16 v12n step: its attention backward is the kernel
    v12n16, _ = step_spec("v12", "n", batch, dtype=ScalarType.bfloat16)
    t = time.perf_counter()
    one = run_steps([v8n, v12n, v8s], [dev])
    t1 = time.perf_counter()
    ck = os.path.join(root, "last_state.dcp")
    dp8, dp12, dp8s, fs8s, fs8s2, dp8s2, dp12b = run_steps(
        [v8n, v12n, v8s, dict(v8s, fsdp=True),
         dict(v8s, fsdp=True, steps=2, save_dcp=ck), dict(v8s, steps=2),
         v12n16], devices)
    t2 = time.perf_counter()
    print(f"  float32 steps at {DP_SIZE}x{DP_SIZE}, global batch {2 * d}: "
          f"on cuda:0 {t1 - t:.1f} s, over the ranks {t2 - t1:.1f} s "
          f"(spawn and NCCL / gloo set-up included)", flush=True)
    hold_step(f"v8n DP x{d} vs cuda:0", dp8, one[0], v8n["state_dict"],
              zero8, dp8["grads"])
    hold_step(f"v12n DP x{d} vs cuda:0", dp12, one[1], v12n["state_dict"],
              zero12, dp12["grads"])
    attn = [r["fused_attention"] for r in dp12["launches_by_rank"]]
    print(f"  v12n: fused_attention launches by rank {attn} (the kernel "
          f"under autograd on every rank)", flush=True)
    if devices[0].type == "cuda" and not all(attn):
        raise SystemExit("a rank's v12n step did not launch the attention "
                         "kernel")
    bwd = [r["fused_attention_bwd"] for r in dp12b["launches_by_rank"]]
    print(f"  v12n bfloat16 DP x{d}: fused_attention_bwd launches by rank "
          f"{bwd} (8 a step: the backward kernel on every rank); loss "
          f"{dp12b['loss']:.6f}", flush=True)
    if devices[0].type == "cuda" and (
            any(n != 8 for n in bwd) or not np.isfinite(dp12b["loss"])):
        raise SystemExit("a rank's bfloat16 v12n step did not launch the "
                         "attention backward kernel 8 times, or its loss "
                         "is not finite")

    print(f"phase 16c: FSDP, one v8s step against the DP step, {how}",
          flush=True)
    hold_step(f"v8s FSDP x{d} vs DP x{d}", fs8s, dp8s, v8s["state_dict"],
              zero8s)
    print(f"  {tag}: per-rank sharded train-state bytes "
          f"{fs8s['state_bytes']} (masters, AdamW moments and steps, BN "
          f"buffers, read from the storage held), sharded_param_bytes "
          f"{fs8s['sharded_param_bytes']}, besides the full working weights "
          f"of the sharded parameters ({fs8s['working_bytes']} bytes, on "
          f"every rank); peak CUDA bytes a rank in the one step: DP "
          f"{dp8s['peak_by_rank']}, FSDP {fs8s['peak_by_rank']}; the v8s "
          f"float32 step at {DP_SIZE}, the second of two (after the "
          f"warm-up), a rank: DP {dp8s2['step_s'][1] * 1e3:.1f} ms, FSDP "
          f"{fs8s2['step_s'][1] * 1e3:.1f} ms", flush=True)
    if fs8s["state_bytes"] != fs8s["sharded_param_bytes"]:
        raise SystemExit("FSDP state bytes differ from sharded_param_bytes")
    if not all(f < p for f, p in zip(fs8s["peak_by_rank"],
                                     dp8s["peak_by_rank"])):
        raise SystemExit("FSDP's peak memory is not below DP's on every "
                         "rank")

    print(f"phase 16d: sharded-directory resume: two FSDP v8s steps over "
          f"the ranks, the state saved after the first to {ck}; cuda:0 "
          f"alone resumes and takes the second", flush=True)
    saved, res = run_steps([dict(v8s, resume=ck, steps=0),
                            dict(v8s, resume=ck)], [dev])
    if (saved["count"], res["count"], res["step"]) != (1, 2, 2):
        raise SystemExit("the resumed counts are not the saved ones")
    # the state read back on one card is the FSDP state saved, bit for bit
    want = fs8s2["saved"]
    diff = [k for k, v in want["state_dict"].items()
            if not torch.equal(saved["state_dict"][k], v)]
    diff += [f"{n}.{k}" for n, st in want["opt_state"].items()
             for k, v in st.items()
             if not torch.equal(saved["opt_state"][n][k].float(), v.float())]
    print(f"  read back on cuda:0: {len(want['state_dict'])} network "
          f"tensors and {sum(len(st) for st in want['opt_state'].values())} "
          f"AdamW tensors, {len(diff)} differ from the saved FSDP state",
          flush=True)
    if diff:
        raise SystemExit(f"the resumed state differs: {diff[:5]}")
    hold_step("v8s resumed on cuda:0 vs uninterrupted FSDP, second step",
              res, fs8s2, saved["state_dict"], zero8s, second=True)
    return phase_dp_train(dev, root, tag)


def phase_dp_train(dev, root, tag) -> dict:
    """16b's YoloTask.train() over the ranks. Returns the kernel launches
    of train() on this process (rank 0)."""
    from yolosharp_tpu_torch import YoloTask
    from yolosharp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from yolosharp_tpu_torch.parallel import create_mesh

    devices, how = mesh_devices()
    d = len(devices)
    epochs = dp_train_epochs()
    print(f"phase 16b: YoloTask.train() of v8s, {TRAIN_SIZE}x{TRAIN_SIZE}, "
          f"global batch {TRAIN_BATCH}, bf16, {epochs} epoch(s), "
          f"{how}; torch.profiler over rank 0's steps 2-5", flush=True)
    out = os.path.join(root, "run_dp")
    prof = os.path.join(root, "prof_dp")
    task = YoloTask(_train_config(root, "v8", epochs=epochs,
                                  output_path=out, profile_dir=prof),
                    device=dev)
    reset_launch_counts()
    t = time.perf_counter()
    task.train(mesh=create_mesh(devices=devices))
    wall = time.perf_counter() - t
    counts = launch_counts()
    per = TRAIN_BATCH // d
    for st in task.task.epoch_stats:
        print("  " + epoch_line(st, f"{tag}: v8s rank 0 ({per} img a step)",
                                batch=per), flush=True)
        for r, rs in enumerate(st["ranks"]):
            med = float(np.median(rs["step_s"][2:])) * 1e3
            wait = sum(rs["wait_s"]) / rs["loop_s"]
            print(f"    rank {r}: {len(rs['step_s'])} steps, {med:.1f} ms a "
                  f"step (median after two), {per / med * 1e3:.1f} img/s a "
                  f"rank, {TRAIN_BATCH / med * 1e3:.1f} img/s global; "
                  f"loader wait {wait:.3f}; peak "
                  f"{rs['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    coll = trace_collectives(task.task.trace_path)
    print(f"  collectives in rank 0's trace of steps 2-5, ms a step: "
          + ", ".join(f"{k} {v / 4:.3f}" for k, v in sorted(coll.items())),
          flush=True)
    with open(os.path.join(out, "log.csv")) as f:
        rows = list(csv.reader(f))
    files = sorted(os.listdir(os.path.join(out, "weights")))
    print(f"  train() {wall:.1f} s; log.csv {len(rows) - 1} epochs; weights "
          f"{files}; launches on rank 0 {counts}", flush=True)
    losses = [float(v) for h, v in zip(rows[0], rows[-1]) if "loss" in h]
    if len(rows) != epochs + 1 or not np.isfinite(losses).all() \
            or files != ["best.bin", "last.bin", "last_state.npz"]:
        raise SystemExit("data-parallel train() outputs are wrong")
    return counts


def phase_graft(dev):
    """Phase 16e."""
    from yolosharp_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"phase 16e: graft_entry.entry() on {args[1].device}: decode "
          f"{tuple(out.shape)} {out.dtype}, finite "
          f"{bool(torch.isfinite(out).all())}", flush=True)
    if out.shape[0] != 1 or not bool(torch.isfinite(out).all()):
        raise SystemExit("graft_entry.entry() output is wrong")
    t = time.perf_counter()
    graft_entry.dryrun_multichip(2)
    print(f"  dryrun_multichip(2) on gloo CPU ranks: "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def multi_only(dev, tag, timed) -> int:
    """``python3 chip_smoke.py --multi``: phase 3's v8s slice (one NMS
    batch_predict, for its weights and conf), then phases 16a-d alone, on
    phase 7's PNG set; for a machine of several cards, where the other
    phases would only repeat the one-card run."""
    t16 = time.perf_counter()
    _, _, state, conf = timed("3", phase_slice, dev, "v8", light=True)
    timed("16a", phase_mesh_serve, dev, state, conf, tag)
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root, 160, 32)
        timed("16b-d", phase_dp, dev, root, tag)
    print(f"  (phases 3 and 16a-d: {time.perf_counter() - t16:.1f} s wall)",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dp_train_only(dev, tag, timed) -> int:
    """``python3 chip_smoke.py --dp-train``: 16b's train() alone over the
    visible cards, on phase 7's PNG set."""
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root, 160, 32)
        timed("16b", phase_dp_train, dev, root, tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------ phase 17
# H100 SXM dense int8 tensor cores (NVIDIA's data sheet)
INT8_PEAK = 1979e12
# 17a's shape groups: (name, path, canvas, which of its int8 shapes)
INT8_GROUPS = (("v8s-640", "v8", 640, lambda sh: True),
               ("v12s-640", "v12", 640, lambda sh: True),
               ("v5us stem", "v5u", 640, lambda sh: sh[4] == 6),
               (f"{POSE_S} Ci/Co = 51", POSE_S, 640,
                lambda sh: 51 in sh[2:4]),
               (f"{CLS}-224", CLS, 224, lambda sh: True))
INT8_CALIB = 16     # phase 7's PNGs 17b calibrates on
# 17b's float32 card against CPU. What holds the card's int8 to the CPU's
# is the layer check: the card folds and quantises its own copy, and each
# int8 ConvBN of it holds the CPU's folded and int8 buffers to the bit
# (the int8 scales divide as utils.numerics.divide_by_constant does on
# both devices) and, fed the CPU net's input to it, gives the CPU's output
# (to the bit with the identity activation, else within TOL_F32["conv"]),
# with one int8_conv launch for each calibrated conv. Whole nets then
# drift apart like two draws of the quantisation noise: a float ulp apart
# in a conv's input flips a rounding to int8 now and then, and the next
# layers' roundings follow. The head gates: the card's int8 lies from the
# CPU's int8 at most INT8_CPU_FACTOR times the CPU int8's distance from
# the CPU float (two independent draws would read sqrt(2); the drift is
# partial: tests/test_torch_int8.py read 0.50-0.71 for the port against
# JAX on v8n-160, the card 0.868 on one v8s-640 image), and at least
# INT8_FLOAT_FLOOR times that distance from the CPU float (a net that did
# not quantise would read ~0 there, a quantising one ~1). Neither head
# gate alone tells int8 from a float net at ~1: the layer check and the
# launch count do.
INT8_IMAGES = 4
# a folded ConvBN's buffers: its float fold and its int8 weights and scales
FOLD_BUFFERS = ("w_fold", "b_fold", "i8_w", "i8_scale", "i8_ascale")
INT8_CPU_FACTOR = 1.0
INT8_FLOAT_FLOOR = 0.5
# the JAX facade test's rule (tests/test_int8.py:123-133): the share of
# float boxes an int8 box matches within max(4 px, 5% of the larger side)
INT8_MATCH = 0.7


@torch.no_grad()
def record_int8_shapes(path: str, canvas: int) -> set:
    """{(H, W, Ci, Co, k, s, p, act)} of the int8-eligible ConvBNs of the
    path's folded net, both End2End branches, one image on the CPU."""
    from yolosharp_tpu_torch.ckpt import fold_bn
    from yolosharp_tpu_torch.nn import ArchCfg, ConvBN, YoloNet

    version, size, task = ARCH[path]
    net = fold_bn(YoloNet(ArchCfg(version=version, size=size, task=task,
                                  nc=PATH_NC.get(path, 80),
                                  end2end=task != "classify")).eval())
    shapes = set()

    def hook(m, inp, out):
        _, ci, h, w = inp[0].shape
        shapes.add((h, w, ci, m.conv.out_channels, m.k, m.s, m.p, m.act))

    for m in net.modules():
        if isinstance(m, ConvBN) and m.int8_eligible:
            m.register_forward_hook(hook)
    net(torch.zeros(1, 3, canvas, canvas).contiguous(
        memory_format=torch.channels_last))
    return shapes


def int8_bound(batch, shape, dtype, cin=None, fused=False):
    """(conv flop, conv bytes, quantise bytes) of one int8 conv: the
    products of K = k k Ci, each input read once and the output written
    once (x in its type; xq and wq int8 over the conv's Ci channels, or
    over `cin`, the kernel's padded Cp, for the traffic as built; fused:
    the stem route, which reads x in its type and no xq)."""
    h, w, ci, co, k, s, p, _ = shape
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    cq = ci if cin is None else cin
    size = torch.finfo(dtype).bits // 8
    m = batch * ho * wo
    flop = 2 * m * co * k * k * ci
    conv_bytes = ((size * ci if fused else cq) * batch * h * w
                  + co * k * k * cq + 4 * co + size * co + size * m * co)
    quant_bytes = batch * h * w * (size * ci + cq)
    return flop, conv_bytes, quant_bytes


# phase 17a's aims for the int8 conv at B=32 bf16, set when it moved to
# wgmma: the sum of all shapes at most this many ms, at least this share
# of its bound; the stem route's (quantise included) at most this many ms
INT8_AIM_MS, INT8_AIM_SHARE = 3.5, 0.33
INT8_STEM_AIM_MS = 0.6
# the ragged int8 stems phase 17a holds at B=3 (the card tests' kind):
# (H, W, Ci, Co, k, s, p, act)
INT8_STEM_RAGGED = ((9, 33, 3, 16, 3, 2, 1, "silu"),
                    (17, 23, 3, 70, 3, 1, 1, "identity"),
                    (13, 17, 3, 16, 6, 2, 2, "silu"))


def int8_mma_call(xq, wq, scale, b, stride, pad, act):
    """The int8 conv on the mma.sync kernel (route "mma") whatever the
    shape's route: the kernel every shape took before the wgmma routes,
    timed beside them. Not counted as a launch of int8_conv."""
    from yolosharp_tpu_torch.kernels import build
    from yolosharp_tpu_torch.kernels.conv3x3 import ACT_CODES
    from yolosharp_tpu_torch.kernels.int8_conv import ROUTES, _lib

    B, H, W, cp = xq.shape
    co, k = wq.shape[0], wq.shape[1]
    ho, wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    y = torch.empty((B, ho, wo, co), dtype=b.dtype, device=xq.device)
    status = _lib().ys_int8_conv(
        xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
        y.data_ptr(), B, H, W, cp, co, k, stride, pad, ACT_CODES[act],
        build.DTYPE_CODES[b.dtype], ROUTES.index("mma"), 0, 0, 0, 0,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check_status("int8 mma.sync", status)
    return y


def int8_desc_probe(dev) -> None:
    """The 8-bit descriptor probe: a 128 x bk int8 tile loaded by TMA under
    the 64- or 128-byte swizzle, read by wgmma s8 from every row start r0
    < 64 (a tap starts at any pixel row, off the swizzle atom), gives
    A[r0 : r0 + 64] B^T exactly."""
    from yolosharp_tpu_torch.kernels.int8_conv import desc_probe

    g = torch.Generator(device=dev).manual_seed(8)
    for bk in (64, 128):
        a = torch.randint(-127, 128, (128, bk), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (64, bk), generator=g, device=dev,
                          dtype=torch.int8)
        out = desc_probe(a, b, 64).double()
        ref = a.double() @ b.double().t()
        bad = [r0 for r0 in range(64)
               if not torch.equal(out[r0], ref[r0:r0 + 64])]
        print(f"  8-bit descriptor probe, {bk}-byte rows: every row start "
              f"0..63 {'exact' if not bad else f'WRONG at {bad[:8]}'}",
              flush=True)
        if bad:
            raise SystemExit("the 8-bit wgmma descriptor reads wrong rows")


def int8_silu_check(dev) -> None:
    """The int8 epilogue's branch-free SiLU against v / (1 + expf(-v)) with
    the IEEE division at all 2^32 float32 inputs: equal bits at every one
    (the int8 conv's SiLU is its plain version's on the card)."""
    from yolosharp_tpu_torch.kernels.int8_conv import silu_check

    bad = silu_check(dev)
    print(f"  the epilogue's SiLU at all 2^32 float32 inputs: {bad} differ "
          f"from the IEEE-division SiLU in their bits", flush=True)
    if bad:
        raise SystemExit("the int8 epilogue's SiLU differs from silu()")


def phase_int8_kernels(dev) -> dict:
    """Phase 17a: the quantise pass and the int8 conv against their plain
    versions at every int8 shape of the groups, B=2 in float32, bfloat16
    and float16 and B=32 in bfloat16, each on its route (int8_route, the
    ConvBN's: the stems quantise in the conv's launch) and plan (int8_plan,
    stem_plan), timed at B=32: kernel, the mma.sync kernel every shape took
    before the wgmma routes (and the stem route), plain, torch._int_mm
    (1x1 stride-1 shapes whose Co is a multiple of 8), bound and the conv's
    float route today (the conv3x3 kernel or cuDNN); sums by route."""
    from yolosharp_tpu_torch.kernels.conv3x3 import stem_plan
    from yolosharp_tpu_torch.kernels.int8_conv import (
        ACTS, activation_scale, int8_conv, int8_conv_plain, int8_conv_stem,
        int8_plan, int8_route, padded_channels, quantize_int8,
        quantize_plain, quantize_weight)
    from yolosharp_tpu_torch.nn import ConvBN

    print("phase 17a: int8 kernels against their plain versions: every "
          "int8 shape of " + ", ".join(g[0] for g in INT8_GROUPS)
          + f" at B={BATCH} in float32, bfloat16 and float16 and at "
          f"B={SERVED_BATCH} in bfloat16 (timed), each on its route",
          flush=True)
    int8_desc_probe(dev)
    int8_silu_check(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tagged = {}
    for group, path, canvas, holds in INT8_GROUPS:
        for sh in record_int8_shapes(path, canvas):
            if holds(sh):
                tagged.setdefault(sh, []).append(group)
    shapes = sorted(tagged.items(), key=lambda t: (-t[0][0], t[0]))
    print(f"  {len(shapes)} shapes (H, W, Ci, Co, k, s, p, act)", flush=True)
    g = torch.Generator(device=dev).manual_seed(17)
    stats = {n: {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0,
                 "max_abs_err_f16": 0.0, "shapes": len(shapes), "ms": 0.0,
                 "plain_ms": 0.0, "bound_ms": 0.0, "bound_ms_padded": 0.0,
                 "library_ms": None}
             for n in INT8_SOURCES}
    conv = stats["int8_conv"]
    conv.update({"library_ms": 0.0, "ms_int_mm_shapes": 0.0,
                 "library_shapes": 0, "bf16_route_ms": 0.0,
                 "ms_with_quantize": 0.0})
    parts = {n: {} for n in INT8_SOURCES}
    group_sums = {}
    # route -> [shapes, kernel, mma.sync kernel (the stem route: with its
    # quantise pass), torch._int_mm, kernel on the _int_mm shapes, bound,
    # float route] at B=32 bf16
    route_sums = {}
    # the stems at B=32 bf16: (shape, kernel, float route ms)
    stem_times = []
    for sh, groups in shapes:
        h, w, ci, co, k, s, p, act = sh
        cp = padded_channels(ci)
        route = int8_route(k, s, p, cp, co, ci)
        stem = route == "stem"
        wf = torch.randn(co, ci, k, k, generator=g, device=dev) * (
            k * k * ci) ** -0.5
        wq, w_scale = quantize_weight(wf)
        for dtype, batch in ((torch.float32, BATCH), (torch.bfloat16, BATCH),
                             (torch.float16, BATCH),
                             (torch.bfloat16, SERVED_BATCH)):
            dt = str(dtype)[6:]
            x = (torch.randn(batch, h, w, ci, generator=g, device=dev)
                 * 2).to(dtype)
            b = (torch.randn(co, generator=g, device=dev) * 0.1).to(dtype)
            # some inputs past 127 a_scale: the clip is exercised
            a = activation_scale(x.float().abs().amax() * 0.9)
            scale = (a * w_scale).contiguous()
            xq = quantize_int8(x, a, cp)
            xq_plain = quantize_plain(x, a, cp)
            got = (int8_conv_stem(x, a, wq, scale, b, s, p, act) if stem
                   else int8_conv(xq_plain, wq, scale, b, s, p, act))
            want = int8_conv_plain(xq_plain, wq, scale, b, s, p, act)
            ref = ACTS[act](int8_conv_plain(xq_plain, wq, scale, b, s, p)
                            .double())
            torch.cuda.synchronize()
            if stem:
                plan = stem_plan(batch, h, w, ci, co, s, sms, k, p,
                                 x.element_size(), b.element_size(), True)
                desc = stem_variant(plan)
            else:
                plan = int8_plan(route, batch, h, w, cp, co, s, sms,
                                 b.element_size())
                desc = ((f" BK {plan.bk} BN {plan.bn}" if plan.bn else "")
                        + (f" tile {plan.rows}x{plan.wt}" if plan.rows
                           else ""))
            tag = (f"{h}x{w} {ci}->{co} k{k} s{s} p{p} {act} {dt} "
                   f"B={batch} [" + (desc if stem else route + desc)
                   + f"] [{' + '.join(groups)}]")
            if not torch.equal(xq, xq_plain):
                raise SystemExit(f"quantize_int8 {tag}: differs from its "
                                 f"plain version")
            err = float((got.float() - want.float()).abs().max())
            top = float(ref.abs().max()) + 1e-12
            dk = float((got.double() - ref).abs().max()) / top
            if stem:   # the same int8 values, sums and epilogue
                ok = torch.equal(got, want.contiguous())
                rule = "equal to the bit (quantise included)"
            elif dtype == torch.float32:
                atol, rtol = TOL_F32["conv"]
                bad = int(((got - want).abs() > atol + rtol * want.abs())
                          .sum())
                ok = (torch.equal(got, want.contiguous()) if act == "identity"
                      else bad == 0)
                rule = ("equal to the bit" if act == "identity" else
                        f"|k-p| <= {atol} + {rtol}|p| ({bad} outside)")
            else:
                ok = dk <= TOL16["conv"] * UNIT[dtype]
                rule = (f"vs float64 of the same int32 sums {dk / UNIT[dtype]:.3f}"
                        f" u (<= {TOL16['conv']} u)")
            finite = bool(torch.isfinite(got).all())
            print(f"  int8_conv {tag}: max|k-p| {err:.3e}, {rule} "
                  f"{'OK' if ok and finite else 'FAIL'}", flush=True)
            if not (ok and finite):
                raise SystemExit(f"int8_conv {tag}: kernel disagrees with "
                                 f"its plain version")
            key = ERR_KEY[dtype]
            conv[key] = max(conv[key], err)
            if batch != SERVED_BATCH:
                continue
            # the float route this conv takes without int8, in the same type
            fl = ConvBN(ci, co, k, s, p, act=act)
            fl.set_folded(wf, b.float())
            fl = fl.to(dev, dtype).eval()
            xn = x.permute(0, 3, 1, 2)
            fns = {"plain": lambda: int8_conv_plain(
                       quantize_plain(x, a, cp), wq, scale, b, s, p, act),
                   "kernel": (lambda: int8_conv_stem(x, a, wq, scale, b, s,
                                                     p, act)) if stem else
                   (lambda: int8_conv(xq, wq, scale, b, s, p, act)),
                   "mma.sync": lambda: int8_mma_call(xq, wq, scale, b, s, p,
                                                     act),
                   "quantize": lambda: quantize_int8(x, a, cp),
                   "plain quantize": lambda: quantize_plain(x, a, cp),
                   "both": lambda: int8_conv(quantize_int8(x, a, cp), wq,
                                             scale, b, s, p, act),
                   "bf16 route": lambda: fl(xn)}
            lib = k == 1 and s == 1 and co % 8 == 0
            if lib:
                a2, b2 = xq.view(-1, cp), wq.view(co, cp).t()
                fns["library"] = lambda: torch._int_mm(a2, b2)
                torch.testing.assert_close(
                    torch._int_mm(a2, b2).double(),
                    F.conv2d(xq.permute(0, 3, 1, 2).double(),
                             wq.permute(0, 3, 1, 2).double()).permute(
                        0, 2, 3, 1).reshape(-1, co), rtol=0, atol=0)
            t, _ = time_calls(fns, iters=5)
            flop, cbytes, qbytes = int8_bound(batch, sh, dtype, fused=stem)
            if stem:    # no quantise pass: its launch is the kernel's
                qbytes = 0
            cb, cby = max((flop / INT8_PEAK * 1e3, "operations"),
                          (cbytes / HBM_BYTES * 1e3, "bytes"))
            qb = qbytes / HBM_BYTES * 1e3
            # the same bound over the kernel's Cp-padded xq and wq
            _, cpad, qpad = int8_bound(batch, sh, dtype, cp, fused=stem)
            if stem:
                qpad = 0
            cb_pad = max(flop / INT8_PEAK, cpad / HBM_BYTES) * 1e3
            qb_pad = qpad / HBM_BYTES * 1e3
            rs = route_sums.setdefault(route, [0] + [0.0] * 7)
            for j, v in enumerate((1, t["kernel"], t["mma.sync"],
                                   t.get("library", 0.0),
                                   t["kernel"] if lib else 0.0, cb,
                                   t["bf16 route"],
                                   t["quantize"] if stem else 0.0)):
                rs[j] += v
            if stem:
                stem_times.append((sh, t["kernel"], t["bf16 route"]))
                print(f"    device (CUDA graph): {t['kernel']:.4f} ms the "
                      f"stem kernel, quantise included [before: mma.sync "
                      f"kernel {t['mma.sync']:.4f} + quantise pass "
                      f"{t['quantize']:.4f} = {t['both']:.4f} ms], ",
                      end="", flush=True)
            else:
                print(f"    device (CUDA graph): {t['kernel']:.4f} ms conv "
                      f"kernel [mma.sync kernel {t['mma.sync']:.4f}] + "
                      f"{t['quantize']:.4f} ms quantise "
                      f"({t['both']:.4f} ms the two), ", end="", flush=True)
            print(f"{t['plain']:.4f} ms "
                  f"plain (its quantise {t['plain quantize']:.4f}), "
                  f"{t['bf16 route']:.4f} ms float route; "
                  + (f"{t['library']:.4f} ms torch._int_mm; " if lib
                     else "no library call; ")
                  + f"bound {cb:.4f} ms by {cby} (conv), {qb:.4f} ms "
                  f"(quantise); over Cp = {cp}: {cb_pad:.4f} + "
                  f"{qb_pad:.4f} ms; {flop / t['kernel'] / 1e9:.1f} TOP/s",
                  flush=True)
            conv["ms"] += t["kernel"]
            conv["plain_ms"] += t["plain"]
            conv["bound_ms"] += cb
            conv["bound_ms_padded"] += cb_pad
            conv["bf16_route_ms"] += t["bf16 route"]
            conv["ms_with_quantize"] += t["kernel" if stem else "both"]
            parts["int8_conv"][cby] = parts["int8_conv"].get(cby, 0.0) + cb
            q = stats["quantize_int8"]
            if not stem:    # the stems launch no quantise pass
                q["ms"] += t["quantize"]
                q["plain_ms"] += t["plain quantize"]
                q["bound_ms"] += qb
                q["bound_ms_padded"] += qb_pad
                q["quantised_shapes"] = q.get("quantised_shapes", 0) + 1
                parts["quantize_int8"]["bytes"] = \
                    parts["quantize_int8"].get("bytes", 0.0) + qb
            if lib:
                conv["library_ms"] += t["library"]
                conv["ms_int_mm_shapes"] += t["kernel"]
                conv["library_shapes"] += 1
            for group in groups:
                acc = group_sums.setdefault(group, [0] + [0.0] * 8)
                acc[0] += 1
                for j, v in enumerate((t["kernel"],
                                       0.0 if stem else t["quantize"],
                                       t["plain"], t["bf16 route"],
                                       t.get("library", 0.0),
                                       t["kernel"] if lib else 0.0,
                                       cb + qb, cb_pad + qb_pad), 1):
                    acc[j] += v
            del fl, fns
    print("  the stem route at ragged shapes, B=3, equal to the bit",
          flush=True)
    for h, w, ci, co, k, s, p, act in INT8_STEM_RAGGED:
        wq, w_scale = quantize_weight(torch.randn(
            co, ci, k, k, generator=g, device=dev) * (k * k * ci) ** -0.5)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = (torch.randn(3, h, w, ci, generator=g, device=dev)
                 * 2).to(dtype)
            b = (torch.randn(co, generator=g, device=dev) * 0.1).to(dtype)
            a = activation_scale(x.float().abs().amax() * 0.9)
            scale = (a * w_scale).contiguous()
            got = int8_conv_stem(x, a, wq, scale, b, s, p, act)
            want = int8_conv_plain(quantize_plain(x, a, padded_channels(ci)),
                                   wq, scale, b, s, p, act)
            ok = torch.equal(got, want.contiguous())
            print(f"  int8_conv {h}x{w} {ci}->{co} k{k} s{s} p{p} {act} "
                  f"{str(dtype)[6:]} B=3 [stem]: "
                  f"{'equal to the bit OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit("the int8 stem route disagrees with its "
                                 "plain version")
    q = stats["quantize_int8"]
    q["shapes"] = q.pop("quantised_shapes", 0)   # the stems quantise in-kernel
    for name, part in parts.items():
        stats[name]["bound_by"] = max(part, key=part.get)
    for group, (n, k, qz, pl, fr, lib, klib, bnd, bpad) in \
            group_sums.items():
        print(f"  {group}: {n} shapes at B={SERVED_BATCH} bf16, device ms "
              f"summed: int8 conv {k:.4f} + quantise {qz:.4f} = "
              f"{k + qz:.4f}, plain {pl:.4f}, float route {fr:.4f}, "
              f"torch._int_mm {lib:.4f} (kernel {klib:.4f} on those "
              f"shapes), bound {bnd:.4f} (over the padded Cp {bpad:.4f})",
              flush=True)
    print(f"  all {len(shapes)} shapes: int8 conv {conv['ms']:.4f} ms + "
          f"quantise {stats['quantize_int8']['ms']:.4f} ms against the "
          f"float route's {conv['bf16_route_ms']:.4f} ms", flush=True)
    old = 0.0
    for route, (n, k, mma, lib, klib, bnd, fr, qz) in sorted(
            route_sums.items()):
        old += mma
        if route == "stem":
            print(f"  route stem: {n} shapes at B={SERVED_BATCH} bf16, device "
                  f"ms summed: conv (quantise included) {k:.4f} [before: "
                  f"mma.sync kernel {mma:.4f} + quantise pass {qz:.4f} = "
                  f"{mma + qz:.4f}], float route {fr:.4f}, bound {bnd:.4f} "
                  f"({bnd / k:.3f} of it)", flush=True)
            conv.update({"stem_route_ms": k, "stem_route_before_ms": mma + qz,
                         "stem_route_bound_ms": bnd,
                         "stem_route_float_ms": fr})
            continue
        print(f"  route {route}: {n} shapes at B={SERVED_BATCH} bf16, device "
              f"ms summed: kernel {k:.4f} [mma.sync kernel {mma:.4f}], "
              f"torch._int_mm {lib:.4f} (kernel {klib:.4f} on its shapes), "
              f"bound {bnd:.4f} ({bnd / k:.3f} of it), float route "
              f"{fr:.4f}", flush=True)
    conv["ms_mma_sync"] = old
    mm = conv["ms_int_mm_shapes"]
    aims = [(f"1x1 shapes below torch._int_mm: {mm:.4f} ms against "
             f"{conv['library_ms']:.4f}", mm < conv["library_ms"]),
            (f"all {len(shapes)} shapes at most {INT8_AIM_MS} ms and at "
             f"least {INT8_AIM_SHARE} of the bound: {conv['ms']:.4f} ms "
             f"[mma.sync kernel {old:.4f}], "
             f"{conv['bound_ms'] / conv['ms']:.3f} of "
             f"{conv['bound_ms']:.4f}",
             conv["ms"] <= INT8_AIM_MS
             and conv["bound_ms"] >= INT8_AIM_SHARE * conv["ms"]),
            (f"conv + quantise below the float route: "
             f"{conv['ms_with_quantize']:.4f} ms against "
             f"{conv['bf16_route_ms']:.4f}",
             conv["ms_with_quantize"] < conv["bf16_route_ms"])]
    stem_ms = sum(k for _, k, _ in stem_times)
    aims.append((f"the {len(stem_times)} stems (quantise included) at most "
                 f"{INT8_STEM_AIM_MS} ms: {stem_ms:.4f}",
                 stem_ms <= INT8_STEM_AIM_MS))
    for sh, k, fr in stem_times:
        what = ("the 16-bit stem" if sh[4] == 3 else "its float route "
                "(cuDNN)")
        aims.append((f"the {sh[0]}^2 {sh[4]}x{sh[4]}/{sh[5]} stem no slower "
                     f"than {what}: {k:.4f} ms against {fr:.4f}", k <= fr))
    for text, held in aims:
        print(f"  aim {'held' if held else 'missed'}: {text}", flush=True)
    return stats


def int8_task(dev, path, state, **cfg):
    """The path's YoloTask with int8_predict, the state loaded."""
    from yolosharp_tpu_torch import YoloTask

    task = YoloTask(path_config(path, int8_predict=True, **cfg), device=dev)
    e2e = task.task.arch.end2end
    task.task._ensure_variables().load_state_dict(
        {k: v for k, v in state.items() if e2e or "one2one" not in k},
        strict=True)
    return task


def head_vector(preds):
    """A forward's one2many box and class maps (or a classify net's
    logits) as one float64 vector."""
    if "cls" in preds and isinstance(preds["cls"], torch.Tensor):
        return preds["cls"].double().flatten().cpu()
    return torch.cat([t.double().flatten().cpu() for kind in ("box", "cls")
                      for t in preds["one2many"][kind]])


def rms_dist(a, b) -> float:
    return float(((a - b).pow(2).mean() / b.pow(2).mean()).sqrt())


def matched_share(got, ref):
    """(float boxes an int8 box matches, float boxes) under the JAX facade
    test's rule."""
    n = 0
    for rows, want in zip(got, ref):
        b = np.array([[r.center_x, r.center_y, r.width, r.height]
                      for r in rows], np.float32).reshape(-1, 4)
        for r in want:
            row = np.float32([r.center_x, r.center_y, r.width, r.height])
            if len(b) and np.abs(b - row).max(1).min() <= max(
                    4.0, 0.05 * max(row[2], row[3])):
                n += 1
    return n, sum(len(w) for w in ref)


def phase_int8(dev, root, states, confs, tag) -> tuple:
    """Phases 17a-d. Returns (the int8 kernels' stats, their launches)."""
    from yolosharp_tpu_torch import ScalarType
    from yolosharp_tpu_torch.ckpt import flatten
    from yolosharp_tpu_torch.kernels import (launch_counts,
                                             launch_counts_by_device,
                                             reset_launch_counts)
    from yolosharp_tpu_torch.nn import ConvBN
    from yolosharp_tpu_torch.parallel import create_mesh

    stats = phase_int8_kernels(dev)
    launches = dict.fromkeys(ALL_KERNELS, 0)

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    # 17b: v8s int8 end to end
    print(f"phase 17b: v8s-640 int8: calibrate_int8 over {INT8_CALIB} of "
          f"phase 7's PNGs on the card and on the CPU, then bf16 b32 "
          f"batch_predict against the float route, float32 card against "
          f"CPU", flush=True)
    state, conf = states["v8"], confs["v8"]
    pngs = sorted(os.path.join(root, "images", "train", f)
                  for f in os.listdir(os.path.join(root, "images",
                                                   "train")))[:INT8_CALIB]
    t8 = int8_task(dev, "v8", state, end2end=False, nms_pre_topk=512)
    t0 = time.perf_counter()
    card = flatten(t8.calibrate_int8(images=pngs, n_images=INT8_CALIB))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu_task = int8_task("cpu", "v8", {k: v.cpu() for k, v in
                                       state.items()}, end2end=False)
    t0 = time.perf_counter()
    cpu = flatten(cpu_task.calibrate_int8(images=pngs, n_images=INT8_CALIB))
    t_cpu = time.perf_counter() - t0
    worst = max(abs(float(card[k]) - float(v)) / float(v)
                for k, v in cpu.items()) if card.keys() == cpu.keys() else 1
    print(f"  calibration: {len(card)} convs, card {t_card:.2f} s, CPU "
          f"{t_cpu:.2f} s; same keys {card.keys() == cpu.keys()}, largest "
          f"relative absmax difference {worst:.3e} (at most 1e-4)",
          flush=True)
    if card.keys() != cpu.keys() or worst > 1e-4:
        raise SystemExit("card and CPU calibrations disagree")
    fl8 = build_tasks(dev, "v8", state)[False]
    batch = synthetic_images(SERVED_BATCH, 640, 640, 20)
    x = torch.from_numpy(np.stack(batch)).to(dev).permute(0, 3, 1, 2)
    x = (x.float() / 255.0).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    nets = {"float": fl8.task._predict_variables(),
            "int8": t8.task._predict_variables()}
    with torch.no_grad():
        reset_launch_counts()
        nets["int8"](x)
        torch.cuda.synchronize()
        per_forward = launch_counts()
        want = expected_launches(nets["int8"])
        print(f"  int8 launches of one b32 forward: {per_forward}, from the "
              f"model's modules {want}", flush=True)
        if per_forward != want or per_forward["int8_conv"] == 0 or any(
                per_forward[k] for k in SOURCES):
            raise SystemExit("the int8 forward launched other kernels than "
                             "its modules give, or a float conv kernel")
        add(per_forward)
        ms = {k: [] for k in nets}
        for k in ("float", "int8", "int8", "float"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                nets[k](x)
            end.record()
            torch.cuda.synchronize()
            ms[k].append(start.elapsed_time(end) / 5)
    fwd = {k: float(np.mean(v)) for k, v in ms.items()}
    print(f"  {tag}: network forward bf16 b32 640x640: float {fwd['float']:.2f}"
          f" ms, int8 {fwd['int8']:.2f} ms (CUDA events, mean of 2 x 5 in "
          f"turns float, int8, int8, float); int8 / float "
          f"{fwd['int8'] / fwd['float']:.3f}: the int8 forward "
          f"{'beats' if fwd['int8'] < fwd['float'] else 'loses to'} the "
          f"float forward", flush=True)
    served = {"float": fl8, "int8": t8}
    for task in served.values():
        task.batch_predict(batch, conf)     # warm
    secs, rows = {k: [] for k in served}, {}
    reset_launch_counts()
    for k in ("float", "int8", "int8", "float"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows[k] = served[k].batch_predict(batch, conf)
        secs[k].append(time.perf_counter() - t0)
    add({k: v for k, v in launch_counts().items() if k in INT8_SOURCES})
    ips = {k: SERVED_BATCH / float(np.mean(v)) for k, v in secs.items()}
    n, total = matched_share(rows["int8"], rows["float"])
    print(f"  {tag}: batch_predict b32 bf16: float {ips['float']:.1f} img/s, "
          f"int8 {ips['int8']:.1f} img/s (host clock, mean of 2 in turns); "
          f"int8 boxes match {n} of {total} float boxes ({n / max(total, 1):.3f},"
          f" at least {INT8_MATCH}; JAX facade rule)", flush=True)
    if total == 0 or n < INT8_MATCH * total:
        raise SystemExit("int8 boxes do not match the float boxes")
    # float32, card against CPU, the card's stats on both
    images = synthetic_images(INT8_IMAGES, 640, 640, 30)
    t32 = int8_task(dev, "v8", state, end2end=False, nms_pre_topk=512,
                    scalar_type=ScalarType.float32)
    h32 = int8_task("cpu", "v8", {k: v.cpu() for k, v in state.items()},
                    end2end=False, nms_pre_topk=512,
                    scalar_type=ScalarType.float32)
    hfl = build_tasks("cpu", "v8", {k: v.cpu() for k, v in state.items()},
                      scalar_type=ScalarType.float32)[False]
    for task in (t32, h32):
        task.task._set_quant_stats(card)
    canvas = torch.from_numpy(np.stack(images)).permute(0, 3, 1, 2)
    canvas = (canvas.float() / 255).contiguous(
        memory_format=torch.channels_last)
    cnet, hnet = t32.task._predict_variables(), h32.task._predict_variables()
    cmods = dict(cnet.named_modules())
    layers, folds = [], []

    def layer_hook(name):
        def hook(m, inp, out):
            own = cmods[name]
            # the card's own fold and int8 buffers against the CPU's
            folds.append(sum(int((own._buffers[b].cpu() != m._buffers[b])
                                 .sum()) for b in FOLD_BUFFERS))
            got = own(inp[0].to(dev)).cpu()
            atol, rtol = TOL_F32["conv"]
            ok = (torch.equal(got, out) if m.act == "identity" else
                  bool(((got - out).abs() <= atol + rtol * out.abs()).all()))
            layers.append((name, ok, float((got - out).abs().max())))
        return hook

    hooks = [m.register_forward_hook(layer_hook(n))
             for n, m in hnet.named_modules()
             if isinstance(m, ConvBN) and m.i8_w is not None]
    with torch.no_grad():
        heads = {"card": head_vector(cnet(canvas.to(dev))),
                 "cpu": head_vector(hnet(canvas)),
                 "cpu float": head_vector(hfl.task._predict_variables()(
                     canvas))}
    for h in hooks:
        h.remove()
    bad = [ln for ln in layers if not ln[1]]
    print(f"  float32 int8 ConvBNs of the card, its own fold and int8 "
          f"buffers, on the CPU's input: {len(layers)} of {len(card)} "
          f"checked, {len(bad)} outside the rule (identity to the bit, SiLU "
          f"|k-p| <= {TOL_F32['conv'][0]} + {TOL_F32['conv'][1]}|p|); "
          f"largest |k-p| {max(ln[2] for ln in layers):.3e}; buffer values "
          f"({', '.join(FOLD_BUFFERS)}) differing from the CPU's: "
          f"{sum(folds)} (0 required)", flush=True)
    if len(layers) != len(card) or bad or sum(folds):
        raise SystemExit(f"float32 int8 ConvBNs: card and CPU disagree on "
                         f"the same input or in their fold: {bad[:3]}, "
                         f"{sum(folds)} buffer values")
    per = heads["cpu"].numel() // INT8_IMAGES
    ratios = [rms_dist(heads["card"][i * per:(i + 1) * per],
                       heads["cpu"][i * per:(i + 1) * per])
              / rms_dist(heads["cpu"][i * per:(i + 1) * per],
                         heads["cpu float"][i * per:(i + 1) * per])
              for i in range(INT8_IMAGES)]
    d, ref, quantised = (rms_dist(heads["card"], heads["cpu"]),
                         rms_dist(heads["cpu"], heads["cpu float"]),
                         rms_dist(heads["card"], heads["cpu float"]))
    reset_launch_counts()
    got = t32.image_predict(images[0], conf)
    used = launch_counts()
    add({k: v for k, v in used.items() if k in INT8_SOURCES})
    want_rows = h32.image_predict(images[0], conf)
    n, total = matched_share([got], [want_rows])
    print(f"  float32 int8 head outputs of {INT8_IMAGES} images, card "
          f"against CPU: RMS {d:.3e}, {d / ref:.3f} of the CPU int8's from "
          f"the CPU float's ({ref:.3e}; at most {INT8_CPU_FACTOR}; per "
          f"image {[round(r, 3) for r in ratios]}); card int8 from CPU float "
          f"{quantised / ref:.3f} of it (at least {INT8_FLOAT_FLOOR}); "
          f"image_predict: card {len(got)} rows, CPU {len(want_rows)}, {n} "
          f"of them matched (at least {INT8_MATCH}); launches {used}",
          flush=True)
    if (d > INT8_CPU_FACTOR * ref or quantised < INT8_FLOAT_FLOOR * ref
            or total == 0 or n < INT8_MATCH * total
            or used["int8_conv"] != len(card) or any(used[k]
                                                     for k in SOURCES)):
        raise SystemExit("float32 int8 predict: card and CPU disagree")

    # 17c: the other families, one int8 batch_predict at B=2
    print("phase 17c: one int8 bf16 batch_predict at B=2 of v11m-seg, "
          "v11s-pose, v12x-obb (End2End) and v8s-cls, calibrated on the "
          "batch", flush=True)
    for path in (SEG, POSE_S, OBB, CLS):
        cv = 224 if path == CLS else 640
        task = int8_task(dev, path, states[path])
        imgs = synthetic_images(2, cv, cv, 80)
        stats_n = len(flatten(task.calibrate_int8(images=imgs)))
        net = task.task._predict_variables()
        reset_launch_counts()
        res = task.batch_predict(imgs, confs.get(path, 0.0))
        torch.cuda.synchronize()
        counts = launch_counts()
        want = expected_launches(net, task.task.arch.end2end)
        print(f"  [{path}] {stats_n} convs calibrated; results per image "
              f"{[len(r) for r in res]}; launches {counts}, from the "
              f"model's modules {want}", flush=True)
        if counts != want or counts["int8_conv"] == 0 or len(res) != 2:
            raise SystemExit(f"[{path}] int8 batch_predict")
        add(counts)

    # 17d: v8s int8 over a mesh of every card
    mesh = create_mesh()
    if mesh.size == 1:
        print("phase 17d: one card: no mesh batch_predict", flush=True)
    else:
        print(f"phase 17d: v8s int8 bf16 batch_predict of {MESH_BATCH} over "
              f"{mesh.size} cards", flush=True)
        reset_launch_counts()
        res = t8.batch_predict(batch, conf, mesh=mesh)
        by_card = launch_counts_by_device()
        print(f"  results per image min {min(len(r) for r in res)}; "
              f"int8_conv launches by card {by_card['int8_conv']}",
              flush=True)
        if len(res) != SERVED_BATCH or any(
                not by_card["int8_conv"].get(dv.index)
                for dv in mesh.devices):
            raise SystemExit("int8 mesh batch_predict")
        add(launch_counts())
    return stats, {k: launches[k] for k in INT8_SOURCES}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = card()
    print(tag, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from yolosharp_tpu_torch.kernels import build

    t_start = t0 = time.perf_counter()
    names = ("conv3x3", "c2f", "attention", "attention_bwd", "int8_conv")
    host_names = build.HOST_LIBRARIES
    with ThreadPoolExecutor(len(names) + len(host_names)) as pool:
        host = [pool.submit(build.load_host, n) for n in host_names]
        list(pool.map(build.load, names))
        for h in host:
            h.result()
    print(f"phase 1: built kernels {names} and the host decoders "
          f"{host_names} from {build.SRC_DIR} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        print(f"  nvcc {name}:\n" + "\n".join(
            "    " + ln for ln in log.strip().splitlines()), flush=True)

    def timed(phase, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        print(f"  (phase {phase}: {time.perf_counter() - t:.1f} s wall)",
              flush=True)
        return out

    if "--multi" in sys.argv[1:]:
        return multi_only(dev, tag, timed)
    if "--dp-train" in sys.argv[1:]:
        return dp_train_only(dev, tag, timed)
    stats = timed("2", phase_kernels, dev)
    launches, per_forward, states, confs = {}, {}, {}, {}

    def add(counts, into):
        for name in ALL_KERNELS:
            into[name] = into.get(name, 0) + counts.get(name, 0)

    def serve(path):
        path_launches, forward, state, conf = timed(
            PHASE[path], phase_slice, dev, path,
            light=path in ("v5u", POSE_S))
        states[path], confs[path] = state, conf
        if path in CPU_MATCH:
            timed(CPU_MATCH[path], phase_cpu_match, dev, path, state, conf)
        add(path_launches, launches)
        for name in path_launches:
            per_forward.setdefault(name, {})[path] = forward[name]

    for path in PATHS:
        if ARCH[path][2] == "detect":
            serve(path)
    autograd_sums, bwd_stats = timed("5", phase_attention_autograd, dev, tag)
    stats["fused_attention"].update(autograd_sums)
    timed("6", phase_train_step_cpu_match, dev)
    add(timed("6b", phase_fp16, dev, states, confs), launches)
    train_launches = {}
    # phase 7's PNG set, kept for phase 16b
    train_root = tempfile.TemporaryDirectory()
    with contextlib.nullcontext(train_root.name) as root:
        t0 = time.perf_counter()
        mix = write_dataset(root, 160, 32)
        print(f"wrote the synthetic PNG dataset (160 train, 32 val) in "
              f"{time.perf_counter() - t0:.1f} s; rows by filter None / Sub / "
              f"Up / Average / Paeth: {mix.tolist()}", flush=True)
        add(timed("7", phase_train, dev, root, tag), train_launches)
        add(timed("7b", phase_train_v12, dev, root, tag), train_launches)
        timed("8a render", phase_render, dev, root, tag)
        mosaic_train, served = timed("8a train", phase_train_mosaic, dev,
                                     root, tag)
        add(mosaic_train, train_launches)
        add(served, launches)
        add(timed("8b", phase_train_host_mosaic, dev, root, tag),
            train_launches)
    serve(SEG)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_seg_dataset(root, 64, 16)
        print(f"wrote the synthetic PNG polygon dataset (64 train, 16 val) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        timed("9c", phase_seg_render, dev, root, tag)
        seg_train, served = timed("9d", phase_seg_train, dev, root, tag)
        add(seg_train, train_launches)
        add(served, launches)
    with tempfile.TemporaryDirectory() as root:
        timed("9e", phase_seg_val, dev, root, states[SEG], confs[SEG])
    serve(POSE)
    serve(POSE_S)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_pose_dataset(root, 64, 16)
        print(f"wrote the synthetic PNG pose dataset (64 train, 16 val) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        pose_train, served = timed("10c", phase_pose_train, dev, root, tag)
        add(pose_train, train_launches)
        add(served, launches)
    with tempfile.TemporaryDirectory() as root:
        timed("10d", phase_pose_val, dev, root, states[POSE], confs[POSE])
    serve(OBB)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_obb_dataset(root, OBB_TRAIN, OBB_VAL)
        print(f"wrote the synthetic PNG OBB dataset ({OBB_TRAIN} train, "
              f"{OBB_VAL} val) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for batch in OBB_BATCHES:
            obb_train, served = timed("11c", phase_obb_train, dev, root, tag,
                                      batch)
            add(obb_train, train_launches)
            add(served, launches)
    with tempfile.TemporaryDirectory() as root:
        timed("11d", phase_obb_val, dev, root, states[OBB], confs[OBB])
    cls_launches, cls_forward, states[CLS] = timed("12a", phase_cls_slice,
                                                   dev)
    add(cls_launches, launches)
    for path, counts in cls_forward.items():
        for name in PATHS[path]:
            per_forward.setdefault(name, {})[path] = counts[name]
    add(timed("12b", phase_cls_cpu_match, dev, states[CLS]), launches)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_cls_dataset(root)
        print(f"wrote the synthetic PNG classify dataset ({CLS_CLASSES} "
              f"classes, {CLS_TRAIN} train and {CLS_VAL} val images each) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cls_train, served, best = timed("12c", phase_cls_train, dev, root,
                                        tag)
        add(cls_train, train_launches)
        add(served, launches)
        timed("12d", phase_cls_val, dev, root, best)
    add(timed("13", phase_stream, dev, states, confs), launches)
    with tempfile.TemporaryDirectory() as root:
        jpeg_served, jpeg_train = timed("14", phase_images, dev, root,
                                        states["v8"], confs["v8"], tag)
        add(jpeg_served, launches)
        add(jpeg_train, train_launches)
    t15 = time.perf_counter()
    add(timed("15a-c", phase_blocks, dev, tag), launches)
    add(timed("15d", phase_convert, dev, states["v8"], confs["v8"]),
        launches)
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root, 48, 8, seed=16)
        timed("15e", phase_profile, dev, root, tag)
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root, 16, 8, seed=17)
        timed("15f", phase_unported, dev, root)
    print(f"  (phase 15: {time.perf_counter() - t15:.1f} s wall)", flush=True)
    t16 = time.perf_counter()
    add(timed("16a", phase_mesh_serve, dev, states["v8"], confs["v8"], tag),
        launches)
    with train_root as root:
        add(timed("16b-d", phase_dp, dev, root, tag), train_launches)
        timed("16e", phase_graft, dev)
        print(f"  (phase 16: {time.perf_counter() - t16:.1f} s wall)",
              flush=True)
        int8_stats, int8_launches = timed("17", phase_int8, dev, root,
                                          states, confs, tag)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s", flush=True)

    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "flax", "yolosharp_tpu")
                     or m.startswith(("jax.", "flax.", "yolosharp_tpu.")))
    if foreign:
        raise SystemExit(f"the run imported JAX or the JAX package: {foreign}")
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": launches[name] + train_launches[name],
                 "launches_by_path": {"predict": launches[name],
                                      "train": train_launches[name]},
                 "launches_per_b32_forward": per_forward[name]}
        entry.update(stats[name])
        kernels.append(entry)
    for name, (src, replaces) in BWD_SOURCES.items():
        if not train_launches[name] or launches[name]:
            raise SystemExit(f"{name}: launched {train_launches[name]} times "
                             f"by the train phases and {launches[name]} by "
                             f"predict (want > 0 and 0)")
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": train_launches[name],
                 "launches_by_path": {"predict": 0,
                                      "train": train_launches[name]}}
        entry.update(bwd_stats)
        kernels.append(entry)
    # int8 is a predict-only route behind int8_predict, which only phase 17
    # sets: every other phase, train and predict alike, must leave it idle
    stray = {name: (launches[name], train_launches[name])
             for name in INT8_SOURCES
             if launches[name] or train_launches[name]}
    if stray:
        raise SystemExit(f"int8 kernels launched outside phase 17 "
                         f"(predict, train): {stray}")
    for name, (src, replaces) in INT8_SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": (int8_launches[name] + launches[name]
                              + train_launches[name]),
                 "launches_by_path": {
                     "predict": int8_launches[name] + launches[name],
                     "train": train_launches[name]}}
        entry.update(int8_stats[name])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

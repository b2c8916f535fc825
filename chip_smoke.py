#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nodey_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:
  1. device  — a CUDA card, its name and power limit, TF32 off;
  2. build   — every kernel library from nodey_tpu_torch/csrc, one nvcc per
               source, all started together;
  3. kernel  — the polyphase kernel against its plain PyTorch version on the
               card at the main paths' shapes (44.1->48 kHz on the 300 s
               track; the 635/504 pitch transposition on config 4's 300 s
               intermediate), 22.05->48 and 44.1->32 kHz, stereo, ragged
               last tile: max|diff| <= 2e-6;
  4. slice   — the 5-node stereo graph through the port's CLI on two 300 s
               44.1 kHz stereo s16 tracks (export to WAV), then a 10 s
               excerpt of the same graph in code rendered on the card and on
               the CPU: master max|diff| <= 2e-6, spectrum SNR >= 100 dB;
  5. times   — CUDA events after a warm-up: the polyphase kernel and its
               plain version at the 5-node path's shape, beside its bound,
               and the whole graph's device render as audio-seconds per
               device-second;
  6. wsola   — the WSOLA chain kernel against its plain version on the card:
               splice offsets bitwise on the 7 golden signals; at config 4's
               two 300 s shapes (K 11,820 and 7,507) every frame's choice
               against the plain scoring given the kernel's previous choice
               (a differing frame must be a near tie: float64 scores within
               1e-5 of the frame's max |score|, at most 0.1% of K) and the
               audio against the plain assembly of the same choices (2e-6);
               the chain's energy prologue against its plain version at both
               shapes (relative 1e-5);
  7. config4 — the config-4 graph (resample -> pitch +4 -> velocity 1.25
               keep_pitch) through the CLI on a 300 s 44.1 kHz stereo track,
               exported to WAV: length 11,519,994, finite, >= 2 launches of
               each kernel; a 10 s excerpt on the card and on the CPU: equal
               splice decisions, master max|diff| <= 2e-6;
  8. times   — CUDA events: the WSOLA kernel (prologue and chain) and its
               plain version at both shapes, its us per frame beside the
               serial floor (an estimate); the prologue alone and its plain
               version; the 635/504 resample (kernel, plain, conv1d);
               conv1d at 44.1->48 kHz; the config-4 render as audio-seconds
               per device-second, and one render under torch.profiler
               (device time by kernel, the device's idle share);
  9. pv-kernels — the phase-vocoder kernels against their plain versions on
               the card, at config 4's two PV shapes (K 35,460 and 22,520, on
               the main path's own data) and on the 7 golden signals: the
               phase path's synthesis planes >= 100 dB, with and without
               lock, and every bin with mag > 0 within a phasor error
               |kernel - plain| / mag <= 1e-3 (with the count of plane
               elements that are not bitwise the plain version's, as the
               prefix is associated otherwise, and a digest of the kernel's
               planes to hold two builds of it to each other); the lock kernel, fed the
               plain path's unlocked planes, within 2e-6 of the plain lock
               and bitwise it on finite inputs, there, at the streamed PV's
               two chunk shapes (the frames a step of each stage's stream
               plan at 16 s chunks, from the middle of its planes) and at
               the pitch stage's shape with silent, rising, flat and comb
               frames;
 10. config4-pv — config 4 with both tempo nodes on algorithm "pv" through
               the CLI on the 300 s track, exported to WAV: length
               11,519,994, finite, >= 2 launches of the phase-path kernel, 0
               of the lock kernel, >= 2 of the resampler; a 10 s excerpt on
               the card through the kernels and through the plain versions:
               master SNR >= 90 dB; on the card and on the CPU: equal shape,
               SNR >= 40 dB (the PV's own conditioning: the CPU's change for
               re moved by one ulp is printed beside it);
 11. config4-pv-options — the same graph with pv_transient on both nodes and
               preserve_formants on the pitch node, 300 s through the CLI:
               >= 2 launches of the lock kernel, 0 of the phase-path kernel,
               the length, finite;
 12. times   — CUDA events: both PV kernels and their plain versions at both
               shapes beside their bounds; the phase kernel's three passes
               (totals, carry, apply) by torch.profiler device time beside
               its whole call; the PV config-4 render as audio-seconds per
               device-second (rtf_config4_pv), and one render under
               torch.profiler.
 13. stream-kernel — config 4 streamed at 16 s chunks on phase 6's track
               (the graph's chunk steps driven by hand): every launch of the
               WSOLA kernel's chunk entry against the plain chunk chain on
               the same (x, head, k0, base, K): splices equal (or a float64
               near tie on at most 0.1% of the frames), body and tail_out
               within 2e-6; each stage's splices of all steps equal the
               offline chain kernel's (phase 6) over the whole clip;
 14. streamed — `run --stream --export` on the 300 s 5-node project and
               config 4, every chunk step under
               torch.cuda.set_sync_debug_mode("error"): masters of the
               offline card render's length (phases 4 and 7) within 3e-7 and
               2e-6, >= 1 resampler launch, >= 2 WSOLA kernel launches on
               config 4; then each graph exported again at 100 s and at
               300 s: the 300 s export's peak device memory no more than 2
               MiB above the 100 s export's, and below the offline render's;
 15. stream times — e2e_streamed_wav and e2e_streamed_timevariant: the wall
               RTF of three more exports each (WAV sinks, nothing
               instrumented), median, min and max, and the median export's
               stage budget; the chunk entry per launch at both stages'
               k_cap beside its bound and the plain chunk chain, and its time
               summed over the export's launches.
 16. wsola-table — the score-table kernel against wsola_score_table_plain
               on the card, on the 7 golden signals and on phase 6's two
               config-4 chains (K 11,820 and 7,507): differing entries each
               a float64 near tie (TIE_REL) on at most TIE_SHARE of the
               K*(seek+1) entries, the table bitwise the same at
               frames_per_step 1, 2 and 4, the walk kernel bitwise the plain
               walk and the composed plain walk (walk_table_segments_plain);
               against the chain kernel: F[k][bs[k-1]] == bs[k] but for
               near ties on at most TIE_SHARE of K, frame 0 exactly, and the
               plain assembly of the walk's splices within 2e-6 of the chain
               kernel's body where they agree. The walk kernel bitwise both
               plain walks on random tables (n_cand 661 and 721) and on
               tables with an entry outside [0, n_cand) planted on and off
               the walk's path (the pitch stage's too), at several segment
               lengths; walk_launches in the phase equal to the calls made.
               Times at both shapes: the kernel, the plain table, the
               library yardstick (chunked torch.bmm + argmax), the walk
               (queued, and as a caller sees it; by pass) and the plain walk,
               with bounds (the walk's: 8 bytes a frame, and the table read
               once);
 17. probes  — both step probes in both forms (the dma probe's windows
               by TMA bulk copies on mbarriers) against their plain outputs
               (exactly) at K 4096; tools.probes.wsola_step_overhead (bare
               and dma us per step by K-slope), the tool's forms by K-slope,
               beside the chain's us per frame; then
               `python -m nodey_tpu_torch.tools.ab_wsola_fps 30 8` in process:
               its whole output, fps 2 and 4 tables equal to fps 1, and a
               launch of each of its five kernels;
 18. resample-data — resample.resample_data (the polyphase kernel, the
               counterpart of resample_data_pallas) against its plain version
               (2e-6) at tests/test_pallas.py's shapes (44.1<->48 kHz, C 1
               and 2, 0.5 s) and at 48->44.1 kHz on 300 s stereo; then
               tools.probes.resample_ab at 48->44.1 and 44.1->48 kHz (kernel,
               plain, F.conv1d, 300 s stereo); the kernel alone at 48->44.1
               kHz in both register tiles beside its bound.
 19. stream-pv — config 4 with both tempo nodes on "pv", streamed at 16 s
               chunks on phase 6's track: driven by hand, every launch of the
               lock kernel and of the resampler inside every step within 2e-6
               of its plain version on its operands (the lock's launches
               bitwise it on finite inputs, and at the plans' frames a step,
               phase 9's chunk shapes), and the master through the kernels
               >= 90 dB against the same steps with the plain lock, and
               bitwise it where every lock launch had finite inputs
               (the resampler is held launch by launch only: the PV turns on
               the ulps by which its inputs move); then `run --stream --export`, every
               step under torch.cuda.set_sync_debug_mode("error"), plain and
               with pv_transient and preserve_formants: length 11,519,994,
               finite, one lock launch per PV stage step with frames, no
               phase-path launch; streamed vs offline on the 10 s excerpt at
               2 s chunks >= 40 dB on the card (the CPU's figure and the 300 s
               exports' printed beside it); a witness at 300 s by 30 s of
               output, printed: offline on the card vs on the CPU, and
               streamed vs offline on the CPU; whole-export device peaks at 100 s
               and 300 s within 2 MiB, below the offline PV render's; the lock
               per launch at both chunk shapes beside its bound and the plain
               lock, and the export's wall RTF (median of 3) and stage budget;
 20. realtime — `run --realtime` on a 10 s 5-node project: wall >= 0.98x the
               audio; the default (streamed) session's blocks >= 120 dB against
               Runner.preview() on the card, the whole-clip session's bitwise
               equal; first-block latency and underruns;
 21. chunked — render_chunked on the 300 s 5-node graph: master >= 130 dB
               against the offline render, the same length, its spectrum's
               frames the clip's and >= 100 dB against the offline spectrum's;
               resampler launches per chunk; peak device memory below the
               offline render's.
 22. configs-1-3 — BASELINE configs 1 (one mono track, gain 1.2, export)
               and 3 (two stereo tracks, gains 1.5 and 0.9, amix 0.6/0.4,
               export), as bench.py builds them, on bench.py's 300 s tones
               through the CLI: the length, finite, config 1 launching no
               kernel and config 3 the resampler twice, each launch within
               2e-6 of plain; each graph's device RTF by CUDA events; card
               vs CPU on 30 s clips (bench.py's clip length): config 1
               bitwise, config 3 within 2e-6;
 23. config2 — config 2 (split -> gains 0.8 and 1.4 -> bimix) through the
               CLI at 300 s; device RTF; card vs CPU at 30 s within 2e-6;
               `run --stream` at 16 s chunks, every step under the sync
               debug mode, within 3e-7 of the offline export, its
               whole-export device peak at 100 s and 300 s within 2 MiB and
               below the offline render's, its wall RTF (median of 3);
               render_chunked >= 130 dB against the offline render. Every
               resampler launch of the three paths (offline, streamed,
               chunked) within 2e-6 of plain on its operands, recorded
               without a sync and checked after the path's counts are read;
 24. config5 — config 5 (four tracks; split/gains/bimix, pitch -3, amix
               0.3/0.3/0.2/0.2, spectrum) in preview mode through the CLI at
               300 s: clamped, 6 resampler launches each within 2e-6 of
               plain, the WSOLA chain at the 44.1 kHz geometry (seq 1,764,
               seek 660, overlap 352) held as in phase 6 and its energy
               prologue; device RTF; card vs CPU at 30 s within 2e-6,
               spectrum >= 100 dB; `run --stream` (the pitch branch keeps
               the clip's duration, so the graph streams in lockstep) under
               the sync debug mode within 2e-6 of the offline export, every
               resampler launch inside its steps within 2e-6 of plain and
               every launch of the chain's chunk entry held as in phase 13,
               the splices of all steps equal to the offline chain's; the
               37/44 transposition (kernel, plain, conv1d) and the chain at
               this geometry (kernel, plain) beside their bounds.
 25. config6 — BASELINE-extension config 6 (bench.py:209-237: one 48 kHz
               stereo track -> audio_eq with ls +3, p2 -4, hs +2 dB ->
               audio_compressor -18 dB 4:1 -> audio_limiter -1 dB -> export)
               on bench.py's 300 s tone through the CLI: the length, finite,
               no launch of any kernel (48 kHz in and out: no resampler, no
               stretch), no master sample above 10^(-1/20) x (1 + 1e-5); the
               limiter op where it acts (the 30 s track x4) within that
               ceiling and within 3e-7 of the CPU's; the device RTF by CUDA
               events, its device peak and one render under torch.profiler;
               card vs CPU at 30 s >= 100 dB; `run --stream` under the sync
               debug mode >= 88 dB against the offline export, whole-export
               device peaks at 100 s and 300 s within 2 MiB and below the
               offline render's, and its wall RTF (median of 3).
 26. masterbus-nodes — graph A (the tone with a 6.5 kHz burst and a
               passage 50 dB down, 30 s -> audio_filter highpass 80 Hz ->
               audio_gate -> audio_deesser -> audio_normalize LUFS -14 ->
               export): card vs CPU >= 90 dB, integrated loudness within
               0.1 LU of -14; its `run --stream` takes the offline path
               (normalize refuses the stream plan), bitwise the offline
               export. Graph B (graph A without normalize): `run --stream`
               streams, >= 90 dB against its offline export. The bitwise
               passthroughs on the card: a flat EQ, the limiter, compressor
               and de-esser below threshold, the gate above it.
 27. config7 — BASELINE-extension config 7 (bench.py:240-253: one 48 kHz
               stereo track -> audio_reverb decay 1.8 s, wet 0.35 -> export)
               on phase 25's 300 s tone through the CLI: length 14,487,359
               (the 87,360-sample IR's tail), finite, no launch of any
               kernel; the device RTF by CUDA events (median of 5), its
               device peak and one render under torch.profiler; card vs CPU
               at 30 s >= 100 dB; `run --stream` under the sync debug mode
               >= 90 dB against the offline export at its length,
               whole-export device peaks at 100 s and 300 s within 2 MiB and
               below the offline render's, its wall RTF (median of 3);
               render_chunked (30 s windows) >= 110 dB against the offline
               render, the same length, a lower device peak.
 28. channel-strip — (a) examples/projects/channel_strip.json on the 300 s
               tone through the CLI (the reverb's tail, finite, no launch);
               card vs CPU at 30 s >= 90 dB; its `run --stream` takes the
               offline path (normalize), bitwise the offline export. (b)
               examples/channel_strip.py's chain (gate, EQ, compressor,
               phaser, width, pan, delay, reverb, fade, limiter) rebuilt from
               the port's processor_map with the script's parameters, 300 s:
               grown by the delay's and the reverb's tails; `run --stream`
               >= 88 dB against its offline export, peaks at 100 s and 300 s
               flat, wall RTF (median of 3). (c) the 30 s tone through
               tremolo (5 Hz, 0.5) and chorus (defaults): card vs CPU >= 95
               dB, streamed within 3e-7 of offline. The bitwise passthroughs
               on the card: reverb, delay, phaser and chorus at wet 0 with
               dry 1, tremolo at depth 0, width 1, pan 0, a fade with no
               ramp.
 29. timeline — (a) examples/projects/crossfade_splice.json (a 1.5 s
               equal-power splice at 2.0 s) on two 300 s 48 kHz stereo s16
               tones (220 and 330 Hz, seeds 10 and 11) through the CLI: the
               length, finite, no launch; the device RTF by CUDA events
               (median of 5); card vs CPU at 30 s and `run --stream` (16 s
               chunks, the sync debug mode) vs the offline export: bitwise
               outside the window, within 3e-7 inside it; whole-export
               device peaks at 100 s and 300 s within 2 MiB and below the
               offline render's; the wall RTF (median of 3) and stage
               budget. (b) a graph with no audio file: generator (noise, seed
               7, -12 dB, 300 s) -> trim (10 s to 250 s) -> output: exactly
               240 s of samples, bitwise the numpy mirror of the noise hash
               at those positions, `run --stream` bitwise the offline export;
               the same graph on the sine, card vs CPU >= 130 dB. (c) the
               300 s 44.1 kHz track and a 48 kHz triangle generator -> amix:
               chunk widths 705,600 and 768,000 (one 16 s quantum),
               `run --stream` within 3e-7 of the offline export, every
               resampler launch of both paths within 2e-6 of plain. (d) the
               300 s 48 kHz track -> reverse: the render bitwise the card's
               flip of the decoded input; export_streamed falls back offline,
               bitwise the offline export, its progress monotone up to 300
               audio-s; a stop() from the first progress call raises
               RunCancelled, leaves no file and the runner READY, and the
               same runner then exports in full.
 30. batch   — batched serving, CompiledGraph.run_batch: (a)
               rtf_batch8_serving (bench.py:1779-1826): the 5-node graph on
               two 30 s tracks, decoded and compiled by Runner, broadcast to
               8 clips and uploaded once, run_batch back to back: the median
               of 10 calls by CUDA events, RTF = 240 audio-s over it; (b)
               config 4 on WSOLA, on the PV, and on the PV with pv_transient
               and preserve_formants, each on 8 x 30 s clips (bench.py's tone
               at seeds 20-27 and other pitches): run_batch beside eight
               single renders of the same clips; (c) each clip against its
               own single render: masters bitwise (the PV's >= 90 dB), the
               spectrum within 2e-6 of its largest value, WSOLA splices
               equal, lengths equal, tails zero; (d) one batch of 30, 21.3
               and 9.7 s clips in one 30 s capacity, the same checks; (e)
               every batched launch of the resampler (2e-6), the WSOLA chain
               (check_chain per clip) and its prologue (1e-5 relative), the
               phase path (>= 100 dB) and the lock (2e-6, bitwise on finite
               inputs) against its plain version on its operands, and each
               kernel's batched time beside its bound (the chain also beside
               one clip alone); (f) each batched render launches each
               kernel as often as one clip's render; (g) a graph with a node
               that has no batched lowering (the delay, its own taken away)
               makes run_batch raise before any launch.
 31. batch-configs — run_batch on BASELINE configs 2, 5 (preview), 6 and
               7, each on 8 x 30 s clips of different content (bench.py's
               tone at seeds 30-37 and other pitches; config 5's four inputs
               each their own; in config 6 the second clip 40 dB down), decoded
               and compiled by Runner: each clip bitwise its own single
               render (master or preview, spectrum, length, a zero tail);
               each batch launching each kernel as often as one clip's
               render; every batched resampler launch within 2e-6 of plain,
               config 5's chain (check_chain per clip, near ties on at most
               0.1% of a clip's frames or one, splices equal to the single
               renders') and its prologue (1e-5 relative); each batch
               beside eight single renders of the same clips (CUDA events,
               the median of back-to-back calls on inputs uploaded once;
               config 7's both under torch.profiler too); config 5's
               batched transposition (kernel, plain, conv1d) and chain
               beside their bounds; the scan and DFT GEMMs and the loudness
               gate's sums folded over the clips vs clip by clip (times, and
               whether bitwise). Then, checked bitwise only: config
               6 on clips of 30, 21.3 and 9.7 s in one capacity; graph A on
               8 sibilant clips, the second 40 dB down; the peak graph (44.1
               kHz -> resample 48 kHz -> gain 4 -> limiter -1 dB -> normalize
               peak -3 dBFS), the second clip 40 dB down; split -> bimix_v2.
 32. batch-effects — run_batch on the eleven node types that configs 1-7
               do not hold, each graph on 8 x 30 s clips (bench.py's tone at
               seeds 40-47, the second input's at 50-57) decoded and
               compiled by Runner, beside eight single renders of the same
               clips (CUDA events, the median of back-to-back calls on
               inputs uploaded once): (a) examples/channel_strip.py's chain
               (gate, EQ, compressor, phaser, width, pan, delay 240 ms /
               0.35, reverb 1.2 s, fade, limiter); (b) tremolo -> chorus;
               (d) examples/projects/crossfade_splice.json on 8 pairs of
               clips; (f) a 44.1 kHz input and a 48 kHz triangle generator
               (30 s) -> amix 0.6 / 0.4, its batched resampler launch (the
               clips folded into rows) within 2e-6 of plain and timed
               beside its bound, the plain version and F.conv1d. Checked
               bitwise only, on clips of 30, 21.3 and 9.7 s in one capacity:
               (c) every channel node in one chain, the fade anchored at
               each clip's own end; (e) trim (1 s to 25 s) -> reverse. For
               each, every clip bitwise its own single render (master,
               length, a zero tail) and the batch launching each kernel as
               often as one clip's render. (g) generator -> output: run_batch
               refuses it (no external input) before any launch or
               allocation.
 33. serve   — the web editor's server (nodey_tpu_torch.app.server) on the
               card, in process on 127.0.0.1:0, serving phase 4's 300 s
               project: GET /api/graph and /api/registry; /api/edit/set of
               the mix's volumes (0.6 / 0.4) and /api/save; POST /api/export
               to WAV, /api/state polled every 5 ms until it finishes (a
               poll must show the stage gauges): the file bitwise `run
               --export --stream --device cuda` of the saved project,
               launching the resampler kernel as often, and neither calling
               the resampler's plain version; then three more of each in
               turns, their wall RTF; /api/preview.wav?start=1 on the
               10 s tracks read to EOF: bitwise a StreamingSession's blocks on
               the card as s16, at >= 0.98x wall, with the time to the first
               audible block and the underruns; /api/stop once the export
               has written audio: the state "stopped", no partial file.
               Then `run --diagnostics --profile-nodes --trace` on the 10 s
               project (six nodes profiled; kernel events in the trace) and
               `doctor --device cuda` (exit code 0).
 34. mesh    — nodey_tpu_torch.parallel on a virtual mesh (every shard on
               the card; the card's machine shows one device): (a) the
               5-node graph on phase 4's 300 s tracks at sp 4
               (compile_graph_sharded): master and spectrum bitwise the
               single render, 2 x 4 resampler launches each within 2e-6
               of plain; (b) dp 2 x sp 4 over 8 clips of 30 s: every clip
               bitwise its single render, 16 launches; (e)
               run_batch(mesh=dp 4) bitwise run_batch, 4x its launches;
               (c) compile_graph_dp of the JAX dry run's chain
               (__graft_entry__.py:191-282: resample, pitch +3, velocity
               1.25, EQ, chorus, phaser, tremolo, width, limiter) on WSOLA,
               the PV and the PV with its options, dp 4, 8 clips of 30 s:
               every clip bitwise its single render, dp x one clip's
               launches, every chain (check_chain), prologue, phase-path,
               lock and resampler launch against its plain version; (d)
               compile_chain_sp_tv of that chain on the PV, sp 4: on 0.8 s
               (tests/test_tv_sharded.py's shape) > 45 dB against the
               single render; on 300 s > 40 dB (PV_DEVICE_DB) and within 3
               dB of the single render's own float32 determinism (the
               single render with the plain phase path against it), 8
               lock and 8 resampler launches each against plain, no phase
               path; each sharded render's time beside the single
               render's (CUDA events: on a virtual mesh, what the shards
               add, not scaling); (f) with more than one card, (a) and (b)
               again over the real devices, else a line that says only
               the virtual mesh ran.
 35. tp      — nodey_tpu_torch.parallel.tp and dp_sp_tp on a virtual mesh
               of the card: (a) config 7's reverb convolution (decay 1.8 s,
               pre-delay 20 ms) on 300 s of 48 kHz stereo (F 4,096, 2,049
               bins) at tp 2 and tp 4. tests/test_tp.py's bar (130 dB and
               1e-6 of the peak against the unsharded conv) cannot hold
               on the card, where the unsharded conv is itself only 116.3
               dB (max|error| 7.275e-06 of the peak) from the float64
               convolution. So each render is held against the float64
               convolution: at most TP_SLACK_DB (1 dB) below the
               unsharded conv's SNR and within TP_MAXABS_FACTOR (2x) of
               its max|error| (read on an H100 at 700 W: tp 2 115.8 dB,
               8.518e-06; tp 4 120.4 dB, 4.492e-06); no launch of a kernel
               of ours; each timed beside the unsharded conv (CUDA
               events). (b) compile_flagship_reverb_dpsptp of the 5-node
               graph over dp 2 x sp 2 x tp 2, 8 clips of 30 s of
               different lengths: every clip's length the card's
               reference_pipeline's, and every clip and its
               reference_pipeline against the same pipeline in float64
               after the single render: the clip at most TP_SLACK_DB
               below its reference's SNR and within TP_MAXABS_FACTOR of
               its max|error| (read: worst clip 126.2 dB and 1.657e-06,
               worst reference 123.6 dB); 2 x 2 x 2 resampler launches
               each within 2e-6 of plain; timed beside the 8 reference
               pipelines.
 36. dcn     — launch_dcn_dryrun(2, 2) on the card: two processes joined
               over gloo, two shards of cuda:0 each, one sp mesh of four;
               the JAX dry run's 5-node LTI graph with the resampler's
               halos crossing processes through host memory; each
               process's shards BITWISE the single render and the
               one-process sp render (as phase 34's sp render is), every
               wrapper's launches in its first step (the resampler's 2
               inputs x 2 shards; the counts it reports are the kernels' of
               the two dcn paths in the kernels line), the bytes it sent
               and its step's wall time; the same windows in this process
               with every resampler launch against plain. Where the codec
               runtime does not load (the card's machine): compat="swr"
               raises ProcessorRuntimeError and launches nothing, `run
               --swr-compat` exits non-zero, an MP3 export raises (MP3 has
               no card path; printed); where it loads, compat="swr" >= 90
               dB against swr_convert.
Each path's launch counts are set to 0 just before it runs and read just
after (phases 17-18's paths: the step-overhead measurement, the A/B tool,
the resampler's A/B; phases 19-21's: the streamed PV exports, the realtime
preview, the chunked render; phases 22-24's: each config's CLI render, the
streamed exports of configs 2 and 5, config 2's chunked render; phases
25-29's: each graph's CLI render and streamed export, config 7's chunked
render, reverse's fallback exports; phase 30's: each batched render, and
the refused one; phases 31-32's: each batched render, and phase 32's
refused one; phase 33's: the served export, the CLI's export it is held
to, the served preview, the stopped export, the diagnostics run and
doctor; phase 34's: each sharded, dp and meshed render; phase 35's: each
tp conv and the dp x sp x tp render; phase 36's: the one-process render of
the dry run's windows and, in each process of the dry run, its step). Streamed
exports that phases 14 and 22-29 repeat at 100 s and 300 s also print
each export's host RSS (sampled every 5 ms): its rise above its start at
300 s must stay within 64 MiB of the one at 100 s. The
line before the last is one JSON object describing the kernels; the last
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = "cuda"                    # the device the port renders on
TOL = 2e-6
SNR_DB = 100.0
SECONDS = 300
EXCERPT_SECONDS = 10
RATE = 44_100
PITCH = 4.0                      # config 4's pitch_modifier, semitones
VELOCITY = 1.25                  # config 4's velocity_modifier, keep_pitch
# Config 4's valid lengths for one 300 s track (the JAX package's formulas):
# 13,230,000 -> 14,400,000 (48 kHz) -> 18,142,848 (tempo 2^(-1/3)) ->
# 14,399,993 (635/504) -> 11,519,994 (tempo 1.25).
CONFIG4_LENGTH = 11_519_994
CONFIG4_FRAMES = (11_820, 7_507)
CONFIG4_PV_FRAMES = (35_460, 22_520)   # the phase vocoder's K, both stages
PV_PLANE_DB = 100.0
PV_PHASOR_TOL = 1e-3
PV_EXCERPT_DB = 90.0
PV_PASSES = ("totals", "carry", "apply")  # the phase-path kernel's launches
WALK_PASSES = ("maps", "carry", "emit")     # the walk kernel's launches
WALK_SEG = 64                    # phase 16's random and planted tables are
                                 # cut around this segment length
# Card vs CPU on the PV excerpt. The two differ in the analysis GEMMs and in
# atan2/cos/sin by ulps, and a steady tone's sidelobe bins sit where the
# phase wrap is decided by such ulps, so the PV output itself moves by tens
# of dB: phase 10 prints the CPU's own change for re moved by one ulp.
PV_DEVICE_DB = 40.0
TIE_REL = 1e-5                   # a differing choice must be this near a tie
TIE_SHARE = 1e-3                 # ... on at most this share of the frames
# The WSOLA energy prologue against its plain version (conv1d of the squared
# window): two float32 sums of C*overlap squares in different orders.
ENERGY_REL = 1e-5
# One FFMA's latency on this card, in cycles (an estimate for the chain's
# serial floor: C*overlap dependent FFMAs per frame).
FFMA_LATENCY_CYCLES = 4
# (in_rate, out_rate, samples): the two main-path pairs first.
MAIN_CAPACITY = -(-RATE * SECONDS // 65_536) * 65_536  # Runner._bucket
KERNEL_PAIRS = [
    (44_100, 48_000, MAIN_CAPACITY),
    (635, 504, 18_155_904),  # config 4's pitch-stage WSOLA output width
    (22_050, 48_000, 22_050 * EXCERPT_SECONDS + 4_321),
    (44_100, 32_000, 44_100 * EXCERPT_SECONDS + 4_321),
]
GOLDEN_CASES = [
    (48_000, 0.8), (48_000, 1.25), (48_000, 2.0), (48_000, 1.1037),
    (44_100, 0.8), (44_100, 1.25), (44_100, 2.0),
]
# Streaming (phases 13-15): export_streamed's chunk length, the 5-node
# mix's streamed == offline bar (the JAX package's), the short clip of the
# memory check, and how far the 300 s export's device peak may exceed the
# 100 s export's: 2 MiB, a third of one 16 s master block (a buffer that
# grew with the clip would add 0.37 MiB per audio-second, one a step kept
# alive 6 MiB per step).
STREAM_CHUNK_SECONDS = 16
STREAM_MIX_TOL = 3e-7
SHORT_SECONDS = 100
STREAM_SLACK_BYTES = 2 * 2**20
RSS_SLACK_BYTES = 64 * 2**20     # a streamed export's host RSS, 300 s vs 100 s
STREAM_TIMED_RUNS = 3
# Phase 19: the streamed PV's 10 s excerpt against its offline render at 2 s
# chunks (so the carries cross chunk boundaries), and the lock's inputs of
# which launch per chunk shape are timed (a mid-clip step of 19).
STREAM_EXCERPT_CHUNK_SECONDS = 2
STREAM_LOCK_TIMED_STEP = 9
# Launches of the lock kernel timed at each chunk shape (queued behind a spin
# of the card: its wrapper's host time exceeds the kernel's there).
LOCK_TIMED_LAUNCHES = 200
# Phases 16-18: the A/B tool's arguments (python -m
# nodey_tpu_torch.tools.ab_wsola_fps 30 8), the probes' step count for their
# checks and times (bench.py's larger K), tests/test_pallas.py's rate pairs.
TOOL_ARGS = ["30", "8"]
PROBE_STEPS = 4096
RESAMPLE_DATA_PAIRS = [(44_100, 48_000), (48_000, 44_100)]
# Phases 22-24: BASELINE configs 1, 2, 3 and 5. bench.py's config clips are
# 30 s (bench.py:1312): the card-vs-CPU checks run on them. Config 5's pitch
# node and the WSOLA geometry at 44.1 kHz (seq, seek, overlap).
CONFIG_CHECK_SECONDS = 30
CONFIG5_PITCH = -3.0
CONFIG5_GEOMETRY = (1_764, 660, 352)
MASTER_RATE = 48_000             # config 6 and phase 26 read and write 48 kHz
LIMITER_DB = -1.0                # config 6's limiter threshold
CONFIG6_CARD_CPU_DB = 100.0
CONFIG6_STREAM_DB = 88.0         # tests/test_biquad.py:131, the EQ's bar
GRAPH_A_DB = 90.0                # tests/test_deesser.py:64, the de-esser's
LUFS_TARGET = -14.0
LUFS_TOL = 0.1                   # tests/test_loudness.py:88
# Phases 27-28: config 7 (bench.py:240-253) and the channel strips.
CONFIG7_IR = 87_360              # round(1.8 s * 48 kHz) + 20 ms pre-delay
CONFIG7_CARD_CPU_DB = 100.0
CONFIG7_STREAM_DB = 90.0         # tests/test_reverb.py:154
CONFIG7_CHUNKED_DB = 110.0       # tests/test_reverb.py:179
STRIP_CARD_CPU_DB = 90.0         # phase 26's bar for a graph with normalize
STRIP_STREAM_DB = 88.0           # the EQ's streamed bar, the weakest link
MODFX_CARD_CPU_DB = 95.0         # tests/test_modfx.py:82, the chorus's
MODFX_STREAM_TOL = 3e-7          # tests/test_modfx.py:107
# Phase 29: the timeline nodes. The splice's in-window bar is the JAX
# package's across-program one (tests/test_crossfade.py:137-160).
SPLICE_TOL = 3e-7
GENERATOR_SINE_DB = 130.0
TRIM_SPAN = (1 / 30, 5 / 6)      # of the clip: 10 s to 250 s of 300 s
BATCH = 8                        # phase 30: rtf_batch8_serving's clips
BATCH_SECONDS = 30               # ... of bench.py's 30 s each
BATCH_ITERS = 10                 # timed run_batch calls (median)
BATCH_SPECTRUM_REL = 2e-6        # a batched clip's spectrum vs its single
BATCH_PV_DB = 90.0               # a batched PV clip vs its single render
BATCH_LENGTHS_S = (30.0, 21.3, 9.7)  # phase 30 (d): one capacity, 3 lengths
BATCH_SEED = 30                  # phase 31's clips: bench tones, seeds 30-
BATCH_QUIET = 10.0 ** (-40 / 20)  # ... its second clip's scale, -40 dB
PEAK_DB = -3.0                   # phase 31's peak graph: normalize target
# Phase 34: the mesh. A virtual mesh puts every shard on the one card: sp 4
# for the 5-node graph on phase 4's tracks, dp 2 x sp 4 over 8 clips of
# 30 s, dp 4 for compile_graph_dp and run_batch(mesh=), sp 4 for the PV
# chain; its bar is tests/test_tv_sharded.py's for two PV stages in series,
# on that test's 0.8 s (at 300 s the chain is held at PV_DEVICE_DB).
MESH_SP = 4
MESH_DP = 2
MESH_DP_WIDE = 4
MESH_SP_TV = 4
MESH_CLIPS = 8
MESH_CLIP_SECONDS = 30
MESH_TV_DB = 45.0
MESH_TV_SECONDS = 0.8
MESH_TV_OWN_DB = 3.0
TP_SIZES = (2, 4)                # phase 35: the tp conv's shard counts
TP_ITERS = 3
# Phase 35's bar. tests/test_tp.py holds a tp conv at 130 dB and 1e-6 of
# the peak against the unsharded conv, but on the card the unsharded conv
# itself is only ~116 dB from the float64 convolution on the 300 s tone
# (cuBLAS's float32 sums, measured on an H100), so two float32 renders
# cannot agree to 130 dB. Each is held against float64 instead: the
# sharded render no more than TP_SLACK_DB below the unsharded one's SNR
# and within TP_MAXABS_FACTOR of its max|error|. Set from these readings
# (H100 80GB HBM3, 700 W): unsharded 116.3 dB and 7.275e-06 of the peak,
# tp 2 115.8 dB and 8.518e-06, tp 4 120.4 dB and 4.492e-06; the tightest
# margins are tp 2's 0.5 dB and 1.17x. cuBLAS picks the same algorithm for
# the same shapes, and every run read these same figures.
TP_SLACK_DB = 1.0
TP_MAXABS_FACTOR = 2.0
DCN_PROCESSES = 2                # phase 36: processes x shards each
DCN_LOCAL = 2
DCN_TIMEOUT = 300.0
SWR_DB = 90.0                    # compat="swr" against swr_convert
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = False):
    """Milliseconds of each of ``iters`` back-to-back calls by CUDA events,
    after ``warmup`` calls. ``queued``: the card first spins for ~0.1 ms a
    call (torch.cuda._sleep), so the calls queue up behind it and the events
    time the device work alone, where a call's host time (a wrapper's tens
    of us) would exceed it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    if queued:
        torch.cuda._sleep(max(10**7, 200_000 * iters))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


@contextlib.contextmanager
def host_rss(out: dict):
    """Inside the block a thread samples this process's RSS every 5 ms;
    ``out`` gets the RSS before the block ("base") and the largest sample
    ("peak"), in bytes. An export's rise, peak - base, is what it holds on
    the host, whatever earlier phases left resident."""
    import threading

    from nodey_tpu_torch.core.stream_executor import _rss_bytes

    done = threading.Event()
    out["base"] = out["peak"] = _rss_bytes()

    def sample():
        while not done.wait(0.005):
            out["peak"] = max(out["peak"], _rss_bytes())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        done.set()
        thread.join()
        out["peak"] = max(out["peak"], _rss_bytes())


def rss_text(rss: dict) -> str:
    """Host RSS of the exports at SHORT_SECONDS and SECONDS (host_rss)."""
    return "; ".join(
        f"{(r['peak'] - r['base']) / 2**20:.1f} MiB above its start at "
        f"{seconds} s (peak {r['peak'] / 2**20:.1f})"
        for seconds, r in sorted(rss.items()))


def rss_rise(rss: dict, seconds: int) -> int:
    return rss[seconds]["peak"] - rss[seconds]["base"]


def settle_host_heap() -> None:
    """Collect garbage and hand the freed heap back to the system
    (glibc's malloc_trim, where it is there), so that the host RSS an export
    samples at its start is what is alive, not what earlier phases freed."""
    import ctypes
    import ctypes.util
    import gc

    gc.collect()
    libc = ctypes.util.find_library("c")
    if libc:
        with contextlib.suppress(OSError, AttributeError):
            ctypes.CDLL(libc).malloc_trim(0)


def device_peak(fn) -> int:
    """Bytes of device memory allocated at the peak of ``fn()`` above what
    was allocated before it (garbage collected first, so no earlier tensor
    is freed during ``fn``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def summary(times):
    """(median, min, max, count) of a list of milliseconds."""
    times = sorted(times)
    return times[len(times) // 2], times[0], times[-1], len(times)


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` FP32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def resample_work_bound(x, G: int, M: int, bank):
    """The polyphase resampler's bound on these inputs: x and the bank read
    once, y written once; 2 flops for each of the taps a phase really has
    (not the dense W-wide window)."""
    from nodey_tpu_torch.ops import resample as tr

    C, L = x.shape[0], bank.shape[0]
    taps = tr._effective_taps(L, M, tr.DEFAULT_TAPS)
    return bound(4 * (x.numel() + bank.numel() + C * G * L),
                 2 * taps * C * G * L)


def time_resampler(tag: str, label: str, fns: dict, order, iters: int,
                   card: str, work_bound):
    """Median ms of each of ``fns`` (timed in ``order``, CUDA events),
    printed, the kernels' beside ``work_bound``; returns the medians by
    name."""
    runs = {name: [] for name in fns}
    for name in order:
        runs[name] += cuda_ms(fns[name], iters)
    for name in fns:
        med, lo, hi, count = summary(runs[name])
        share = (f"; the bound {work_bound[0]:.4f} ms by {work_bound[1]} is "
                 f"{work_bound[0] / med:.2%} of it"
                 if name.startswith("kernel") else "")
        print(f"[{tag}] {label}, {name}: median {med:.4f} ms (min {lo:.4f}, "
              f"max {hi:.4f}, n={count}){share} ({card})")
    return {name: summary(runs[name])[0] for name in fns}


def snr_db(reference, test) -> float:
    import numpy as np

    reference = np.asarray(reference, dtype=np.float64)
    noise = reference - np.asarray(test, dtype=np.float64)
    denom = float(np.sum(noise ** 2))
    if denom == 0.0:
        return math.inf
    return 10.0 * math.log10(float(np.sum(reference ** 2)) / denom)


def make_signals(seconds: int, seed: int = 0):
    """Two 44.1 kHz stereo tracks [2, n] float32: tones plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = RATE * seconds
    t = np.arange(n, dtype=np.float64) / RATE
    return [
        np.stack([
            0.35 * np.sin(2 * np.pi * 220.0 * (i + 1) * t)
            + 0.1 * rng.standard_normal(n),
            0.3 * rng.standard_normal(n),
        ]).astype(np.float32)
        for i in range(2)
    ]


def golden_signal(rate: int):
    """The WSOLA goldens' seeded signal (tests/make_wsola_goldens.py)."""
    import numpy as np

    n = int(rate * 1.2)
    t = np.arange(n, dtype=np.float64) / rate
    sig = (
        0.35 * np.sin(2 * np.pi * 220.0 * t)
        + 0.2 * np.sin(2 * np.pi * 513.0 * t + 0.7)
        + 0.1 * np.sin(2 * np.pi * 1877.0 * t + 1.3)
    )
    rng = np.random.default_rng(20260817)
    noise = 0.05 * rng.standard_normal((2, n))
    return (np.stack([sig, sig * 0.85]) + noise).astype(np.float32)


def write_tracks(directory: str, signals, tag: str):
    """The signals as s16 WAVs; returns their paths."""
    from nodey_tpu_torch.host.decode import write_wav_s16

    paths = []
    for i, data in enumerate(signals):
        path = os.path.join(directory, f"track_{i + 1}_{tag}.wav")
        write_wav_s16(path, data, RATE)
        paths.append(path)
    return paths


def _pin(g, n, p):
    return g.nodes[n].pin_name_map[p]


def flagship_graph(paths, volume=1.5, mix=(0.6, 0.4)):
    """The 5-node graph as __graft_entry__._flagship_graph builds it, with
    the port's processors."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.audio_vol import AudioVol
    from nodey_tpu_torch.processors.spectrum import AudioSpectrum

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.set_volume(volume)
    amix = g.add_node(AudioAmix())
    g.nodes[amix].processor.set_input_num(2)
    g.nodes[amix].processor.volumes = list(mix)
    spec = g.add_node(AudioSpectrum())
    out = g.add_node(AudioOutput())
    g.add_link(_pin(g, src, "output_0"), _pin(g, vol, "input"))
    g.add_link(_pin(g, vol, "output"), _pin(g, amix, "input_1"))
    g.add_link(_pin(g, src, "output_1"), _pin(g, amix, "input_2"))
    g.add_link(_pin(g, amix, "output"), _pin(g, spec, "input"))
    g.add_link(_pin(g, spec, "output"), _pin(g, out, "input"))
    return g


def config4_graph(path, algorithm="wsola", transient=False, formants=False):
    """BASELINE config 4 as bench.py:172-192 builds it, with the port's
    processors: resample 48 kHz -> pitch +4 -> velocity 1.25 keep_pitch.
    ``algorithm`` sets both tempo stages (with "pv", ``transient`` sets
    pv_transient on both nodes and ``formants`` preserve_formants on the
    pitch node, as bench.py's rtf_config4_pv variants do)."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.velocity import PitchModifier, VelocityModifier

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    rs = g.add_node(AudioResample())
    g.nodes[rs].processor.set_target_rate(48_000)
    pitch = g.add_node(PitchModifier())
    g.nodes[pitch].processor.pitch = PITCH
    vel = g.add_node(VelocityModifier())
    g.nodes[vel].processor.set_velocity(VELOCITY)
    g.nodes[vel].processor.keep_pitch = True
    out = g.add_node(AudioOutput())
    g.add_link(_pin(g, src, "output_0"), _pin(g, rs, "input"))
    g.add_link(_pin(g, rs, "output"), _pin(g, pitch, "input"))
    g.add_link(_pin(g, pitch, "output"), _pin(g, vel, "input"))
    g.add_link(_pin(g, vel, "output"), _pin(g, out, "input"))
    for node in (pitch, vel):
        processor = g.nodes[node].processor
        processor.set_algorithm(algorithm)
        processor.pv_transient = transient
    g.nodes[pitch].processor.preserve_formants = formants
    return g


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from nodey_tpu_torch.ops import cuda_probes, cuda_pv, cuda_resample
    from nodey_tpu_torch.ops import cuda_wsola, cuda_wsola_table

    cuda_resample.launches = 0
    cuda_wsola.launches = 0
    cuda_wsola.energy_launches = 0
    cuda_pv.phase_path_launches = 0
    cuda_pv.lock_launches = 0
    cuda_wsola_table.table_launches = 0
    cuda_wsola_table.walk_launches = 0
    cuda_probes.bare_launches = 0
    cuda_probes.dma_launches = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from nodey_tpu_torch.ops import launch_counts

    return launch_counts()


def cli_export(cli, project: str, out_wav: str, tag: str, card: str,
               shape=(2, CONFIG4_LENGTH), flag: str = "--export",
               seconds=None):
    """Render ``project`` through the port's CLI on the card into
    ``out_wav`` (``flag``: "--export", or "--preview" for the preview
    render), launch counts set to 0 just before; checks the master's
    ``shape`` and that it is finite; returns (master, launches by
    kernel)."""
    import numpy as np

    from nodey_tpu_torch.host.decode import decode_file

    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["run", project, flag, out_wav, "--device", CARD])
    counts = read_counts()
    print("\n".join(f"[{tag}] cli: {line}"
                    for line in stdout.getvalue().splitlines()))
    check(rc == 0, f"{tag}: cli run exited {rc}")
    master = decode_file(out_wav).data
    print(f"[{tag}] {seconds or SECONDS} s {flag[2:]}: master "
          f"{list(master.shape)}, "
          f"finite {bool(np.isfinite(master).all())}; launches {counts} "
          f"({card})")
    check(master.shape == tuple(shape),
          f"{tag}: master {master.shape}, want {tuple(shape)}")
    check(bool(np.isfinite(master).all()), f"{tag}: master not finite")
    return master, counts


def pv_operands(data, tempo: float, rate: int):
    """``(re, im, dpos, hop, n_fft)``: the analysis planes and geometry that
    ``pv._pv_impl`` hands the phase path for ``data`` [C, N]."""
    from nodey_tpu_torch.ops import pv

    n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(data.shape[1], tempo, rate)
    re, im = pv._analysis(data, pos, pad_to, n_fft)
    return re, im, dpos, hop, n_fft


def plane_snr_db(reference, test) -> float:
    """SNR of a plane on the card, summed in float64 on the card."""
    reference = reference.double()
    noise = float(((reference - test.double()) ** 2).sum())
    if noise == 0.0:
        return math.inf
    return 10.0 * math.log10(float((reference ** 2).sum()) / noise)


def check_pv(tag: str, operands, card: str):
    """Both PV kernels against their plain versions on ``operands`` (from
    pv_operands). Returns ({"abs": worst max|diff| of the phase path,
    "lock": the lock's}, the lock's inputs: the plain path's unlocked
    phasors, phases and magnitudes)."""
    import torch

    from nodey_tpu_torch.ops import cuda_pv, pv

    re, im, dpos, hop, n_fft = operands
    mag, ph = pv._magnitude_phase(re, im)
    live = mag > 0
    worst = 0.0
    for lock in (True, False):
        ry, iy = cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)
        pry, piy = pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)
        torch.cuda.synchronize()
        snr = min(plane_snr_db(pry, ry), plane_snr_db(piy, iy))
        phasor = (torch.hypot(ry - pry, iy - piy)[live] / mag[live]).max().item()
        err = max((ry - pry).abs().max().item(), (iy - piy).abs().max().item())
        differ = int((ry != pry).sum()) + int((iy != piy).sum())
        digest = hashlib.sha256(
            torch.stack([ry, iy]).cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"[9 pv-kernels] {tag}: phase path, lock {lock}: planes SNR "
              f"{snr:.1f} dB (min {PV_PLANE_DB:.0f}), max phasor error "
              f"{phasor:.3e} (max {PV_PHASOR_TOL:g}), max|kernel - plain| "
              f"{err:.3e}, {differ} of {2 * ry.numel()} plane elements not "
              f"bitwise the plain version's, kernel planes' sha256 "
              f"{digest} ({card})")
        check(snr >= PV_PLANE_DB, f"{tag}: phase-path planes below the bar")
        check(phasor <= PV_PHASOR_TOL, f"{tag}: a bin's phasor disagrees")
        worst = max(worst, err)
        del ry, iy, pry, piy
    cos_phi, sin_phi = pv._synthesis_phasors(ph, dpos, hop, n_fft)
    lock_in = (cos_phi, sin_phi, ph, mag)
    lock_err = check_lock(f"{tag}: lock", lock_in, card)
    return {"abs": worst, "lock": lock_err}, lock_in


def lock_against_plain(got, lock_in):
    """(max|kernel - plain|, elements not bitwise the plain lock's, whether
    the inputs are finite) of the lock kernel's planes ``got`` on
    ``lock_in`` (cos_phi, sin_phi, ph, mag). The kernel must be within TOL
    of the plain lock, and bitwise it where the inputs are finite (the same
    decisions and roundings)."""
    import torch

    from nodey_tpu_torch.ops import pv

    want = pv._lock_to_peaks(*lock_in)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(t).all()) for t in lock_in)
    return err, differ, finite


def check_lock(tag: str, lock_in, card: str) -> float:
    """The lock kernel against the plain lock on ``lock_in``
    (``lock_against_plain``). Returns max|kernel - plain|."""
    from nodey_tpu_torch.ops import cuda_pv

    err, differ, finite = lock_against_plain(
        cuda_pv.lock_to_peaks_cuda(*lock_in), lock_in)
    print(f"[9 pv-kernels] {tag}, {list(lock_in[3].shape)}: max|kernel - "
          f"plain| = {err:.3e} (tol {TOL:.0e}), {differ} of "
          f"{2 * lock_in[3].numel()} elements not bitwise the plain lock's "
          f"(inputs finite: {finite}) ({card})")
    check(err <= TOL, f"{tag}: the lock kernel disagrees with the plain lock")
    check(differ == 0 or not finite,
          f"{tag}: the lock kernel is not bitwise the plain lock")
    return err


def lock_cases(lock_inputs, card: str) -> float:
    """Phase 9's lock cases beyond check_pv's: the streamed PV's two chunk
    shapes (a step's frames from the middle of each stage's lock inputs),
    and the pitch stage's whole shape with special frames (silent, rising to
    the top bin, equal magnitudes, a comb of ties) at frames 3, 5, 7 and 9 of
    every 64. Returns the worst max|kernel - plain|."""
    import torch

    from nodey_tpu_torch.tools.pv_phase_ab import chunk_frames

    worst = 0.0
    for tag, frames in chunk_frames(STREAM_CHUNK_SECONDS, RATE).items():
        planes = lock_inputs[tag]
        k0 = (planes[3].shape[1] - frames) // 2
        step = tuple(t[:, k0 : k0 + frames].contiguous() for t in planes)
        worst = max(worst, check_lock(
            f"lock at the {tag} stage's chunk shape, frames {k0} to "
            f"{k0 + frames - 1}", step, card))
    cos_phi, sin_phi, ph, mag = (t.clone() for t in lock_inputs["pitch"])
    B = mag.shape[2]
    bins = torch.arange(B, device=mag.device, dtype=mag.dtype)
    special = {3: torch.zeros_like(bins), 5: (bins + 1) / B,
               7: torch.full_like(bins, 0.5),
               9: torch.where(bins % 10 == 0, 1.0, 0.5)}
    for k, row in special.items():
        mag[:, k::64] = row
    worst = max(worst, check_lock("lock at the pitch stage's shape with "
                                  "special frames", (cos_phi, sin_phi, ph,
                                                     mag), card))
    return worst


def wsola_operands(data, tempo: float, rate: int):
    """``(x, head, geometry)`` that ``stretch._wsola_impl`` hands the chain
    for ``data`` [C, N] on its device."""
    import torch.nn.functional as F

    from nodey_tpu_torch.ops import stretch

    geo = stretch.wsola_geometry(data.shape[1], tempo, rate)
    x = F.pad(data, (0, max(0, geo["pad_to"] - data.shape[1])))
    return x, x[:, : geo["overlap"]], geo


def chain_args(geo):
    return (geo["K"], geo["num"], geo["den"], geo["seq"], geo["seek"],
            geo["overlap"])


def near_tie(x, head, bs, k: int, other: int, geo, k0: int = 0,
             base: int = 0) -> float:
    """|score64(bs[k]) - score64(other)| / max_b |score64(b)| of the chain's
    k-th frame (frame k0 + k, read from column frame_pos(k0 + k) - base),
    in float64 with the tail that the chain's choice bs[k-1] realized."""
    import numpy as np

    from nodey_tpu_torch.ops.wsola import frame_pos

    seq, seek, ov = geo["seq"], geo["seek"], geo["overlap"]
    num, den = geo["num"], geo["den"]
    if k == 0:
        tail = head
    else:
        start = (frame_pos(k0 + k - 1, num, den) - base + int(bs[k - 1])
                 + seq - ov)
        tail = x[:, start : start + ov]
    pos = frame_pos(k0 + k, num, den) - base
    cand = x[:, pos : pos + seek + ov].double().cpu().numpy()
    tail = tail.double().cpu().numpy()
    win = np.lib.stride_tricks.sliding_window_view(cand, ov, axis=1)
    scores = (np.einsum("cv,cbv->b", tail, win)
              / np.sqrt((win * win).sum(axis=(0, 2)) + 1e-9))
    return abs(scores[int(bs[k])] - scores[other]) / np.abs(scores).max()


def check_chain(tag: str, x, head, geo, card: str, out=None,
                phase: str = "6 wsola", min_ties: int = 0):
    """The kernel's chain on (x, head) against the plain version: every
    frame's choice given the kernel's previous one, and the audio given all
    of them. ``out``: the kernel's (bs, body) from a launch already made on
    these operands (else it launches here). At most TIE_SHARE of K frames,
    or ``min_ties`` where that is more, may differ, each a near tie.
    Returns (bs, body, max|body - plain|)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import cuda_wsola, wsola

    bs, body = out or cuda_wsola.wsola_chain_cuda(x, head, *chain_args(geo))
    torch.cuda.synchronize()
    bs_host = bs.cpu().numpy()
    replay = wsola.replay_decisions(x, head, bs_host, *chain_args(geo))
    differ = np.nonzero(replay.cpu().numpy() != bs_host)[0]
    want = wsola.assemble_plain(x, head, bs_host, *chain_args(geo))
    err = (body - want).abs().max().item()
    gaps = [near_tie(x, head, bs_host, int(k), int(replay[k]), geo)
            for k in differ]
    worst = max(gaps, default=0.0)
    K = geo["K"]
    ties = max(min_ties, math.floor(TIE_SHARE * K))
    print(f"[{phase}] {tag}: K={K}, x {list(x.shape)}: {len(differ)} frames "
          f"choose otherwise than the plain scoring given the kernel's "
          f"previous choice (at most {ties}, the larger of {TIE_SHARE:g} "
          f"of K and {min_ties}), worst float64 gap "
          f"{worst:.3e} of the frame's max |score| (max {TIE_REL:g}); "
          f"max|body - plain assembly| = {err:.3e} (tol {TOL:.0e}) ({card})")
    check(len(differ) <= ties, f"{tag}: {len(differ)} frames differ")
    check(worst <= TIE_REL, f"{tag}: a differing frame is no near tie")
    check(err <= TOL, f"{tag}: kernel audio disagrees with the plain assembly")
    return bs, body, err


def check_energy(tag: str, x, geo, card: str, phase: str = "6 wsola"):
    """The chain's energy prologue against its plain version on one chain's
    operands, every frame, in the wrapper's blocks of BLOCK_FRAMES: max
    relative difference <= ENERGY_REL. Returns (max relative, max abs)."""
    from nodey_tpu_torch.ops import cuda_wsola, wsola

    K, args = geo["K"], chain_args(geo)[1:]
    rel = err = 0.0
    for k0 in range(0, K, cuda_wsola.BLOCK_FRAMES):
        n = min(cuda_wsola.BLOCK_FRAMES, K - k0)
        got = cuda_wsola.wsola_energy_cuda(x, k0, 0, n, *args)
        want = wsola.wsola_energy_plain(x, k0, 0, n, *args)
        rel = max(rel, ((got - want).abs() / want).max().item())
        err = max(err, (got - want).abs().max().item())
        del got, want
    print(f"[{phase}] {tag}: energy prologue, table [{K}, {geo['seek'] + 1}]"
          f" in {-(-K // cuda_wsola.BLOCK_FRAMES)} launches: max|kernel - "
          f"plain| / plain = {rel:.3e} (tol {ENERGY_REL:.0e}), max|kernel - "
          f"plain| = {err:.3e} ({card})")
    check(rel <= ENERGY_REL, f"{tag}: the energy prologue disagrees with plain")
    return rel, err


def table_gaps(x, geo, entries, table, other):
    """For score-table rows (k, p) in ``entries`` [n, 2]: |score64(table[k,
    p]) - score64(other[k, p])| / max_b |score64(b)| of that row, in
    float64 on x's device (row p of frame k >= 1 scores the tail
    x[:, frame_pos(k-1) + stride + p :], frame 0 the head)."""
    import torch

    from nodey_tpu_torch.ops.wsola import frame_pos

    seq, seek, ov = geo["seq"], geo["seek"], geo["overlap"]
    num, den = geo["num"], geo["den"]
    rows = {}
    for k, p in entries.tolist():
        rows.setdefault(k, []).append(p)
    gaps = []
    for k, ps in rows.items():
        pos = frame_pos(k, num, den)
        cand = x[:, pos : pos + seek + ov].double().unfold(1, ov, 1)
        p = torch.tensor(ps, device=x.device)
        start = frame_pos(k - 1, num, den) + seq - ov if k else 0
        cols = (p[:, None] * (k > 0) + start
                + torch.arange(ov, device=x.device))
        scores = (torch.einsum("cpv,cbv->pb", x[:, cols].double(), cand)
                  / torch.sqrt((cand * cand).sum((0, 2)) + 1e-9))
        i = torch.arange(len(ps), device=x.device)
        gap = scores[i, table[k, p].long()] - scores[i, other[k, p].long()]
        gaps += (gap.abs() / scores.abs().max(dim=1).values).tolist()
    return gaps


def library_table(x, geo):
    """The score table's library yardstick, timed by this script only (the
    port never calls it): per 64 frames one ``torch.bmm`` of the
    channel-stacked Hankel operands [F, n, C*overlap] (TF32 off), the
    candidates' rsqrt norms, then ``torch.argmax``."""
    import torch

    from nodey_tpu_torch.ops.wsola import frame_pos

    K, num, den, seq, seek, ov = chain_args(geo)
    C, n = x.shape[0], seek + 1
    cols = torch.arange(seek + ov, device=x.device)
    table = torch.empty((K, n), dtype=torch.int32, device=x.device)
    for k0 in range(0, K, 64):
        ks = range(k0, min(K, k0 + 64))
        pos = torch.tensor([frame_pos(k, num, den) for k in ks],
                           device=x.device)
        prev = torch.tensor([frame_pos(k - 1, num, den) + seq - ov if k else 0
                             for k in ks], device=x.device)

        def stacked(starts):
            return (x[:, starts[:, None] + cols].unfold(2, ov, 1)
                    .permute(1, 2, 0, 3).reshape(len(ks), n, C * ov))

        cand, tail = stacked(pos), stacked(prev)
        if k0 == 0:
            tail[0] = x[:, :ov].reshape(1, C * ov)
        scores = torch.bmm(tail, cand.transpose(1, 2))
        scores *= torch.rsqrt((cand * cand).sum(2) + 1e-9)[:, None, :]
        table[k0 : k0 + len(ks)] = torch.argmax(scores, dim=2).int()
    return table


def check_table(tag: str, x, head, geo, card: str, chain=None):
    """Phase 16 on one (x, geometry): the score kernel against the plain
    table (differing entries float64 near ties, on at most TIE_SHARE of
    them), bitwise the same at frames_per_step 1, 2 and 4; the walk kernel
    against the plain walk and the composed plain walk of the same table,
    bitwise. With ``chain`` = the
    chain kernel's (bs, body) on the same operands: F[k][bs[k-1]] == bs[k]
    but for near ties on at most TIE_SHARE of K, frame 0 exactly, and
    ``wsola.assemble_plain`` of the walk's splices within TOL of the chain
    kernel's body on every frame where the walk and the chain agree (and
    agreed the frame before). Returns (table, worst gap, worst body err)."""
    import torch

    from nodey_tpu_torch.ops import cuda_wsola_table, wsola

    args = chain_args(geo)
    K, n_cand = geo["K"], geo["seek"] + 1
    tables = {f: cuda_wsola_table.wsola_score_table_cuda(
        x, *args, frames_per_step=f) for f in (1, 2, 4)}
    table = tables[1]
    plain = wsola.wsola_score_table_plain(x, *args)
    same_fps = all(torch.equal(table, tables[f]) for f in (2, 4))
    differ = (table != plain).nonzero()
    gaps = table_gaps(x, geo, differ, table, plain)
    walk = cuda_wsola_table.walk_table_cuda(table)
    seg = cuda_wsola_table.walk_segment_frames(
        K, torch.cuda.get_device_properties(0).multi_processor_count)
    same_walk = torch.equal(walk, wsola.walk_table_plain(table))
    same_composed = torch.equal(
        walk, wsola.walk_table_segments_plain(table, seg))
    torch.cuda.synchronize()
    worst = max(gaps, default=0.0)
    print(f"[16 wsola-table] {tag}: K={K}, table [{K}, {n_cand}]: "
          f"{len(differ)} entries differ from the plain table (max share "
          f"{TIE_SHARE:g} = {int(TIE_SHARE * K * n_cand)}), worst float64 gap "
          f"{worst:.3e} of the row's max |score| (max {TIE_REL:g}); "
          f"frames_per_step 1, 2, 4 {'bitwise equal' if same_fps else 'DIFFER'}"
          f"; walk kernel (segments of {seg} frames) vs plain walk "
          f"{'bitwise equal' if same_walk else 'DIFFER'}, vs the composed "
          f"plain walk {'bitwise equal' if same_composed else 'DIFFER'} "
          f"({card})")
    check(len(differ) <= TIE_SHARE * K * n_cand,
          f"{tag}: {len(differ)} table entries differ from the plain table")
    check(worst <= TIE_REL, f"{tag}: a differing table entry is no near tie")
    check(same_fps, f"{tag}: the table depends on frames_per_step")
    check(same_walk, f"{tag}: the walk kernel disagrees with the plain walk")
    check(same_composed,
          f"{tag}: the walk kernel disagrees with the composed plain walk")
    err = 0.0
    if chain is not None:
        bs, body = chain
        bs_host = bs.cpu().numpy()
        pred = table[1:].gather(1, bs[:-1].long()[:, None])[:, 0]
        off = ((pred != bs[1:]).nonzero()[:, 0] + 1).tolist()
        cross = [near_tie(x, head, bs_host, k, int(pred[k - 1]), geo)
                 for k in off]
        frame0 = bool((table[0] == bs[0]).all())
        agree = walk == bs
        agree[1:] &= agree[:-1].clone()
        stride = geo["seq"] - geo["overlap"]
        want = wsola.assemble_plain(x, head, walk.cpu().numpy(), *args)
        cols = agree.repeat_interleave(stride)
        if bool(cols.any()):
            err = (body[:, cols] - want[:, cols]).abs().max().item()
        print(f"[16 wsola-table] {tag}: against the chain kernel: "
              f"F[k][bs[k-1]] != bs[k] on {len(off)} of {K} frames (max share "
              f"{TIE_SHARE:g}), worst float64 gap {max(cross, default=0.0):.3e}"
              f"; frame 0 {'equal' if frame0 else 'DIFFERS'}; the walk equals "
              f"the chain on {int(agree.sum())} of {K} frames; plain assembly "
              f"of the walk's splices vs the chain kernel's body there: "
              f"max|diff| {err:.3e} (tol {TOL:.0e}) ({card})")
        check(len(off) <= TIE_SHARE * K, f"{tag}: the table and the chain "
              f"kernel disagree on {len(off)} frames")
        check(max(cross, default=0.0) <= TIE_REL, f"{tag}: a frame where the "
              "table and the chain differ is no near tie")
        check(frame0, f"{tag}: frame 0's row is not the chain's first choice")
        check(err <= TOL, f"{tag}: the walk's audio disagrees with the chain's")
    return table, worst, err


def walk_cases(seed, table=None, seg=WALK_SEG):
    """(tag, table [K, n_cand] int32 ndarray, the walk in a Python loop):
    random tables from a numpy seed at n_cand 661 and 721 (the 44.1 and 48
    kHz seeks), K in {1, L-1, L, L+1, 3L+7} (L = WALK_SEG), and on the
    3L+7-frame ones (or on ``table``, given as an ndarray) an entry outside
    [0, n_cand) planted on the walk's path at the first row of the third
    segment of ``seg`` frames, in the second's middle and on the last frame
    (the walk's prefix, then -1s), and one planted off the path (no
    change)."""
    import numpy as np

    def walk(rows):
        path, b = [], 0
        for row in rows:
            b = int(row[b])
            path.append(b)
        return path

    def planted(rows, path, tag):
        K, n = rows.shape
        for k, bad in ((2 * seg, n), (seg + seg // 2, -1), (K - 1, n + 9)):
            out = rows.copy()
            out[k, path[k - 1]] = bad
            yield (f"{tag}, {bad} at frame {k}", out,
                   path[:k] + [-1] * (K - k))
        out = rows.copy()
        out[seg + seg // 2, (path[seg + seg // 2 - 1] + 1) % n] = -1
        yield f"{tag}, -1 off the path", out, path

    if table is not None:
        yield from planted(table, walk(table), f"K={table.shape[0]}")
        return
    rng = np.random.default_rng(seed)
    for n in (661, 721):
        for K in (1, WALK_SEG - 1, WALK_SEG, WALK_SEG + 1, 3 * WALK_SEG + 7):
            rows = rng.integers(0, n, (K, n)).astype(np.int32)
            path = walk(rows)
            yield f"random n={n} K={K}", rows, path
        yield from planted(rows, path, f"random n={n} K={K}")


def check_walks(card: str, dev, stage_table):
    """Phase 16's random and planted tables (walk_cases; ``stage_table``,
    config 4's pitch-stage table, planted too): the walk kernel at its own
    segment length and at 1, 3, WALK_SEG and more than K frames, bitwise
    the plain walk, the composed plain walk at the same length, and the
    walk in a Python loop. Returns the kernel's launches."""
    import torch

    from nodey_tpu_torch.ops import cuda_wsola_table, wsola

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seg = cuda_wsola_table.walk_segment_frames(stage_table.shape[0], sms)
    cases = [*walk_cases(16),
             *walk_cases(16, stage_table.cpu().numpy(), seg)]
    launches, stopped = 0, 0
    for tag, rows, want in cases:
        table = torch.from_numpy(rows).to(dev)
        plain = wsola.walk_table_plain(table)
        check(plain.tolist() == want, f"{tag}: the plain walk is not the walk")
        big = rows.shape[0] > 1000   # the plain walks of 11,820 frames take s
        for length in (None,) if big else (None, 1, 3, WALK_SEG,
                                           rows.shape[0] + 1):
            got = cuda_wsola_table.walk_table_cuda(table, length)
            launches += 1
            composed = wsola.walk_table_segments_plain(
                table, length or cuda_wsola_table.walk_segment_frames(
                    rows.shape[0], sms))
            check(torch.equal(got, plain) and torch.equal(composed, plain),
                  f"{tag}, segments of {length}: the walk kernel or the "
                  "composed plain walk disagrees with the plain walk")
        stopped += int(want[-1] == -1)
    torch.cuda.synchronize()
    print(f"[16 wsola-table] walk kernel on {len(cases)} random and planted "
          f"tables (n_cand 661 and 721, K 1 to {3 * WALK_SEG + 7}; config 4's "
          f"pitch-stage table with an entry outside [0, n_cand) planted on "
          f"the walk's path at frames {2 * seg}, {seg + seg // 2} and "
          f"{stage_table.shape[0] - 1} and off it; {stopped} stopped, each "
          f"the prefix then "
          f"-1s), at its own segment length and at 1, 3, {WALK_SEG} and more "
          f"than K frames: {launches} launches, each bitwise the plain walk "
          f"and the composed plain walk ({card})")
    return launches


def table_and_probe_phases(card: str, dev, stages, chain_us: float):
    """Phases 16-18 (see the module docstring). ``stages``: config 4's two
    chains from phase 6, (tag, x, head, geo, bs, body) each; ``chain_us``:
    the chain kernel's microseconds per frame (phase 8). Returns (the launch
    counts of the three paths run here, by path; the kernels' entries of the
    ``kernels`` line, without their launches)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import cuda_probes, cuda_resample, cuda_wsola
    from nodey_tpu_torch.ops import cuda_wsola_table, wsola
    from nodey_tpu_torch.ops import resample as tr
    from nodey_tpu_torch.tools import ab_wsola_fps, probes

    # -- 16. wsola-table -------------------------------------------------------
    table_gap = 0.0
    for rate, tempo in GOLDEN_CASES:
        sig = torch.from_numpy(golden_signal(rate)).to(dev)
        x, head, geo = wsola_operands(sig, tempo, rate)
        chain = cuda_wsola.wsola_chain_cuda(x, head, *chain_args(geo))
        _, gap, _ = check_table(f"golden signal {rate} Hz, tempo {tempo}", x,
                                head, geo, card, chain)
        table_gap = max(table_gap, gap)
    times = {}
    walk_before = cuda_wsola_table.walk_launches
    walk_calls = 0

    def walk(table, seg=None):
        nonlocal walk_calls
        walk_calls += 1
        return cuda_wsola_table.walk_table_cuda(table, seg)

    for tag, x, head, geo, bs, body in stages:
        table, gap, _ = check_table(f"config-4 {tag} stage", x, head, geo,
                                    card, (bs, body))
        walk_calls += 1
        if tag == stages[0][0]:
            walk_calls += check_walks(card, dev, table)
        table_gap = max(table_gap, gap)
        args = chain_args(geo)
        fns = {
            "kernel": lambda: cuda_wsola_table.wsola_score_table_cuda(x, *args),
            "plain": lambda: wsola.wsola_score_table_plain(x, *args),
            "library": lambda: library_table(x, geo),
            "walk kernel": lambda: walk(table),
            "walk plain": lambda: wsola.walk_table_plain(table),
        }
        runs = {name: [] for name in fns}
        for name in ("plain", "library", "kernel", "kernel", "library",
                     "plain", "walk plain", "walk plain"):
            runs[name] += cuda_ms(fns[name], 2, warmup=1)
        # The walk's device time is tens of us, below its wrapper's host
        # time: its calls are queued (and, beside them, timed as a caller
        # sees them).
        walk_call = []
        for queued in (True, False, False, True):
            (runs["walk kernel"] if queued else walk_call).extend(cuda_ms(
                fns["walk kernel"], 20, queued=queued))
        # The segment length: one segment per SM (walk_segment_frames)
        # beside fewer, longer segments and more, shorter ones.
        own = cuda_wsola_table.walk_segment_frames(
            geo["K"], torch.cuda.get_device_properties(0).multi_processor_count)
        seg_ms = {seg: summary(cuda_ms(lambda seg=seg: walk(table, seg), 20,
                                       queued=True))[0]
                  for seg in sorted({32, 64, 96, 128, own})}
        print(f"[16 wsola-table] walk kernel by segment length, {tag} stage "
              f"(queued, median of 20; the wrapper takes {own}): " + ", ".join(
                  f"{seg} frames {ms:.4f} ms" for seg, ms in seg_ms.items())
              + f" ({card})")
        K, n, C, ov = geo["K"], geo["seek"] + 1, x.shape[0], geo["overlap"]
        times[tag] = {name: summary(runs[name])[0] for name in fns}
        times[tag]["walk by segment"] = {str(k): v for k, v in seg_ms.items()}
        # Least work: x read once, the table written once; C*ov*n multiply-
        # adds for each of frame 0's candidates and each (p, b) pair of the
        # other frames. The walk: one entry read and one splice written per
        # frame; beside it, the composed walk's own floor, the table read
        # once.
        times[tag]["bound"] = bound(4 * (x.numel() + K * n),
                                    2 * C * ov * n * (n * (K - 1) + 1))
        times[tag]["walk bound"] = bound(8 * K, 0)
        times[tag]["walk floor"] = bound(4 * K * n, 0)
        times[tag]["walk call"] = summary(walk_call)[0]
        # By pass (device time of each launch; passes 2 and 3 start while
        # the pass before drains). A profiled run has now and then seen no
        # device time: one more run then.
        times[tag]["walk passes"] = (
            pass_ms(fns["walk kernel"], 10, WALK_PASSES, "wsola_walk_")
            or pass_ms(fns["walk kernel"], 10, WALK_PASSES, "wsola_walk_"))
        for name in fns:
            med, lo, hi, count = summary(runs[name])
            label = {"library": " (library yardstick)",
                     "walk kernel": " (queued: device time)"}.get(name, "")
            print(f"[16 wsola-table] times, {tag} stage, K={K}, x "
                  f"{list(x.shape)}, {name}{label}: median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
                  f"n={count}) ({card})")
        med, lo, hi, count = summary(walk_call)
        print(f"[16 wsola-table] times, {tag} stage, K={K}, walk kernel as a "
              f"caller sees it (not queued: the wrapper's host time "
              f"included): median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
              f"n={count}) ({card})")
        for what, key in (("score table", "bound"), ("walk", "walk bound"),
                          ("walk", "walk floor")):
            ms, by = times[tag][key]
            kernel = times[tag]["walk kernel" if what == "walk" else "kernel"]
            label = {"walk bound": " (one entry read and one splice written "
                                   "a frame)",
                     "walk floor": " (the composed walk's floor: the table "
                                   "read once)"}.get(key, "")
            print(f"[16 wsola-table] {what} bound{label}, {tag} stage: "
                  f"{ms:.7f} ms by {by}; kernel at {ms / kernel:.2%} of it; "
                  f"{kernel * 1e3 / K:.4f} us per frame ({card})")
        passes = times[tag]["walk passes"]
        parts = ", ".join(f"{name} {passes[name]:.4f} ms"
                          for name in WALK_PASSES if name in passes)
        print(f"[16 wsola-table] walk kernel by pass, {tag} stage "
              f"(torch.profiler, 10 calls): "
              f"{parts or 'not measured (no device time seen)'}; sum "
              f"{sum(passes.values()):.4f} ms beside the queued call's "
              f"{times[tag]['walk kernel']:.4f} ms ({card})")
        del table, fns
    torch.cuda.synchronize()
    walk_launches = cuda_wsola_table.walk_launches - walk_before
    print(f"[16 wsola-table] walk_launches in phase 16: {walk_launches} "
          f"(the checks' and the timed calls') ({card})")
    check(walk_launches == walk_calls and walk_launches > 0,
          f"phase 16 counted {walk_launches} walk launches, made {walk_calls}")

    # -- 17. probes -----------------------------------------------------------
    rng = np.random.default_rng(17)
    block = torch.from_numpy(rng.standard_normal(cuda_probes.BLOCK).astype(
        np.float32)).to(dev)
    wide = torch.from_numpy(rng.standard_normal(
        (2, probes.DMA_COLUMNS)).astype(np.float32)).to(dev)
    span = probes.span_dma()
    probe_fns = {}
    for per_step in (True, False):
        probe_fns[("bare", per_step)] = (
            lambda p=per_step: cuda_probes.step_probe_bare_cuda(
                block, PROBE_STEPS, p),
            lambda p=per_step: cuda_probes.step_probe_bare_plain(
                block, PROBE_STEPS, p))
    for ring in (True, False):
        probe_fns[("dma", ring)] = (
            lambda r=ring: cuda_probes.step_probe_dma_cuda(
                wide, PROBE_STEPS, span, r),
            lambda r=ring: cuda_probes.step_probe_dma_plain(
                wide, PROBE_STEPS, span, r))
    what = {("bare", True): "out[k] per step (bench.py)",
            ("bare", False): "one fixed block (the tool)",
            ("dma", True): "TMA, 3-slot ring, one-step prefetch (bench.py)",
            ("dma", False): "TMA, two copies per step, both waited (the tool)"}
    for key, (kernel, plain) in probe_fns.items():
        same = torch.equal(kernel(), plain())
        print(f"[17 probes] {key[0]} probe, {what[key]}, K={PROBE_STEPS}: "
              f"{'equal to' if same else 'DIFFERS from'} its plain output "
              f"({card})")
        check(same, f"the {key[0]} probe disagrees with its plain output")
    # Least bytes: x read once (the dma probe: the union of its windows),
    # each output written once.
    limit = cuda_probes.dma_limit(probes.DMA_COLUMNS, span)
    window_cols = min((PROBE_STEPS - 1) * cuda_probes.LANE, limit) + span
    bounds = {
        ("bare", True): bound(4 * 1024 * (1 + PROBE_STEPS), 0),
        ("bare", False): bound(4 * 1024 * 2, 0),
        ("dma", True): bound(
            4 * 2 * (window_cols + PROBE_STEPS * cuda_probes.LANE), 0),
        ("dma", False): bound(4 * 2 * (window_cols + cuda_probes.LANE), 0),
    }
    probe_times = {}
    for key, (kernel, plain) in probe_fns.items():
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name] += cuda_ms(kernel if name == "kernel" else plain, 5)
        t = probe_times[key] = {k: summary(v)[0] for k, v in runs.items()}
        t["bound"] = bounds[key]
        print(f"[17 probes] {key[0]} probe, {what[key]}, K={PROBE_STEPS}, per "
              f"launch: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} "
              f"ms, bound {t['bound'][0]:.6f} ms by {t['bound'][1]} ({card})")
    zero_counts()
    bare_s, dma_s = probes.wsola_step_overhead(8, device=CARD)
    counts_steps = read_counts()
    print(f"[17 probes] step overhead by K-slope ({probes.STEP_KS[0]} -> "
          f"{probes.STEP_KS[1]} steps, CUDA events): bare {bare_s * 1e6:.4f} "
          f"us per step, dma {dma_s * 1e6:.4f} us per step; the chain kernel "
          f"{chain_us:.4f} us per frame (phase 8, K={stages[0][3]['K']}); "
          f"launches {counts_steps} ({card})")
    check(counts_steps["step_probe_bare"] >= 2
          and counts_steps["step_probe_dma"] >= 2,
          "wsola_step_overhead did not run both probe kernels")
    probe_times[("bare", True)]["us_per_step"] = bare_s * 1e6
    probe_times[("dma", True)]["us_per_step"] = dma_s * 1e6
    # The tool's forms by the same K-slope (outside any counted run).
    tool_forms = {
        ("bare", False): lambda K: cuda_probes.step_probe_bare_cuda(
            block, K, False),
        ("dma", False): lambda K: cuda_probes.step_probe_dma_cuda(
            wide, K, span, False)}
    for key, form in tool_forms.items():
        slope = probes.k_slope(
            lambda K: probes.cuda_seconds(lambda: form(K), 8))
        probe_times[key]["us_per_step"] = slope * 1e6
        print(f"[17 probes] {key[0]} probe, {what[key]}, by K-slope "
              f"({probes.STEP_KS[0]} -> {probes.STEP_KS[1]} steps): "
              f"{slope * 1e6:.4f} us per step ({card})")

    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = ab_wsola_fps.main(TOOL_ARGS)
    counts_tool = read_counts()
    print("\n".join(f"[17 probes] ab_wsola_fps {' '.join(TOOL_ARGS)}: {line}"
                    for line in stdout.getvalue().splitlines()))
    print(f"[17 probes] ab_wsola_fps launches {counts_tool} ({card})")
    check(rc == 0, f"ab_wsola_fps exited {rc}")
    for fps in (2, 4):
        check(f"table fps={fps} == fps=1: True" in stdout.getvalue(),
              f"ab_wsola_fps: the table at fps={fps} differs")
    for name in ("wsola_score_table", "wsola_table_walk", "step_probe_bare",
                 "step_probe_dma", "wsola_chain"):
        check(counts_tool[name] >= 1, f"ab_wsola_fps did not launch {name}")

    # -- 18. resample-data ----------------------------------------------------
    resample_err = 0.0
    cases = [(i, o, c, i // 2) for i, o in RESAMPLE_DATA_PAIRS for c in (1, 2)]
    cases.append((48_000, 44_100, 2, 48_000 * SECONDS))
    for in_rate, out_rate, channels, n in cases:
        data = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
            (channels, n))).astype(np.float32)).to(dev)
        got = tr.resample_data(data, in_rate, out_rate)
        x, G, M, W, bank, _ = tr.bank_operands(data, in_rate, out_rate)
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)[:, : got.shape[1]]
        err = (got - want).abs().max().item()
        print(f"[18 resample-data] resample_data {in_rate}->{out_rate} Hz, "
              f"[{channels}, {n}] -> {list(got.shape)}: max|kernel - plain| "
              f"{err:.3e} (tol {TOL:.0e}) ({card})")
        check(err <= TOL, f"resample_data disagrees at {in_rate}->{out_rate}")
        resample_err = max(resample_err, err)
        del data, got, x, want
    zero_counts()
    ab = {pair: probes.resample_ab(*pair, SECONDS, device=CARD) for pair in (
        (48_000, 44_100), (44_100, 48_000))}
    counts_ab = read_counts()
    for (in_rate, out_rate), r in ab.items():
        print(f"[18 resample-data] resample_ab {in_rate}->{out_rate} Hz, "
              f"{SECONDS} s stereo: resample_data (the polyphase kernel) "
              f"{r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"F.conv1d (library yardstick) {r['conv1d_ms']:.4f} ms, "
              f"max|kernel - plain| {r['max_diff']:.3e} ({card})")
        check(r["max_diff"] <= TOL, f"resample_ab: kernel and plain disagree "
              f"at {in_rate}->{out_rate}")
        resample_err = max(resample_err, r["max_diff"])
    print(f"[18 resample-data] resample_ab launches {counts_ab} ({card})")
    check(counts_ab["polyphase_resample"] >= 2,
          "resample_ab did not launch the polyphase kernel")
    data = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
        (2, 48_000 * SECONDS))).astype(np.float32)).to(dev)
    x, G, M, W, bank, support = tr.bank_operands(data, 48_000, 44_100)
    resample_bound = resample_work_bound(x, G, M, bank)
    print(f"[18 resample-data] 48->44.1 kHz, {SECONDS} s stereo bound: "
          f"{resample_bound[0]:.4f} ms by {resample_bound[1]}; resample_data "
          f"at {resample_bound[0] / ab[(48_000, 44_100)]['kernel_ms']:.2%} of "
          f"it ({card})")
    kernel_times = time_resampler(
        "18 resample-data", f"48->44.1 kHz, {SECONDS} s stereo, the polyphase "
        f"kernel alone (no pad, no slice)", {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support)},
        ("kernel", "kernel"), 10, card, resample_bound)
    del data, x

    pitch, velocity = times[stages[0][0]], times[stages[1][0]]
    r = ab[(48_000, 44_100)]
    entries = [
        {"name": "wsola_score_table", "route": "cuda",
         "source": "nodey_tpu_torch/csrc/wsola_score_table.cu",
         "replaces": "nodey_tpu/ops/pallas_wsola.py:71",
         "max_abs_err": table_gap,
         "max_abs_err_is": "worst float64 score gap / row max |score| of an "
                           "entry that differs from the plain table",
         "ms": pitch["kernel"], "plain_ms": pitch["plain"],
         "bound_ms": pitch["bound"][0], "bound_by": pitch["bound"][1],
         "library_ms": pitch["library"]},
        {"name": "wsola_table_walk", "route": "cuda",
         "source": "nodey_tpu_torch/csrc/wsola_score_table.cu",
         "replaces": "nodey_tpu/ops/pallas_wsola.py:307",
         "max_abs_err": 0.0,
         "ms": pitch["walk kernel"], "plain_ms": pitch["walk plain"],
         "bound_ms": pitch["walk bound"][0],
         "bound_by": pitch["walk bound"][1], "library_ms": None,
         "floor_ms": pitch["walk floor"][0], "call_ms": pitch["walk call"],
         "passes_ms": pitch["walk passes"],
         "ms_by_segment_frames": pitch["walk by segment"],
         "velocity": {"ms": velocity["walk kernel"],
                      "plain_ms": velocity["walk plain"],
                      "bound_ms": velocity["walk bound"][0],
                      "floor_ms": velocity["walk floor"][0],
                      "call_ms": velocity["walk call"],
                      "passes_ms": velocity["walk passes"],
                      "ms_by_segment_frames": velocity["walk by segment"]}},
    ]
    for probe, replaces in (
            ("bare", "bench.py:979 and tools/ab_wsola_fps.py:42"),
            ("dma", "bench.py:994 and tools/ab_wsola_fps.py:60")):
        t, tool = probe_times[(probe, True)], probe_times[(probe, False)]
        entries.append({
            "name": f"step_probe_{probe}", "route": "cuda",
            "source": "nodey_tpu_torch/csrc/step_probes.cu",
            "replaces": replaces, "max_abs_err": 0.0,
            "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None, "us_per_step": t["us_per_step"],
            "tool_form": {"ms": tool["kernel"], "plain_ms": tool["plain"],
                          "bound_ms": tool["bound"][0],
                          "bound_by": tool["bound"][1],
                          "us_per_step": tool["us_per_step"]}})
    entries.append({
        "name": "resample_data", "route": "cuda",
        "source": "nodey_tpu_torch/csrc/polyphase_resample.cu",
        "replaces": "nodey_tpu/ops/pallas_resample.py:56",
        "max_abs_err": resample_err,
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": resample_bound[0], "bound_by": resample_bound[1],
        "library_ms": r["conv1d_ms"],
        "kernel_alone_ms": kernel_times["kernel"]})
    paths = {"ab_wsola_fps": counts_tool, "step_overhead": counts_steps,
             "resample_ab": counts_ab}
    return paths, entries


def check_chunk_calls(tag: str, calls, geo, card: str,
                      phase: str = "13 stream-kernel"):
    """Every recorded chunk-chain launch of one WSOLA stage against the plain
    chunk chain on the same (x, head, k0, base, K): splices equal, or a
    float64 near tie on at most TIE_SHARE of the frames; body and tail_out
    within TOL of the plain version given the kernel's own splices. Returns
    (the kernel's splices of all steps in order, worst max|diff|)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import wsola
    from nodey_tpu_torch.ops.wsola import frame_pos

    decisions, worst, differ_total, gap_worst, frames = [], 0.0, 0, 0.0, 0
    stride = geo["seq"] - geo["overlap"]
    for args, (bs, body, tail) in calls:
        x, head, k0, base, K = args[:5]
        pbs, pbody, ptail = wsola.wsola_chunk_chain_plain(*args)
        if torch.equal(bs, pbs):
            err = max((body - pbody).abs().max().item(),
                      (tail - ptail).abs().max().item())
        else:
            bs_host = bs.cpu().numpy()
            replay = wsola.replay_decisions(x, head, bs_host, *args[4:],
                                            k0=k0, base=base)
            differ = np.nonzero(replay.cpu().numpy() != bs_host)[0]
            differ_total += len(differ)
            gap_worst = max([gap_worst] + [
                near_tie(x, head, bs_host, int(k), int(replay[k]), geo,
                         k0=k0, base=base) for k in differ])
            want = wsola.assemble_plain(x, head, bs_host, *args[4:], k0=k0,
                                        base=base)
            last = frame_pos(k0 + K - 1, geo["num"], geo["den"]) - base \
                + int(bs_host[-1]) + stride
            err = max((body - want).abs().max().item(),
                      (tail - x[:, last : last + geo["overlap"]]).abs()
                      .max().item())
        worst = max(worst, err)
        frames += K
        decisions.append(bs)
    print(f"[{phase}] {tag}: {len(calls)} chunk launches, {frames} "
          f"frames, K {min(c[0][4] for c in calls)}..{max(c[0][4] for c in calls)}"
          f" per launch: {differ_total} frames choose otherwise than the plain "
          f"chunk chain given the kernel's previous choice (max share "
          f"{TIE_SHARE:g}), worst float64 gap {gap_worst:.3e} (max "
          f"{TIE_REL:g}); max|body, tail_out - plain| = {worst:.3e} (tol "
          f"{TOL:.0e}) ({card})")
    check(differ_total <= TIE_SHARE * frames, f"{tag}: {differ_total} frames "
          "differ from the plain chunk chain")
    check(gap_worst <= TIE_REL, f"{tag}: a differing frame is no near tie")
    check(worst <= TOL, f"{tag}: chunk kernel audio disagrees with plain")
    return torch.cat(decisions), worst


@contextlib.contextmanager
def checked_steps(spans):
    """Every chunk step of the streaming runs inside this block runs under
    torch.cuda.set_sync_debug_mode("error"), so a device-to-host sync inside
    a step raises; the executor's h2d, d2h hand-off and egress run outside
    the mode. ``spans`` gets a pair of CUDA events around each step on the
    compute stream (read after the run)."""
    import torch

    from nodey_tpu_torch.core import chunkflow

    compile_stream_graph = chunkflow.compile_stream_graph

    def compile_checked(*args, **kwargs):
        compiled = compile_stream_graph(*args, **kwargs)
        step = compiled.step

        def checked_step(states, step_args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(states, step_args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                end.record()
                spans.append((start, end))

        compiled.step = checked_step
        return compiled

    chunkflow.compile_stream_graph = compile_checked
    try:
        yield
    finally:
        chunkflow.compile_stream_graph = compile_stream_graph


def project_with_tracks(project: str, paths, out: str) -> str:
    """Write to ``out`` a copy of the project whose audio_input reads
    ``paths``; returns ``out``."""
    with open(project) as f:
        data = json.load(f)
    for node in data["nodes"].values():
        if node["identifier"] == "audio_input":
            node["info"]["file_path"] = list(paths)
    with open(out, "w") as f:
        json.dump(data, f)
    return out


def stream_export(cli, project: str, out_wav: str):
    """``run --stream --export`` of ``project`` on the card through the
    port's CLI; returns (exit code, its output, the export's StreamMetrics
    or None)."""
    from nodey_tpu_torch.core.runner import Runner

    captured = []
    export_streamed = Runner.export_streamed

    def capture(self, *args, **kwargs):
        metrics = export_streamed(self, *args, **kwargs)
        captured.append(self.last_stream_metrics)
        return metrics

    stdout = io.StringIO()
    Runner.export_streamed = capture
    try:
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", project, "--stream", "--export", out_wav,
                           "--device", CARD])
    finally:
        Runner.export_streamed = export_streamed
    return rc, stdout.getvalue(), captured[0] if captured else None


def profile_render(render, card: str, tag: str = "8 times",
                   what: str = "config-4", top: int = 6) -> None:
    """One render under torch.profiler: device time by kernel and the
    share of the render's CUDA-event span that no kernel occupied."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    with profile(activities=activities) as prof:
        start.record()
        render()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    rows = []
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0))
        if us > 0 and getattr(event, "device_type", None) != \
                torch.autograd.DeviceType.CPU:
            rows.append((us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    if busy_ms == 0.0:
        print(f"[{tag}] {what} profile: the profiler saw no device time "
              f"(breakdown not measured) ({card})")
        return
    for ms, count, key in rows[:top]:
        print(f"[{tag}] {what} profile: {ms:.4f} ms in {count} launches "
              f"({ms / span_ms:.1%}) {key[:70]} ({card})")
    print(f"[{tag}] {what} profile: kernels {busy_ms:.4f} ms of a "
          f"{span_ms:.4f} ms render; device idle share "
          f"{max(0.0, 1.0 - busy_ms / span_ms):.2%} ({card})")


def pass_ms(fn, iters: int, passes=PV_PASSES, prefix="pv_phase_") -> dict:
    """Device ms per call of each of a kernel's passes (its kernel's name
    holds <prefix><pass>; the phase path's by default), from torch.profiler
    over ``iters`` calls of ``fn``; {} if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0))
        for name in passes:
            if f"{prefix}{name}" in event.key and us > 0:
                out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


@contextlib.contextmanager
def recorded_pv_steps(steps):
    """Every streaming PV step run inside this block appends (its plan,
    its frames: the next frame's index minus the one it started from) to
    ``steps``."""
    from nodey_tpu_torch.ops import pv

    step = pv.pv_stream_step

    def recording(plan, state, *args):
        out = step(plan, state, *args)
        steps.append((plan, out[0].k - state.k))
        return out

    pv.pv_stream_step = recording
    try:
        yield
    finally:
        pv.pv_stream_step = step


def streamed_master(graph, device: str, chunk_seconds: float):
    """The export master of ``graph`` through the streaming executor on
    ``device`` (float32 wire), [C, n] on the host."""
    import numpy as np

    from nodey_tpu_torch.core.stream_executor import StreamExecutor

    blocks = []
    StreamExecutor(graph, mode="export", chunk_seconds=chunk_seconds,
                   device=device).run(sink=lambda b: blocks.append(np.array(b)))
    return np.concatenate(blocks, axis=1)


def snr_by_window(reference, test, seconds: int = 30, rate: int = 48_000):
    """The SNR of each ``seconds`` of two [C, n] masters (config 4's
    output is 48 kHz)."""
    window = seconds * rate
    return [snr_db(reference[:, i : i + window], test[:, i : i + window])
            for i in range(0, reference.shape[1], window)]


def lock_work_bound(shape):
    """The lock's bound on [C, K, B] planes: four read and two written once;
    ~15 operations per element, each transcendental counted as one."""
    n = math.prod(shape)
    return bound(4 * 6 * n, 15 * n)


def stream_pv_phase(cli, card: str, dev, tmp: str, track1, track_path: str,
                    excerpt4: str, short_track: str):
    """Phase 19 (see the module docstring). ``track1``: phase 6's 300 s
    track [2, n] float32 on the host; ``track_path``: the config-4 track
    whose offline PV renders phases 10 and 11 exported
    (``config4_pv*.json`` and ``.wav`` in ``tmp``); ``excerpt4``: its 10 s
    excerpt; ``short_track``: a 100 s track. Returns (launch counts by path,
    the lock's figures at both chunk shapes, its worst max|kernel - plain|
    in the steps)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core import chunkflow
    from nodey_tpu_torch.core.compiler import SourceSpec
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import decode_file
    from nodey_tpu_torch.ops import cuda_pv, pv
    from nodey_tpu_torch.ops import resample as tr
    from nodey_tpu_torch.tools.pv_phase_ab import chunk_frames

    tag = "19 stream-pv"
    chunk = STREAM_CHUNK_SECONDS * RATE
    kernel_lock, kernel_resampler = pv.lock_phases, tr.apply_filter_bank
    lock_checks, lock_in, seen, resample_errs = [], {}, {}, []

    def checked_lock(cos_phi, sin_phi, ph, mag):
        """The lock kernel, held against the plain lock on its inputs."""
        got = kernel_lock(cos_phi, sin_phi, ph, mag)
        lock_checks.append(lock_against_plain(got, (cos_phi, sin_phi, ph,
                                                    mag)))
        check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
              f"{tag}: the lock kernel gave a value that is not finite")
        K = mag.shape[1]
        seen[K] = seen.get(K, 0) + 1
        if seen[K] == STREAM_LOCK_TIMED_STEP:
            lock_in[K] = tuple(t.clone() for t in (cos_phi, sin_phi, ph, mag))
        return got

    def checked_resampler(x, G, M, W, bank, support):
        """The resampler kernel, held against the plain resampler on its
        operands."""
        got = kernel_resampler(x, G, M, W, bank, support)
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        resample_errs.append((list(x.shape), M, bank.shape[0],
                              (got - want).abs().max().item()))
        check(bool(torch.isfinite(got).all()),
              f"{tag}: the resampler kernel gave a value that is not finite")
        return got

    def drive(lock, resampler=None):
        """Config 4 on the PV streamed at 16 s chunks on track1, the graph's
        chunk steps driven by hand with ``lock`` (and ``resampler``) in
        place of the dispatchers; returns (master on the host, steps, the
        PV stage steps that had frames)."""
        graph = config4_graph(track_path, algorithm="pv")
        compiled = chunkflow.compile_stream_graph(
            graph, {(0, "output_0"): SourceSpec(
                rate=RATE, channels=2, fmt="flt", capacity=chunk)},
            device=CARD)
        saved = pv.lock_phases, tr.apply_filter_bank
        pv.lock_phases, tr.apply_filter_bank = lock, resampler or saved[1]
        parts, pos, steps, pv_steps = [], 0, 0, []
        try:
            with recorded_pv_steps(pv_steps):
                states = compiled.init_states
                while True:
                    n = max(0, min(chunk, track1.shape[1] - pos))
                    block = torch.zeros((2, chunk), device=dev)
                    block[:, :n] = torch.from_numpy(
                        track1[:, pos : pos + n]).to(dev)
                    pos += chunk
                    states, outs = compiled.step(states, {"n0:output_0": (
                        block, n, pos >= track1.shape[1])})
                    steps += 1
                    data, n_out, finished = outs["master"]
                    parts.append(data[:, :n_out].clone())
                    if finished:
                        break
        finally:
            pv.lock_phases, tr.apply_filter_bank = saved
        check(len(pv_steps) == 2 * steps, f"{tag}: {len(pv_steps)} PV stage "
              f"steps in {steps} graph steps")
        with_frames = [(plan.k_cap, frames) for plan, frames in pv_steps
                       if frames]
        return torch.cat(parts, dim=1).cpu().numpy(), steps, with_frames

    # Every launch of both kernels inside the steps is held against its
    # plain version on its own operands. The master bar swaps the lock
    # only, as phase 10 swaps only the phase path: with the plain resampler
    # as well, the first PV stage reads inputs that differ by ulps, and the
    # PV turns on the last bits of its analysis (a wrap decided otherwise
    # rotates a bin for the rest of the clip), so for the resampler the
    # per-launch check is the bar.
    zero_counts()
    kernels, steps, with_frames = drive(checked_lock, checked_resampler)
    hand = read_counts()
    plain_lock, _, _ = drive(pv._lock_to_peaks)
    check(kernels.shape == plain_lock.shape,
          f"{tag}: masters {kernels.shape}, {plain_lock.shape}")
    lock_err = max(err for err, _, _ in lock_checks)
    lock_bitwise = sum(differ == 0 for _, differ, _ in lock_checks)
    lock_finite = sum(finite for *_, finite in lock_checks)
    resample_err = max(err for *_, err in resample_errs)
    lock_db = snr_db(plain_lock, kernels)
    master_differ = int(np.count_nonzero(kernels != plain_lock))
    print(f"[{tag}] config 4 on the PV, {SECONDS} s at {STREAM_CHUNK_SECONDS} s "
          f"chunks, driven by hand: {steps} steps, {len(with_frames)} PV stage "
          f"steps with frames (k_cap {sorted(set(k for k, _ in with_frames))},"
          f" frames {min(f for _, f in with_frames)}.."
          f"{max(f for _, f in with_frames)} a step), {hand['pv_lock']} lock "
          f"launches at K {sorted(seen)}; every "
          f"launch against the plain lock on its inputs: max|kernel - plain| "
          f"{lock_err:.3e} (tol {TOL:.0e}), {lock_bitwise} of "
          f"{len(lock_checks)} launches bitwise ({lock_finite} on finite "
          f"inputs); {hand['polyphase_resample']} "
          f"resampler launches (x, M, L: "
          f"{sorted(set((tuple(x), M, L) for x, M, L, _ in resample_errs))}), "
          f"every one against the plain resampler on its operands: "
          f"max|kernel - plain| {resample_err:.3e} (tol {TOL:.0e}); master "
          f"{list(kernels.shape)} through the kernels vs the same steps with "
          f"the plain lock: SNR {lock_db:.1f} dB (min {PV_EXCERPT_DB:.0f}), "
          f"{master_differ} of {kernels.size} samples not bitwise it "
          f"({card})")
    check(hand["pv_lock"] == len(lock_checks) == len(with_frames) > 0,
          f"{tag}: {hand['pv_lock']} lock launches, {len(with_frames)} stage "
          "steps with frames")
    check(hand["polyphase_resample"] == len(resample_errs) >= steps,
          f"{tag}: {hand['polyphase_resample']} resampler launches, "
          f"{len(resample_errs)} checked, in {steps} steps")
    check(hand["pv_phase_path"] == 0,
          f"{tag}: the phase-path kernel launched in a hand-driven step")
    plans = sorted(set(k for k, _ in with_frames))
    shapes = sorted(chunk_frames(STREAM_CHUNK_SECONDS, RATE).values())
    check(sorted(seen) == plans == shapes, f"{tag}: the lock saw K "
          f"{sorted(seen)}, the plans' k_cap {plans}, phase 9's chunk shapes "
          f"{shapes}")
    check(lock_err <= TOL, f"{tag}: the lock kernel disagrees inside a step")
    check(all(differ == 0 for _, differ, finite in lock_checks if finite),
          f"{tag}: the lock kernel is not bitwise the plain lock inside a "
          "step")
    check(resample_err <= TOL,
          f"{tag}: the resampler kernel disagrees inside a step")
    check(lock_db >= PV_EXCERPT_DB,
          f"{tag}: the streamed PV through the lock kernel disagrees with the "
          f"plain lock")
    check(master_differ == 0 or lock_finite < len(lock_checks),
          f"{tag}: the streamed PV through the lock kernel is not bitwise the "
          "plain lock's")
    check(bool(np.isfinite(kernels).all()), f"{tag}: master not finite")
    del kernels, plain_lock

    # `run --stream --export`, every step under the sync debug mode, plain
    # and with both options; the PV's lock runs once in every stage step
    # that has frames.
    offline = {}
    streamed = {}
    for name, suffix in (("plain", ""), ("options", "_options")):
        proj = os.path.join(tmp, f"config4_pv{suffix}.json")
        out_wav = os.path.join(tmp, f"config4_pv{suffix}_streamed.wav")
        spans, pv_steps = [], []
        zero_counts()
        with checked_steps(spans), recorded_pv_steps(pv_steps):
            rc, text, metrics = stream_export(cli, proj, out_wav)
        counts = read_counts()
        print("\n".join(f"[{tag}] {name} cli: {line}"
                        for line in text.splitlines()))
        check(rc == 0 and metrics is not None,
              f"{tag}: {name}: run --stream exited {rc} or did not stream")
        got = decode_file(out_wav).data
        with_frames = sum(frames > 0 for _, frames in pv_steps)
        print(f"[{tag}] {name}: streamed master {list(got.shape)}, finite "
              f"{bool(np.isfinite(got).all())}; {metrics.steps} steps under "
              f"sync debug mode 'error' ({len(spans)} checked), {len(pv_steps)} "
              f"PV stage steps of which {with_frames} with frames; launches "
              f"{counts} ({card})")
        check(got.shape == (2, CONFIG4_LENGTH),
              f"{tag}: {name}: master {got.shape}, want (2, {CONFIG4_LENGTH})")
        check(bool(np.isfinite(got).all()), f"{tag}: {name}: master not finite")
        check(len(spans) == metrics.steps >= 4 and len(pv_steps) == 2 * len(spans),
              f"{tag}: {name}: {len(spans)} checked steps of {metrics.steps}")
        check(counts["pv_lock"] == with_frames > 0,
              f"{tag}: {name}: {counts['pv_lock']} lock launches, "
              f"{with_frames} stage steps with frames")
        check(counts["pv_phase_path"] == 0,
              f"{tag}: {name}: the phase-path kernel launched")
        offline[name] = decode_file(os.path.join(tmp, f"config4_pv{suffix}.wav")).data
        streamed[name] = dict(counts=counts, device_ms=sum(
            a.elapsed_time(b) for a, b in spans), master=got)
    full_db = {name: snr_db(offline[name], streamed[name]["master"])
               for name in offline}
    # Where the 300 s export departs from the offline render: the SNR of
    # each 30 s of output (a wrap decided otherwise shows as a step).
    got, want = streamed["plain"]["master"], offline["plain"]
    by_window = snr_by_window(want, got)
    for record in streamed.values():
        del record["master"]
    del offline, got, want

    # Streamed against offline: the 10 s excerpt on the card and on the CPU
    # (at 2 s chunks, so the carries cross chunks), and the 300 s exports.
    excerpt_db = {}
    for device in (CARD, "cpu"):
        graph = config4_graph(excerpt4, algorithm="pv")
        want = Runner(graph, device=device).render("export").master
        got = streamed_master(config4_graph(excerpt4, algorithm="pv"), device,
                              STREAM_EXCERPT_CHUNK_SECONDS)
        check(got.shape == want.shape,
              f"{tag}: {device}: excerpt streamed {got.shape}, offline "
              f"{want.shape}")
        excerpt_db[device] = snr_db(want, got)
    print(f"[{tag}] streamed vs offline: {EXCERPT_SECONDS} s excerpt at "
          f"{STREAM_EXCERPT_CHUNK_SECONDS} s chunks on the card SNR "
          f"{excerpt_db[CARD]:.1f} dB (min {PV_DEVICE_DB:.0f}), on the CPU "
          f"{excerpt_db['cpu']:.1f} dB; {SECONDS} s exports at "
          f"{STREAM_CHUNK_SECONDS} s chunks on the card: {full_db['plain']:.1f} "
          f"dB, with both options {full_db['options']:.1f} dB; the plain "
          f"export by 30 s of output: "
          f"{', '.join(f'{db:.1f}' for db in by_window)} dB ({card})")
    check(excerpt_db[CARD] >= PV_DEVICE_DB,
          f"{tag}: the streamed PV excerpt disagrees with the offline render")

    # A witness at length for the 300 s figure's fall: the same clip where
    # only ulps differ and no chunk carry runs (offline on the card against
    # offline on the CPU), and where the same plain math runs chunked and
    # whole (streamed against offline on the CPU), by 30 s of output.
    cpu_offline = Runner(config4_graph(track_path, algorithm="pv"),
                         device="cpu").render("export").master
    card_offline = Runner(config4_graph(track_path, algorithm="pv"),
                          device=CARD).render("export").master
    cpu_streamed = streamed_master(config4_graph(track_path, algorithm="pv"),
                                   "cpu", STREAM_CHUNK_SECONDS)
    check(cpu_offline.shape == card_offline.shape == cpu_streamed.shape,
          f"{tag}: {SECONDS} s masters {cpu_offline.shape}, "
          f"{card_offline.shape}, {cpu_streamed.shape}")
    witness = {
        "card offline vs CPU offline": (cpu_offline, card_offline),
        "CPU streamed vs CPU offline": (cpu_offline, cpu_streamed),
    }
    for name, (want, got) in witness.items():
        print(f"[{tag}] witness, {SECONDS} s, {name}: SNR "
              f"{snr_db(want, got):.1f} dB; by 30 s of output: "
              f"{', '.join(f'{db:.1f}' for db in snr_by_window(want, got))} "
              f"dB ({card})")
    del cpu_offline, card_offline, cpu_streamed, witness

    # Device memory over a whole export at 100 s and at 300 s (after the
    # exports above, so the one-time bases are in place), and the offline
    # render's.
    proj = os.path.join(tmp, "config4_pv.json")
    short_proj = project_with_tracks(
        proj, [short_track], os.path.join(tmp, f"config4_pv_{SHORT_SECONDS}s.json"))
    out_wav = os.path.join(tmp, "config4_pv_memory.wav")
    peaks = {}
    for seconds, project in ((SHORT_SECONDS, short_proj), (SECONDS, proj)):
        result = []
        peaks[seconds] = device_peak(lambda: result.append(
            stream_export(cli, project, out_wav)))
        check(result[0][0] == 0 and result[0][2] is not None,
              f"{tag}: the {seconds} s streamed export failed")
    offline_peak = device_peak(lambda: Runner(
        cli._load_graph(proj), device=CARD).render("export"))
    print(f"[{tag}] peak device memory of a whole streamed export "
          f"{peaks[SHORT_SECONDS] / 2**20:.1f} MiB at {SHORT_SECONDS} s, "
          f"{peaks[SECONDS] / 2**20:.1f} MiB at {SECONDS} s (max "
          f"+{STREAM_SLACK_BYTES / 2**20:.0f} MiB); offline PV render "
          f"{offline_peak / 2**20:.1f} MiB ({card})")
    check(peaks[SECONDS] <= peaks[SHORT_SECONDS] + STREAM_SLACK_BYTES,
          f"{tag}: streamed device memory grows with clip length")
    check(peaks[SECONDS] < offline_peak,
          f"{tag}: streaming took more memory than the offline render")

    # Times: the lock per launch at both chunk shapes (a mid-clip step's
    # inputs), and the export's wall RTF.
    lock_times = {}
    for K, planes in sorted(lock_in.items(), reverse=True):
        fns = {"kernel": lambda: cuda_pv.lock_to_peaks_cuda(*planes),
               "plain": lambda: pv._lock_to_peaks(*planes)}
        runs = {name: [] for name in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name] += cuda_ms(fns[name], LOCK_TIMED_LAUNCHES // 2,
                                  warmup=1, queued=True)
        lock_times[K] = {name: summary(runs[name])[0] for name in fns}
        lock_times[K]["bound"] = lock_work_bound(planes[3].shape)
        lock_times[K]["shape"] = list(planes[3].shape)
        for name in fns:
            med, lo, hi, count = summary(runs[name])
            print(f"[{tag}] times: lock at {list(planes[3].shape)}, {name}: "
                  f"median {med:.4f} ms per launch (min {lo:.4f}, max {hi:.4f}, "
                  f"n={count}) ({card})")
        ms, by = lock_times[K]["bound"]
        print(f"[{tag}] times: lock bound at {list(planes[3].shape)}: {ms:.4f} "
              f"ms by {by}; kernel at {ms / lock_times[K]['kernel']:.2%} of it "
              f"({card})")
    runs = []
    for _ in range(STREAM_TIMED_RUNS):
        rc, _text, m = stream_export(cli, proj, out_wav)
        check(rc == 0 and m is not None, f"{tag}: a timed streamed export failed")
        runs.append(m)
    runs.sort(key=lambda r: r.rtf)
    m = runs[len(runs) // 2]
    print(f"[{tag}] times: config 4 on the PV streamed ({SECONDS} s, "
          f"{STREAM_CHUNK_SECONDS} s chunks, WAV sink, nothing instrumented): "
          f"wall RTF median {m.rtf:.1f} (min {runs[0].rtf:.1f}, max "
          f"{runs[-1].rtf:.1f}, n={len(runs)}); the median export: "
          f"{m.audio_seconds:.3f} audio-s in {m.wall_seconds:.4f} s wall, "
          f"{m.steps} steps, plan {m.compile_seconds:.4f} s, decode wait "
          f"{m.decode_wait_seconds:.4f} s, egress wait "
          f"{m.egress_wait_seconds:.4f} s, d2h busy {m.d2h_busy_seconds:.4f} "
          f"s, sink busy {m.sink_busy_seconds:.4f} s; the steps' device span "
          f"(CUDA events around each step of the checked export) "
          f"{streamed['plain']['device_ms']:.4f} ms, with both options "
          f"{streamed['options']['device_ms']:.4f} ms ({card})")
    paths = {"config4_pv_streamed": streamed["plain"]["counts"],
             "config4_pv_options_streamed": streamed["options"]["counts"]}
    return paths, lock_times, lock_err


def realtime_and_chunked_phases(cli, card: str, tmp: str, proj_5node: str,
                                excerpt_tracks):
    """Phases 20 and 21 (see the module docstring). ``proj_5node``: phase
    4's 300 s project; ``excerpt_tracks``: its 10 s tracks. Returns the
    launch counts of both paths, by path."""
    import numpy as np

    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.core.streaming import StreamingSession, render_chunked
    from nodey_tpu_torch.host import playback
    from nodey_tpu_torch.host.decode import decode_file

    # -- 20. realtime ------------------------------------------------------------
    tag = "20 realtime"
    proj = project_with_tracks(proj_5node, excerpt_tracks,
                               os.path.join(tmp, "two_track_mix_10s.json"))
    out_wav = os.path.join(tmp, "realtime.wav")
    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["run", proj, "--realtime", "--preview", out_wav,
                       "--device", CARD])
    counts_rt = read_counts()
    text = stdout.getvalue()
    print("\n".join(f"[{tag}] cli: {line}" for line in text.splitlines()))
    check(rc == 0, f"{tag}: run --realtime exited {rc}")
    words = text.split()
    audio_s, wall = float(words[1]), float(words[4])
    sdl = playback.device_available()
    print(f"[{tag}] {audio_s:.2f} audio-s in {wall:.2f} s wall "
          f"({wall / audio_s:.4f}x the audio, min 0.98); SDL device "
          f"{'present' if sdl else 'absent: paced by the wall clock'}; "
          f"launches {counts_rt} ({card})")
    check(wall >= 0.98 * audio_s, f"{tag}: the realtime preview ran ahead")
    check(counts_rt["polyphase_resample"] >= 1,
          f"{tag}: the resampler did not run")
    reference = Runner(cli._load_graph(proj), device=CARD).preview().master
    check(decode_file(out_wav).data.shape == reference.shape,
          f"{tag}: the preview WAV's shape")
    got = {}
    for streamed in (True, False):
        session = StreamingSession(cli._load_graph(proj), device=CARD).start(
            streamed=streamed)
        blocks = list(session.blocks())
        session.stop()
        got[streamed] = (np.concatenate(blocks, axis=1), session.stats)
    streamed_db = snr_db(reference, got[True][0])
    whole_same = np.array_equal(reference, got[False][0])
    print(f"[{tag}] sessions vs Runner.preview() {list(reference.shape)}: "
          f"streamed {list(got[True][0].shape)} SNR {streamed_db:.1f} dB (min "
          f"120), first block after {got[True][1].first_block_seconds:.4f} s, "
          f"{got[True][1].underruns} underruns; whole-clip "
          f"{'bitwise equal' if whole_same else 'DIFFERS'}, first block after "
          f"{got[False][1].first_block_seconds:.4f} s ({card})")
    check(got[True][0].shape == reference.shape and streamed_db >= 120.0,
          f"{tag}: the streamed session disagrees with the preview render")
    check(whole_same, f"{tag}: the whole-clip session is not the preview")
    del reference, got

    # -- 21. chunked ------------------------------------------------------------
    tag = "21 chunked"
    graph = cli._load_graph(proj_5node)
    whole = Runner(graph, device=CARD).render("export")
    progress = []
    result = []
    zero_counts()
    chunked_peak = device_peak(lambda: result.append(render_chunked(
        graph, progress=progress.append, device=CARD)))
    counts_chunked = read_counts()
    master, rate, _fmt, spectra = result[0]
    offline_peak = device_peak(lambda: Runner(graph, device=CARD).render(
        "export"))
    db = snr_db(whole.master, master)
    [key] = whole.spectra
    frames = (master.shape[1] - 1024) // 512 + 1
    spec = spectra.get(key)
    spec_db = (snr_db(whole.spectra[key][:, :frames], spec)
               if spec is not None and spec.shape[1] == frames else -math.inf)
    print(f"[{tag}] render_chunked, {SECONDS} s 5-node graph, {len(progress)} "
          f"chunks of 30 s: master {list(master.shape)} at {rate} Hz vs the offline "
          f"render {list(whole.master.shape)}: SNR {db:.1f} dB (min 130); "
          f"spectrum {list(spec.shape) if spec is not None else None}, "
          f"{frames} frames in the clip, SNR {spec_db:.1f} dB against the "
          f"offline spectrum's first {frames} frames of "
          f"{whole.spectra[key].shape[1]}; resampler launches "
          f"{counts_chunked['polyphase_resample']} "
          f"({counts_chunked['polyphase_resample'] / len(progress):g} per "
          f"chunk); peak device memory {chunked_peak / 2**20:.1f} MiB, "
          f"offline render {offline_peak / 2**20:.1f} MiB ({card})")
    check(master.shape == whole.master.shape and db >= 130.0,
          f"{tag}: the chunked master disagrees with the offline render")
    check(spec is not None and spec.shape[1] == frames and spec_db >= SNR_DB,
          f"{tag}: the chunked spectrum disagrees with the offline render")
    check(counts_chunked["polyphase_resample"] >= 2 * len(progress),
          f"{tag}: resampler launched {counts_chunked['polyphase_resample']}")
    check(chunked_peak < offline_peak,
          f"{tag}: chunked rendering took more memory than the offline one")
    return {"realtime": counts_rt, "5node_chunked": counts_chunked}


# -- BASELINE configs 1, 2, 3 and 5 (phases 22-24) ------------------------------


def bench_tone(n: int, rate: int, f0: float, channels: int, seed: int):
    """bench.py's ``_tone``: a tone, its 3.1x partial and a little noise,
    [channels, n] float32 (the second channel the first rolled by 211)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    base = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 3.1 * f0 * t)
    ch0 = (base + 0.02 * rng.standard_normal(n)).astype(np.float32)
    if channels == 1:
        return ch0[None, :]
    return np.stack([ch0, np.roll(ch0, 211)])


def write_bench_tracks(directory: str, seconds: int, tag: str):
    """bench.py's tracks as s16 WAVs at 44.1 kHz: (config 1's mono track,
    the four stereo tracks that configs 2, 3 and 5 read the first one, two
    and four of)."""
    from nodey_tpu_torch.host.decode import write_wav_s16

    n = RATE * seconds
    mono = os.path.join(directory, f"bench_mono_{tag}.wav")
    write_wav_s16(mono, bench_tone(n, RATE, 220.0, 1, 0), RATE)
    stereo = []
    for i in range(4):
        path = os.path.join(directory, f"bench_stereo_{i}_{tag}.wav")
        write_wav_s16(path, bench_tone(n, RATE, 220.0 * (i + 1), 2, i), RATE)
        stereo.append(path)
    return mono, stereo


def _input_graph(paths):
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.audio_input import AudioInput

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    return g, src


def _gain(g, volume: float):
    from nodey_tpu_torch.processors.audio_vol import AudioVol

    node = g.add_node(AudioVol())
    g.nodes[node].processor.set_volume(volume)
    return node


def _split_merge(g, from_pin: int, gains):
    """Split -> a gain on each channel -> bimix (bias 0); returns the bimix
    node."""
    from nodey_tpu_torch.processors.bimix import AudioBimix
    from nodey_tpu_torch.processors.split import AudioSplit

    split = g.add_node(AudioSplit())
    vl, vr = _gain(g, gains[0]), _gain(g, gains[1])
    merge = g.add_node(AudioBimix())
    g.add_link(from_pin, _pin(g, split, "input"))
    g.add_link(_pin(g, split, "output_l"), _pin(g, vl, "input"))
    g.add_link(_pin(g, split, "output_r"), _pin(g, vr, "input"))
    g.add_link(_pin(g, vl, "output"), _pin(g, merge, "input_l"))
    g.add_link(_pin(g, vr, "output"), _pin(g, merge, "input_r"))
    return merge


def _amix(g, volumes):
    from nodey_tpu_torch.processors.amix import AudioAmix

    amix = g.add_node(AudioAmix())
    g.nodes[amix].processor.set_input_num(len(volumes))
    g.nodes[amix].processor.volumes = list(volumes)
    g.update_node_pin(amix)
    return amix


def _output(g, from_pin: int) -> None:
    from nodey_tpu_torch.processors.audio_output import AudioOutput

    out = g.add_node(AudioOutput())
    g.add_link(from_pin, _pin(g, out, "input"))


def config1_graph(paths):
    """bench.py:108-120: the mono track -> gain 1.2 -> output (export)."""
    g, src = _input_graph(paths[:1])
    vol = _gain(g, 1.2)
    g.add_link(_pin(g, src, "output_0"), _pin(g, vol, "input"))
    _output(g, _pin(g, vol, "output"))
    return g


def config2_graph(paths):
    """bench.py:123-145: track 0 -> split -> gains 0.8 and 1.4 -> bimix ->
    output (export)."""
    g, src = _input_graph(paths[:1])
    merge = _split_merge(g, _pin(g, src, "output_0"), (0.8, 1.4))
    _output(g, _pin(g, merge, "output"))
    return g


def config3_graph(paths):
    """bench.py:148-169: tracks 0 and 1 -> gains 1.5 and 0.9 -> amix
    0.6/0.4 -> output (export)."""
    g, src = _input_graph(paths[:2])
    v0, v1 = _gain(g, 1.5), _gain(g, 0.9)
    amix = _amix(g, (0.6, 0.4))
    g.add_link(_pin(g, src, "output_0"), _pin(g, v0, "input"))
    g.add_link(_pin(g, src, "output_1"), _pin(g, v1, "input"))
    g.add_link(_pin(g, v0, "output"), _pin(g, amix, "input_1"))
    g.add_link(_pin(g, v1, "output"), _pin(g, amix, "input_2"))
    _output(g, _pin(g, amix, "output"))
    return g


def config5_graph(paths):
    """bench.py:258-300: track 0 split -> gains 0.7 and 1.3 -> bimix; track
    1 -> pitch -3; the four branches -> amix 0.3/0.3/0.2/0.2 -> spectrum ->
    output (preview)."""
    from nodey_tpu_torch.processors.spectrum import AudioSpectrum
    from nodey_tpu_torch.processors.velocity import PitchModifier

    g, src = _input_graph(paths[:4])
    merge = _split_merge(g, _pin(g, src, "output_0"), (0.7, 1.3))
    pitch = g.add_node(PitchModifier())
    g.nodes[pitch].processor.pitch = CONFIG5_PITCH
    g.add_link(_pin(g, src, "output_1"), _pin(g, pitch, "input"))
    amix = _amix(g, (0.3, 0.3, 0.2, 0.2))
    g.add_link(_pin(g, merge, "output"), _pin(g, amix, "input_1"))
    g.add_link(_pin(g, pitch, "output"), _pin(g, amix, "input_2"))
    g.add_link(_pin(g, src, "output_2"), _pin(g, amix, "input_3"))
    g.add_link(_pin(g, src, "output_3"), _pin(g, amix, "input_4"))
    spec = g.add_node(AudioSpectrum())
    g.add_link(_pin(g, amix, "output"), _pin(g, spec, "input"))
    _output(g, _pin(g, spec, "output"))
    return g


def write_project(graph, path: str) -> str:
    with open(path, "w") as f:
        json.dump(graph.serialize(), f)
    return path


def device_rtf(tag: str, what: str, graph, mode: str, card: str,
               iters: int = 5, warmup: int = 1, profile=None) -> float:
    """The graph's whole device render by CUDA events (after a first
    render, whose device peak above its inputs is printed): audio-seconds
    per device-second, printed and returned. ``profile`` (tag, what): then
    one render under torch.profiler (profile_render)."""
    import torch

    from nodey_tpu_torch.core.runner import Runner

    runner = Runner(graph, device=CARD)
    arrays, lengths, sources = runner.decode()
    compiled = runner.compile(sources, mode)
    args = runner.ingest(arrays, lengths)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    outputs, meta = compiled(args)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    key = "master" if mode == "export" else "preview"
    audio_s = outputs[key][1] / meta[key]["rate"]
    del outputs
    med, lo, hi, count = summary(cuda_ms(lambda: compiled(args), iters,
                                         warmup=warmup))
    rtf = audio_s / (med / 1e3)
    print(f"[{tag}] {what}, {audio_s:.3f} audio-s ({mode}): device render "
          f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}), RTF "
          f"{rtf:.1f} audio-s per device-s; peak {peak:.2f} GiB above its "
          f"inputs ({card})")
    if profile:
        profile_render(lambda: compiled(args), card, *profile)
    return rtf


def card_vs_cpu(tag: str, what: str, make_graph, mode: str, card: str,
                bitwise: bool = False) -> float:
    """The graph rendered on the card and on the CPU: equal shapes, the
    master bitwise (``bitwise``) or within TOL, every spectrum >= SNR_DB.
    Returns max|card - cpu| of the master."""
    import numpy as np

    from nodey_tpu_torch.core.runner import Runner

    on_card = Runner(make_graph(), device=CARD).render(mode)
    on_cpu = Runner(make_graph(), device="cpu").render(mode)
    check(on_card.master.shape == on_cpu.master.shape,
          f"{tag}: {what}: master {on_card.master.shape} on the card, "
          f"{on_cpu.master.shape} on the CPU")
    err = float(np.abs(on_card.master - on_cpu.master).max())
    spectra = {key: snr_db(on_cpu.spectra[key], on_card.spectra[key])
               for key in on_cpu.spectra}
    print(f"[{tag}] {what}, {CONFIG_CHECK_SECONDS} s clips ({mode}): master "
          f"{list(on_card.master.shape)} {on_card.fmt}, max|card - cpu| = "
          f"{err:.3e} ({'bitwise' if bitwise else f'tol {TOL:.0e}'}); spectra"
          f" SNR {({k: round(v, 1) for k, v in spectra.items()})} (min "
          f"{SNR_DB:.0f} dB) ({card})")
    check(err == 0.0 if bitwise else err <= TOL,
          f"{tag}: {what}: the card's master disagrees with the CPU's")
    check(all(db >= SNR_DB for db in spectra.values()),
          f"{tag}: {what}: the card's spectrum disagrees with the CPU's")
    return err


@contextlib.contextmanager
def recorded_launches(resamples=None, chains=None, chunk_chains=None,
                      phase_paths=None, locks=None):
    """Inside the block, every launch of the resampler kernel appends its
    operands and the kernel's output to ``resamples``, every offline WSOLA
    chain its operands and the kernel's (bs, body) to ``chains``, every
    chunk-chain launch (K > 0) its operands and the kernel's (bs, body,
    tail_out) to ``chunk_chains``, every phase-path launch ((re, im, dpos,
    hop, n_fft, lock), its planes) to ``phase_paths`` and every lock launch
    ((cos_phi, sin_phi, ph, mag), its planes) to ``locks`` (each list that
    is given). Clones, taken on the stream of the launch, so no streamed
    step syncs: they are held against the plain versions after the path's
    counts are read."""
    from nodey_tpu_torch.ops import pv, wsola
    from nodey_tpu_torch.ops import resample as tr

    saved = (tr.apply_filter_bank, wsola.wsola_chain, wsola.wsola_chunk_chain,
             pv.phase_path, pv.lock_phases)
    resampler, chain, chunk_chain, phase_path, lock_phases = saved

    def recording_resampler(x, G, M, W, bank, support):
        got = resampler(x, G, M, W, bank, support)
        resamples.append(((x.clone(), G, M, W, bank, support), got.clone()))
        return got

    def recording_chain(x, head, *args):
        out = chain(x, head, *args)
        chains.append((x.clone(), head.clone(), args, out))
        return out

    def recording_chunk_chain(*a):
        out = chunk_chain(*a)
        if a[4]:
            chunk_chains.append(((a[0].clone(), a[1].clone(), *a[2:]),
                                 tuple(t.clone() for t in out)))
        return out

    def recording_phase_path(re, im, dpos, hop, n_fft, lock=True):
        out = phase_path(re, im, dpos, hop, n_fft, lock)
        phase_paths.append(((re.clone(), im.clone(), dpos, hop, n_fft, lock),
                            tuple(t.clone() for t in out)))
        return out

    def recording_lock(*planes):
        out = lock_phases(*planes)
        locks.append((tuple(t.clone() for t in planes),
                      tuple(t.clone() for t in out)))
        return out

    if resamples is not None:
        tr.apply_filter_bank = recording_resampler
    if chains is not None:
        wsola.wsola_chain = recording_chain
    if chunk_chains is not None:
        wsola.wsola_chunk_chain = recording_chunk_chain
    if phase_paths is not None:
        pv.phase_path = recording_phase_path
    if locks is not None:
        pv.lock_phases = recording_lock
    try:
        yield
    finally:
        (tr.apply_filter_bank, wsola.wsola_chain, wsola.wsola_chunk_chain,
         pv.phase_path, pv.lock_phases) = saved


def check_resamples(tag: str, resamples, launched: int, card: str) -> float:
    """Every recorded resampler launch (recorded_launches) against the
    plain resampler on its operands: finite and within TOL, and as many
    recorded launches as the path's count ``launched``. One line for each
    (x's shape, L/M); returns the worst max|kernel - plain|."""
    import torch

    from nodey_tpu_torch.ops import resample as tr

    check(len(resamples) == launched, f"{tag}: {len(resamples)} resampler "
          f"launches held against plain, the path counted {launched}")
    groups = {}
    for (x, G, M, W, bank, _support), got in resamples:
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        check(bool(torch.isfinite(got).all()),
              f"{tag}: the resampler kernel gave a value that is not finite")
        key = (tuple(x.shape), bank.shape[0], M)
        count, worst = groups.get(key, (0, 0.0))
        groups[key] = (count + 1, max(worst, (got - want).abs().max().item()))
    for (shape, L, M), (count, worst) in groups.items():
        print(f"[{tag}] resampler, {count} launch(es) at x {list(shape)}, L/M "
              f"{L}/{M}: max|kernel - plain| = {worst:.3e} (tol {TOL:.0e}) "
              f"({card})")
    worst = max((w for _, w in groups.values()), default=0.0)
    check(worst <= TOL, f"{tag}: a resampler launch disagrees with plain")
    return worst


def streamed_export_checks(cli, phase: str, what: str, project: str, offline,
                           tol: float, card: str, tmp: str,
                           short_tracks=None, record=None, min_db=None,
                           min_steps: int = 4) -> dict:
    """`run --stream --export` of ``project`` on the card, every step under
    the sync debug mode (checked_steps) and inside ``record`` (a context
    manager, e.g. recorded_launches), launch counts set to 0 just before
    and read just after: exit code 0, the export streamed in >= ``min_steps``
    steps, its master equal in length to ``offline()`` (the offline render's
    master on the host) and within ``tol`` (or, given ``min_db``, at least
    that SNR against it; ``tol`` is then not held). With ``short_tracks``: the
    project exported again on them (SHORT_SECONDS) and as it is (after that
    first export, so the one-time allocations, filter banks and the DFT
    basis, are in place), the whole export's device peak each, within
    STREAM_SLACK_BYTES of each other and below the offline render's peak on
    the same project, and the two exports' host RSS rises (host_rss) within
    RSS_SLACK_BYTES of each other. Returns dict(counts, err, device_ms,
    metrics, peaks, rss)."""
    import numpy as np

    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import decode_file

    out_wav = os.path.join(tmp, f"{what}_streamed.wav")
    spans = []
    zero_counts()
    with checked_steps(spans), record or contextlib.nullcontext():
        rc, text, metrics = stream_export(cli, project, out_wav)
    counts = read_counts()
    print("\n".join(f"[{phase}] {what} cli: {line}"
                    for line in text.splitlines()))
    check(rc == 0, f"{what}: cli run --stream exited {rc}")
    check(metrics is not None, f"{what}: the export did not stream")
    got = decode_file(out_wav).data
    want = offline()
    check(got.shape == want.shape,
          f"{what}: streamed master {got.shape}, offline {want.shape}")
    err = float(np.abs(got - want).max())
    db = snr_db(want, got)
    del got, want
    device_ms = sum(a.elapsed_time(b) for a, b in spans)
    memory, peaks = "", {}
    if short_tracks is not None:
        short_project = project_with_tracks(
            project, short_tracks,
            os.path.join(tmp, f"{what}_{SHORT_SECONDS}s.json"))
        rss = {}
        for seconds, proj in ((SHORT_SECONDS, short_project),
                              (SECONDS, project)):
            result = []
            settle_host_heap()
            with host_rss(rss.setdefault(seconds, {})):
                peaks[seconds] = device_peak(lambda: result.append(
                    stream_export(cli, proj, out_wav)))
            check(result[0][0] == 0 and result[0][2] is not None,
                  f"{what}: the {seconds} s streamed export failed")
        offline_peak = device_peak(lambda: Runner(
            cli._load_graph(project), device=CARD).render("export"))
        memory = (f"; peak device memory of a whole streamed export "
                  f"{peaks[SHORT_SECONDS] / 2**20:.1f} MiB at {SHORT_SECONDS}"
                  f" s, {peaks[SECONDS] / 2**20:.1f} MiB at {SECONDS} s (max "
                  f"+{STREAM_SLACK_BYTES / 2**20:.0f} MiB), offline render "
                  f"{offline_peak / 2**20:.1f} MiB; host RSS sampled every "
                  f"5 ms: {rss_text(rss)} (max +"
                  f"{RSS_SLACK_BYTES / 2**20:.0f} MiB between them)")
    bar = (f"SNR {db:.1f} dB (min {min_db:.0f})" if min_db is not None
           else f"tol {tol:.0e}")
    print(f"[{phase}] {what}: streamed master at "
          f"{STREAM_CHUNK_SECONDS} s chunks equal in length to the offline "
          f"render ({metrics.audio_seconds:.3f} audio-s), "
          f"max|diff| {err:.3e} ({bar}); launches {counts}; "
          f"{len(spans)} steps under sync debug mode 'error', device span "
          f"{device_ms:.4f} ms{memory}; host RSS peak of this process "
          f"{metrics.rss_peak_bytes / 2**20:.0f} MiB ({card})")
    check(db >= min_db if min_db is not None else err <= tol,
          f"{what}: streamed master disagrees with offline")
    check(len(spans) == metrics.steps >= min_steps,
          f"{what}: {len(spans)} checked steps of {metrics.steps}")
    if peaks:
        check(peaks[SECONDS] <= peaks[SHORT_SECONDS] + STREAM_SLACK_BYTES,
              f"{what}: streamed device memory grows with clip length")
        check(rss_rise(rss, SECONDS)
              <= rss_rise(rss, SHORT_SECONDS) + RSS_SLACK_BYTES,
              f"{what}: streamed host memory grows with clip length")
        check(peaks[SECONDS] < offline_peak,
              f"{what}: streaming took more memory than the offline render")
    return dict(counts=counts, err=err, db=db, device_ms=device_ms,
                metrics=metrics, peaks=peaks, rss=rss if peaks else {})


class WholeClipRead:
    """The streaming executor's former read of a WAV where the codec runtime
    does not load: the whole clip at once, then sliced into chunks. Phase
    14's host RSS A/B puts it in the place of ``host_decode.WavBlockReader``
    (``reader``: the block reader, read in one block)."""

    reader = None

    def __init__(self, path: str):
        with self.reader(path) as whole:
            self._data = whole.read(whole.num_samples)
            self.rate, self.channels, self.fmt = (whole.rate, whole.channels,
                                                  whole.fmt)
        self.pts0_us = 0

    def blocks(self, n: int):
        for start in range(0, self._data.shape[1], n):
            yield self._data[:, start : start + n]

    def close(self) -> None:
        self._data = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def whole_clip_rss(cli, phase: str, what: str, project: str, short_tracks,
                   tmp: str, rss_blocks: dict, card: str) -> dict:
    """Host RSS (host_rss) of ``project``'s streamed export at
    SHORT_SECONDS (on ``short_tracks``) and SECONDS through the former
    whole-clip read (WholeClipRead), printed beside the block reader's
    (``rss_blocks``, from streamed_export_checks); returns them by clip
    length."""
    from nodey_tpu_torch.host import decode as host_decode

    out_wav = os.path.join(tmp, f"{what}_whole_clip.wav")
    short = project_with_tracks(project, short_tracks, os.path.join(
        tmp, f"{what}_{SHORT_SECONDS}s_whole.json"))
    saved = WholeClipRead.reader = host_decode.WavBlockReader
    host_decode.WavBlockReader = WholeClipRead
    rss = {}
    try:
        for seconds, proj in ((SHORT_SECONDS, short), (SECONDS, project)):
            settle_host_heap()
            with host_rss(rss.setdefault(seconds, {})):
                rc, _text, metrics = stream_export(cli, proj, out_wav)
            check(rc == 0 and metrics is not None,
                  f"{what}: the whole-clip streamed export failed")
    finally:
        host_decode.WavBlockReader = saved
    native = host_decode.load_native() is not None
    unused = "; the codec runtime loads, so neither read ran" if native else ""
    print(f"[{phase}] {what}: host RSS of a streamed export, sampled every "
          f"5 ms: the block reader {rss_text(rss_blocks)}; the former "
          f"whole-clip read {rss_text(rss)}{unused} ({card})")
    return rss


def stream_times(cli, phase: str, name: str, what: str, project: str,
                 out_wav: str, device_ms: float, card: str):
    """STREAM_TIMED_RUNS exports of ``project`` through `run --stream`,
    nothing instrumented: the wall RTF's median, and the median export's
    stage budget beside ``device_ms`` (its steps' device span, from
    streamed_export_checks), printed. Returns the median export's
    StreamMetrics."""
    runs = []
    for _ in range(STREAM_TIMED_RUNS):
        rc, _text, m = stream_export(cli, project, out_wav)
        check(rc == 0 and m is not None,
              f"{name}: a timed streamed export failed")
        runs.append(m)
    runs.sort(key=lambda r: r.rtf)
    m = runs[len(runs) // 2]
    print(f"[{phase}] {name} ({what}, {SECONDS} s, {STREAM_CHUNK_SECONDS} s "
          f"chunks, nothing instrumented): wall RTF median {m.rtf:.1f} (min "
          f"{runs[0].rtf:.1f}, max {runs[-1].rtf:.1f}, n={len(runs)}); the "
          f"median export: {m.audio_seconds:.3f} audio-s in "
          f"{m.wall_seconds:.4f} s wall, {m.steps} steps, plan "
          f"{m.compile_seconds:.4f} s, decode wait "
          f"{m.decode_wait_seconds:.4f} s, egress wait "
          f"{m.egress_wait_seconds:.4f} s, d2h busy {m.d2h_busy_seconds:.4f} "
          f"s, sink busy {m.sink_busy_seconds:.4f} s; the steps' device span "
          f"(CUDA events around each step of the checked export) "
          f"{device_ms:.4f} ms ({card})")
    return m


def config_phases(cli, card: str, tmp: str, short_track: str):
    """Phases 22-24 (see the module docstring). ``short_track``: a
    SHORT_SECONDS-long stereo track (phase 14's). Returns (launch counts by
    path, the figures for the kernels line)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.core.streaming import render_chunked
    from nodey_tpu_torch.host.decode import decode_file
    from nodey_tpu_torch.ops import cuda_resample, cuda_wsola, stretch, wsola
    from nodey_tpu_torch.ops import resample as tr

    paths, figures = {}, {}
    mono, stereo = write_bench_tracks(tmp, SECONDS, f"{SECONDS}s")
    mono30, stereo30 = write_bench_tracks(tmp, CONFIG_CHECK_SECONDS,
                                          f"{CONFIG_CHECK_SECONDS}s")
    n = RATE * SECONDS
    n48 = -(-n * 160 // 147)

    # -- 22. configs 1 and 3 -------------------------------------------------
    tag = "22 configs-1-3"
    t0 = time.perf_counter()
    resample_err = 0.0
    for name, make, tracks, tracks30, shape, bitwise in (
            ("config1", config1_graph, [mono], [mono30], (1, n), True),
            ("config3", config3_graph, stereo, stereo30, (2, n48), False)):
        proj = write_project(make(tracks), os.path.join(tmp, f"{name}.json"))
        resamples = []
        with recorded_launches(resamples):
            _, counts = cli_export(cli, proj, os.path.join(tmp, f"{name}.wav"),
                                   tag, card, shape=shape)
        paths[name] = counts
        want = 0 if name == "config1" else 2
        check(counts["polyphase_resample"] == want
              and sum(counts.values()) == want,
              f"{tag}: {name} launched {counts}, want {want} resampler "
              f"launches and nothing else")
        resample_err = max(resample_err, check_resamples(
            f"{tag}: {name}", resamples, want, card))
        del resamples
        figures[f"{name}_rtf"] = device_rtf(tag, name, make(tracks), "export",
                                            card)
        card_vs_cpu(tag, name, lambda: make(tracks30), "export", card,
                    bitwise=bitwise)
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")

    # -- 23. config 2 ----------------------------------------------------------
    tag = "23 config2"
    t0 = time.perf_counter()
    proj2 = write_project(config2_graph(stereo),
                          os.path.join(tmp, "config2.json"))
    wav2 = os.path.join(tmp, "config2.wav")
    resamples = []
    with recorded_launches(resamples):
        _, counts = cli_export(cli, proj2, wav2, tag, card, shape=(2, n48))
    paths["config2"] = counts
    check(counts["polyphase_resample"] == 2,
          f"{tag}: {counts['polyphase_resample']} resampler launches, want "
          f"one per bimix side")
    resample_err = max(resample_err, check_resamples(
        f"{tag}: offline", resamples, 2, card))
    del resamples
    figures["config2_rtf"] = device_rtf(tag, "config2", config2_graph(stereo),
                                        "export", card)
    card_vs_cpu(tag, "config2", lambda: config2_graph(stereo30), "export",
                card)

    resamples = []
    streamed = streamed_export_checks(
        cli, tag, "config2", proj2, lambda: decode_file(wav2).data,
        STREAM_MIX_TOL, card, tmp, short_tracks=[short_track],
        record=recorded_launches(resamples))
    paths["config2_streamed"] = counts = streamed["counts"]
    check(counts["polyphase_resample"] >= 2
          and sum(counts.values()) == counts["polyphase_resample"],
          f"{tag}: the streamed config 2 launched {counts}")
    resample_err = max(resample_err, check_resamples(
        f"{tag}: streamed", resamples, counts["polyphase_resample"], card))
    del resamples
    figures["config2_streamed_wall_rtf"] = stream_times(
        cli, tag, "config2_streamed_wav", "config 2, WAV sink", proj2,
        os.path.join(tmp, "config2_timed.wav"), streamed["device_ms"],
        card).rtf

    graph = cli._load_graph(proj2)
    whole = Runner(graph, device=CARD).render("export").master
    resamples = []
    zero_counts()
    with recorded_launches(resamples):
        chunked, rate, _fmt, _ = render_chunked(graph, device=CARD)
    paths["config2_chunked"] = counts = read_counts()
    db = snr_db(whole, chunked)
    print(f"[{tag}] render_chunked: master {list(chunked.shape)} at {rate} Hz"
          f" vs the offline render {list(whole.shape)}: SNR {db:.1f} dB (min "
          f"130); launches {counts} ({card})")
    check(chunked.shape == whole.shape and db >= 130.0,
          f"{tag}: the chunked master disagrees with the offline render")
    resample_err = max(resample_err, check_resamples(
        f"{tag}: chunked", resamples, counts["polyphase_resample"], card))
    del whole, chunked, resamples
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")

    # -- 24. config 5 ----------------------------------------------------------
    tag = "24 config5"
    t0 = time.perf_counter()
    proj5 = write_project(config5_graph(stereo),
                          os.path.join(tmp, "config5.json"))
    pitch = 2.0 ** (CONFIG5_PITCH / 12.0)
    num, den = stretch._rational_factor(pitch)
    resamples, chains = [], []
    with recorded_launches(resamples, chains):
        master, counts = cli_export(
            cli, proj5, os.path.join(tmp, "config5_preview.wav"), tag, card,
            shape=(2, n48), flag="--preview")
    paths["config5"] = counts
    check(float(np.abs(master).max()) <= 1.0, f"{tag}: preview not clamped")
    del master
    # Bimix sides 2, the transposition 1, amix inputs 2-4 3.
    check(counts["polyphase_resample"] == 6,
          f"{tag}: {counts['polyphase_resample']} resampler launches, want 6")
    check(len(chains) == 1, f"{tag}: {len(chains)} WSOLA chains, want 1")
    x, head, args, out = chains[0]
    geo = dict(zip(("K", "num", "den", "seq", "seek", "overlap"), args))
    blocks = -(-geo["K"] // cuda_wsola.BLOCK_FRAMES)
    check(counts["wsola_chain"] == blocks == counts["wsola_energy"],
          f"{tag}: WSOLA launches {counts}, want {blocks} each")
    check((geo["seq"], geo["seek"], geo["overlap"]) == CONFIG5_GEOMETRY,
          f"{tag}: WSOLA geometry {geo}, want seq/seek/overlap "
          f"{CONFIG5_GEOMETRY}")
    resample_err = max(resample_err, check_resamples(
        f"{tag}: offline", resamples, 6, card))
    # The transposition's operands, timed below.
    [operands] = [ops for ops, _ in resamples
                  if (ops[4].shape[0], ops[2]) == (den, num)]
    del resamples
    _, _, chain_err = check_chain(
        f"pitch {CONFIG5_PITCH:g} stage at 44.1 kHz, tempo {1 / pitch:.5f}",
        x, head, geo, card, out=out, phase=tag)
    energy_rel, energy_err = check_energy("pitch stage at 44.1 kHz", x, geo,
                                          card, phase=tag)
    figures["config5_rtf"] = device_rtf(tag, "config5", config5_graph(stereo),
                                        "preview", card, iters=3)
    card_vs_cpu(tag, "config5", lambda: config5_graph(stereo30), "preview",
                card)

    # Streamed (the pitch branch keeps the clip's duration, so the mixer's
    # inputs arrive in lockstep): every resampler launch and every launch of
    # the chain's chunk entry inside the steps held against its plain
    # version, and the chunk chain's splices of all steps against the
    # offline chain kernel's.
    resamples, chunk_calls = [], []
    streamed = streamed_export_checks(
        cli, tag, "config5", proj5, lambda: Runner(
            cli._load_graph(proj5), device=CARD).render("export").master,
        TOL, card, tmp, record=recorded_launches(
            resamples, chunk_chains=chunk_calls))
    paths["config5_streamed"] = counts = streamed["counts"]
    check(counts["wsola_chain"] >= 2 and counts["polyphase_resample"] >= 6,
          f"{tag}: the streamed config 5 launched {counts}")
    resample_err = max(resample_err, check_resamples(
        f"{tag}: streamed", resamples, counts["polyphase_resample"], card))
    del resamples
    check(sum(-(-a[4] // cuda_wsola.BLOCK_FRAMES) for a, _ in chunk_calls)
          == counts["wsola_chain"], f"{tag}: {len(chunk_calls)} chunk-chain "
          f"calls recorded for {counts['wsola_chain']} launches")
    chunk_geo = dict(zip(("num", "den", "seq", "seek", "overlap"),
                         chunk_calls[0][0][5:10]))
    streamed_bs, chunk_err = check_chunk_calls(
        "config 5 pitch stage", chunk_calls, chunk_geo, card, phase=tag)
    same = torch.equal(streamed_bs, out[0][: streamed_bs.numel()])
    print(f"[{tag}] pitch stage: splices of all {len(chunk_calls)} chunk "
          f"launches ({streamed_bs.numel()} frames) "
          f"{'equal' if same else 'DIFFER from'} the offline chain kernel's "
          f"first {streamed_bs.numel()} of K={geo['K']}; streamed wall RTF "
          f"{streamed['metrics'].rtf:.1f} (one export) ({card})")
    check(same, f"{tag}: streamed splices differ from offline")
    del chunk_calls, streamed_bs

    # Times at this path's new shapes: the -3 semitone transposition, and
    # the chain at the 44.1 kHz geometry.
    tx, G, M, W, bank, support = operands
    transpose_bound = resample_work_bound(tx, G, M, bank)
    fns = {
        "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                    tx, G, M, W, support),
        "plain": functools.partial(tr.apply_filter_bank_plain, tx, G, M, W,
                                   bank),
        "conv1d": functools.partial(F.conv1d, tx.view(2, 1, -1),
                                    bank.view(-1, 1, W), stride=M),
    }
    transpose = time_resampler(
        tag, f"{num}/{den} transposition (pitch {CONFIG5_PITCH:g}), bank "
        f"{list(bank.shape)}, x {list(tx.shape)}", fns,
        ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"), 5, card,
        transpose_bound)
    del fns, operands, tx
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (cuda_wsola.wsola_chain_cuda if name == "kernel"
              else wsola.wsola_chain_plain)
        runs[name] += cuda_ms(lambda: fn(x, head, *args), 2, warmup=1)
    K, n_cand = geo["K"], geo["seek"] + 1
    C, ov, stride = x.shape[0], geo["overlap"], geo["seq"] - geo["overlap"]
    chain_bound = bound(4 * (x.numel() + K + C * K * stride),
                        2 * C * ov * n_cand * K)
    chain = {name: summary(runs[name])[0] for name in runs}
    for name in runs:
        med, lo, hi, count = summary(runs[name])
        print(f"[{tag}] WSOLA chain at 44.1 kHz, K={K}, x {list(x.shape)}, "
              f"{name}: median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
              f"n={count}) ({card})")
    print(f"[{tag}] WSOLA chain at 44.1 kHz bound: {chain_bound[0]:.4f} ms by "
          f"{chain_bound[1]}; kernel at {chain_bound[0] / chain['kernel']:.2%}"
          f" of it; {chain['kernel'] * 1e3 / K:.4f} us per frame ({card})")
    figures["transposition_minus3"] = {
        "rate_pair": f"{num}/{den}",
        "ms": transpose["kernel"], "plain_ms": transpose["plain"],
        "bound_ms": transpose_bound[0], "bound_by": transpose_bound[1],
        "library_ms": transpose["conv1d"]}
    figures["chain_44100"] = {
        "K": K, "seek": geo["seek"], "ms": chain["kernel"],
        "plain_ms": chain["plain"], "bound_ms": chain_bound[0],
        "bound_by": chain_bound[1], "max_abs_err": chain_err,
        "energy_max_rel_err": energy_rel, "energy_max_abs_err": energy_err,
        "chunk_max_abs_err": chunk_err}
    figures["resample_err"] = resample_err
    del x, head, out, chains
    torch.cuda.synchronize()
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    return paths, figures


def masterbus_track(directory: str, seconds: int, tag: str,
                    sibilant: bool = False) -> str:
    """bench.py's config-6 track (its 220 Hz tone, 48 kHz stereo, seed 0)
    as an s16 WAV; with ``sibilant`` a 6.5 kHz burst over [1/3, 1/2) of the
    clip and the clip 50 dB down over [2/3, 5/6) of it, so the de-esser and
    the gate act. Returns its path."""
    from nodey_tpu_torch.host.decode import write_wav_s16

    n = MASTER_RATE * seconds
    x = bench_tone(n, MASTER_RATE, 220.0, 2, 0)
    if sibilant:
        add_sibilance(x)
    path = os.path.join(directory, f"master_{tag}.wav")
    write_wav_s16(path, x, MASTER_RATE)
    return path


def add_sibilance(x) -> None:
    """A 6.5 kHz burst over [1/3, 1/2) of the 48 kHz clip ``x`` [C, n] and
    the clip 50 dB down over [2/3, 5/6) of it, in place."""
    import numpy as np

    n = x.shape[1]
    ess = np.arange(n // 3, n // 2)
    x[:, ess] += (0.3 * np.sin(2 * np.pi * 6_500.0 * ess / MASTER_RATE)
                  ).astype(np.float32)
    x[:, 2 * n // 3: 5 * n // 6] *= np.float32(0.003)


def config6_graph(paths):
    """bench.py:209-237: the 48 kHz stereo track -> audio_eq (low shelf +3,
    bell 2 -4, high shelf +2 dB) -> audio_compressor (-18 dB, 4:1) ->
    audio_limiter (-1 dB) -> output (export)."""
    from nodey_tpu_torch.processors.compressor import AudioCompressor
    from nodey_tpu_torch.processors.equalizer import AudioEq
    from nodey_tpu_torch.processors.limiter import AudioLimiter

    g, src = _input_graph(paths[:1])
    eq = g.add_node(AudioEq())
    g.nodes[eq].processor.set_param("ls_gain_db", 3.0)
    g.nodes[eq].processor.set_param("p2_gain_db", -4.0)
    g.nodes[eq].processor.set_param("hs_gain_db", 2.0)
    comp = g.add_node(AudioCompressor())
    g.nodes[comp].processor.set_threshold_db(-18.0)
    g.nodes[comp].processor.set_ratio(4.0)
    lim = g.add_node(AudioLimiter())
    g.nodes[lim].processor.set_threshold_db(LIMITER_DB)
    g.add_link(_pin(g, src, "output_0"), _pin(g, eq, "input"))
    g.add_link(_pin(g, eq, "output"), _pin(g, comp, "input"))
    g.add_link(_pin(g, comp, "output"), _pin(g, lim, "input"))
    _output(g, _pin(g, lim, "output"))
    return g


def graph_a(paths, normalize: bool = True):
    """Phase 26's graph A: the track -> audio_filter (highpass 80 Hz) ->
    audio_gate -> audio_deesser -> audio_normalize (LUFS, -14) -> output;
    without ``normalize``, graph B."""
    from nodey_tpu_torch.processors.deesser import AudioDeesser
    from nodey_tpu_torch.processors.equalizer import AudioFilter
    from nodey_tpu_torch.processors.gate import AudioGate
    from nodey_tpu_torch.processors.normalize import AudioNormalize

    g, src = _input_graph(paths[:1])
    hp = AudioFilter()
    hp.set_filter_type("highpass")
    hp.set_freq(80.0)
    chain = [hp, AudioGate(), AudioDeesser()]
    if normalize:
        norm = AudioNormalize()
        norm.set_mode("lufs")
        norm.set_param("target_db", LUFS_TARGET)
        chain.append(norm)
    prev = _pin(g, src, "output_0")
    for processor in chain:
        node = g.add_node(processor)
        g.add_link(prev, _pin(g, node, "input"))
        prev = _pin(g, node, "output")
    _output(g, prev)
    return g


def card_vs_cpu_db(tag: str, what: str, make_graph, min_db: float,
                   card: str):
    """The graph's export render on the card and on the CPU: equal shapes,
    the card's master at least ``min_db`` SNR against the CPU's. Returns
    (card master, SNR)."""
    from nodey_tpu_torch.core.runner import Runner

    on_card = Runner(make_graph(), device=CARD).render("export")
    on_cpu = Runner(make_graph(), device="cpu").render("export")
    check(on_card.master.shape == on_cpu.master.shape,
          f"{tag}: {what}: master {on_card.master.shape} on the card, "
          f"{on_cpu.master.shape} on the CPU")
    db = snr_db(on_cpu.master, on_card.master)
    print(f"[{tag}] {what}, {on_card.metrics.audio_seconds:.3f} s clip: card "
          f"vs CPU master {list(on_card.master.shape)} {on_card.fmt}: SNR "
          f"{db:.1f} dB (min {min_db:.0f}), max|card - cpu| "
          f"{float(abs(on_card.master - on_cpu.master).max()):.3e} ({card})")
    check(db >= min_db, f"{tag}: {what}: the card's master disagrees with "
          f"the CPU's")
    return on_card.master, db


def passthroughs_on_card(tag: str, card: str) -> None:
    """Where the JAX node passes its input through bitwise, the port's node
    must on the card too: a flat EQ (tests/test_biquad.py:148), the limiter
    and the compressor below threshold (tests/test_dynamics.py:51, :163),
    the gate above it once open (tests/test_gate.py) and the de-esser below
    it (tests/test_deesser.py), each node's ``lower`` on 0.5 s of stereo."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core.stream import Stream
    from nodey_tpu_torch.processors.compressor import AudioCompressor
    from nodey_tpu_torch.processors.deesser import AudioDeesser
    from nodey_tpu_torch.processors.equalizer import AudioEq
    from nodey_tpu_torch.processors.gate import AudioGate
    from nodey_tpu_torch.processors.limiter import AudioLimiter

    def noise(amp, seed):
        rng = np.random.default_rng(seed)
        return (amp * rng.standard_normal((2, MASTER_RATE // 2))).astype(
            np.float32)

    limiter, comp, gate, deesser = (AudioLimiter(), AudioCompressor(),
                                    AudioGate(), AudioDeesser())
    limiter.set_threshold_db(-6.0)
    comp.set_makeup_db(0.0)
    gate.set_threshold_db(-30.0)
    gate.set_release_ms(100.0)
    deesser.set_param("threshold_db", -20.0)
    deesser.set_param("ratio", 8.0)
    square = np.where(noise(1.0, 3) < 0, -0.6, 0.6).astype(np.float32)
    # (name, node, input, first sample held: the gate opens at its attack
    # rate from a closed start)
    cases = [("flat EQ", AudioEq(), noise(0.3, 0), 0),
             ("limiter", limiter, noise(0.1, 3), 0),
             ("compressor", comp, noise(0.02, 5), 0),
             ("gate", gate, square, 2_000),
             ("de-esser", deesser, noise(0.001, 1), 0)]
    held = []
    for name, node, x, start in cases:
        data = torch.from_numpy(x).to(CARD)
        out = node.lower(None, {"input": Stream(
            data=data, length=x.shape[1], rate=MASTER_RATE,
            channels=2)})["output"].data
        same = bool(torch.equal(out[:, start:], data[:, start:]))
        held.append(f"{name} {'bitwise' if same else 'NOT bitwise'}")
        check(same, f"{tag}: the {name} does not pass its input through "
              f"bitwise on the card")
    print(f"[{tag}] passthroughs on the card: {', '.join(held)} ({card})")


def masterbus_phases(cli, card: str, tmp: str):
    """Phases 25-26 (see the module docstring): config 6 and the other four
    master-bus nodes. No kernel of ours lies on these paths (48 kHz in and
    out: no resampler, no stretch); each path's launch counts are read and
    must stay 0. Returns the launch counts by path."""
    import numpy as np
    import torch

    from nodey_tpu_torch.host.decode import decode_file
    from nodey_tpu_torch.ops import dynamics, loudness

    paths, figures = {}, {}

    # -- 25. config 6 ------------------------------------------------------------
    tag = "25 config6"
    t0 = time.perf_counter()
    track, short, check_track = (
        masterbus_track(tmp, seconds, f"{seconds}s")
        for seconds in (SECONDS, SHORT_SECONDS, CONFIG_CHECK_SECONDS))
    proj6 = write_project(config6_graph([track]),
                          os.path.join(tmp, "config6.json"))
    wav6 = os.path.join(tmp, "config6.wav")
    master, counts = cli_export(cli, proj6, wav6, tag, card,
                                shape=(2, MASTER_RATE * SECONDS))
    paths["config6"] = counts
    check(sum(counts.values()) == 0, f"{tag}: config 6 launched {counts}")
    ceiling = 10 ** (LIMITER_DB / 20) * (1 + 1e-5)
    peak = float(np.abs(master).max())
    print(f"[{tag}] limiter: master peak {peak:.7f} against the ceiling "
          f"10^({LIMITER_DB:g}/20) x (1 + 1e-5) = {ceiling:.7f} ({card})")
    check(peak <= ceiling, f"{tag}: a master sample above the limiter's "
          f"threshold")
    del master
    # bench.py's tone stays below -1 dBFS through the EQ and the compressor,
    # so the limiter passes it through: hold the property where it acts, on
    # the 30 s track 12 dB louder, the limiter op on the card against the
    # same op on the CPU (tests/test_dynamics.py's atol 3e-7).
    loud = 4.0 * decode_file(check_track).data
    threshold, c = dynamics.limiter_params(LIMITER_DB, 50.0, MASTER_RATE)
    limited = dynamics.limit_block(torch.from_numpy(loud).to(CARD), threshold,
                                   c)[0].cpu().numpy()
    err = float(np.abs(limited - dynamics.limit_block(
        torch.from_numpy(loud), threshold, c)[0].numpy()).max())
    peak = float(np.abs(limited).max())
    print(f"[{tag}] limiter op at {LIMITER_DB:g} dB on the 30 s track x4 "
          f"(input peak {float(np.abs(loud).max()):.4f}): output peak "
          f"{peak:.7f} (ceiling {ceiling:.7f}), max|card - cpu| {err:.3e} "
          f"(tol 3e-07) ({card})")
    check(peak <= ceiling and err <= 3e-7 and float(np.abs(loud).max())
          > threshold, f"{tag}: the limiter op failed on the card")
    del loud, limited
    figures["config6_rtf"] = device_rtf(
        tag, "config6", config6_graph([track]), "export", card,
        profile=(tag, "config-6"))
    _, figures["config6_card_cpu_db"] = card_vs_cpu_db(
        tag, "config6", lambda: config6_graph([check_track]),
        CONFIG6_CARD_CPU_DB, card)
    streamed = streamed_export_checks(
        cli, tag, "config6", proj6, lambda: decode_file(wav6).data, 0.0, card,
        tmp, short_tracks=[short], min_db=CONFIG6_STREAM_DB)
    paths["config6_streamed"] = counts = streamed["counts"]
    check(sum(counts.values()) == 0,
          f"{tag}: the streamed config 6 launched {counts}")
    figures["config6_streamed_db"] = streamed["db"]
    figures["config6_streamed_peaks_mib"] = {
        s: p / 2**20 for s, p in streamed["peaks"].items()}
    figures["config6_streamed_wall_rtf"] = stream_times(
        cli, tag, "config6_streamed_wav", "config 6, WAV sink", proj6,
        os.path.join(tmp, "config6_timed.wav"), streamed["device_ms"],
        card).rtf
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")

    # -- 26. filter, gate, de-esser, normalize -------------------------------------
    tag = "26 masterbus-nodes"
    t0 = time.perf_counter()
    sibilant = masterbus_track(tmp, CONFIG_CHECK_SECONDS, "sibilant",
                               sibilant=True)
    n = MASTER_RATE * CONFIG_CHECK_SECONDS
    proj_a = write_project(graph_a([sibilant]),
                           os.path.join(tmp, "graph_a.json"))
    wav_a = os.path.join(tmp, "graph_a.wav")
    _, counts = cli_export(cli, proj_a, wav_a, tag, card, shape=(2, n),
                           seconds=CONFIG_CHECK_SECONDS)
    paths["graph_a"] = counts
    check(sum(counts.values()) == 0, f"{tag}: graph A launched {counts}")
    on_card, figures["graph_a_card_cpu_db"] = card_vs_cpu_db(
        tag, "graph A", lambda: graph_a([sibilant]), GRAPH_A_DB, card)
    lufs = float(loudness.integrated_lufs(torch.from_numpy(on_card), n,
                                          MASTER_RATE))
    figures["graph_a_lufs"] = lufs
    print(f"[{tag}] graph A: the card master's integrated loudness "
          f"{lufs:.4f} LUFS (target {LUFS_TARGET:g}, tol {LUFS_TOL}) ({card})")
    check(abs(lufs - LUFS_TARGET) <= LUFS_TOL,
          f"{tag}: graph A missed its loudness target")
    del on_card

    out_a = os.path.join(tmp, "graph_a_streamed.wav")
    zero_counts()
    rc, text, metrics = stream_export(cli, proj_a, out_a)
    paths["graph_a_streamed"] = counts = read_counts()
    print("\n".join(f"[{tag}] graph A cli: {line}"
                    for line in text.splitlines()))
    check(rc == 0, f"{tag}: graph A: cli run --stream exited {rc}")
    same = bool(np.array_equal(decode_file(out_a).data,
                               decode_file(wav_a).data))
    path = "offline" if metrics is None and "(offline)" in text else "streamed"
    print(f"[{tag}] graph A run --stream: the {path} path ran (the normalize "
          f"node refuses the stream plan); master "
          f"{'bitwise' if same else 'NOT bitwise'} the offline export's; "
          f"launches {counts} ({card})")
    check(path == "offline" and same and sum(counts.values()) == 0,
          f"{tag}: graph A's run --stream did not fall back to the offline "
          f"render")

    proj_b = write_project(graph_a([sibilant], normalize=False),
                           os.path.join(tmp, "graph_b.json"))
    wav_b = os.path.join(tmp, "graph_b.wav")
    master_b, counts = cli_export(cli, proj_b, wav_b, tag, card,
                                  shape=(2, n), seconds=CONFIG_CHECK_SECONDS)
    paths["graph_b"] = counts
    # The gate and the de-esser act on the sibilant track: the quiet passage
    # from 1.5 s on (the gate's release falls ~43 dB a second, and the
    # passage lies ~50 dB below the tone) and the burst's 6-7 kHz band,
    # graph B's master against its input.
    x = decode_file(sibilant).data
    quiet = slice(2 * n // 3 + 3 * MASTER_RATE // 2, 5 * n // 6)
    burst = slice(n // 3 + MASTER_RATE // 2, n // 2)

    def band(v):
        spec = np.abs(np.fft.rfft(v[:, burst].astype(np.float64), axis=1))
        freqs = np.fft.rfftfreq(burst.stop - burst.start, 1.0 / MASTER_RATE)
        return float(np.sqrt((spec[:, (freqs >= 6_000) & (freqs < 7_000)]
                              ** 2).sum()))

    gate_db = 20 * math.log10(float(np.abs(master_b[:, quiet]).max())
                              / float(np.abs(x[:, quiet]).max()))
    ess_db = 20 * math.log10(band(master_b) / band(x))
    print(f"[{tag}] graph B: the gate {gate_db:.1f} dB over the quiet "
          f"passage, the de-esser {ess_db:.1f} dB in the burst's 6-7 kHz "
          f"band ({card})")
    check(gate_db < -3.0 and ess_db < -3.0,
          f"{tag}: the gate or the de-esser did not act")
    del x, master_b
    streamed = streamed_export_checks(
        cli, tag, "graph_b", proj_b, lambda: decode_file(wav_b).data, 0.0,
        card, tmp, min_db=GRAPH_A_DB, min_steps=2)
    paths["graph_b_streamed"] = counts = streamed["counts"]
    check(sum(paths["graph_b"].values()) == sum(counts.values()) == 0,
          f"{tag}: graph B launched {paths['graph_b']}, streamed {counts}")
    figures["graph_b_streamed_db"] = streamed["db"]
    print(f"[{tag}] graph B run --stream: the streamed path ran, "
          f"{streamed['metrics'].steps} steps, SNR {streamed['db']:.1f} dB "
          f"against the offline export ({card})")
    passthroughs_on_card(tag, card)
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[25-26 figures] {json.dumps(figures)}")
    return paths


def config7_graph(paths):
    """bench.py:240-253: the 48 kHz stereo track -> audio_reverb (decay
    1.8 s, wet 0.35; pre-delay 20 ms, damping 0.5, dry 1 by default) ->
    output (export)."""
    from nodey_tpu_torch.processors.reverb import AudioReverb

    g, src = _input_graph(paths[:1])
    rev = g.add_node(AudioReverb())
    g.nodes[rev].processor.set_param("decay_s", 1.8)
    g.nodes[rev].processor.set_param("wet", 0.35)
    g.add_link(_pin(g, src, "output_0"), _pin(g, rev, "input"))
    _output(g, _pin(g, rev, "output"))
    return g


def _chain(paths, stages):
    """The track -> each (identifier, params) of ``stages`` from the port's
    processor_map, set as examples/channel_strip.py sets them (a node's
    ``set_<key>`` where it has one, else ``set_param``) -> output."""
    from nodey_tpu_torch.core.registry import (processor_map,
                                               register_all_processors)

    register_all_processors()
    g, src = _input_graph(paths[:1])
    prev = _pin(g, src, "output_0")
    for identifier, params in stages:
        nid = g.add_node(processor_map[identifier].generate())
        proc = g.nodes[nid].processor
        for key, value in params.items():
            setter = getattr(proc, f"set_{key}", None)
            if setter is not None:
                setter(value)
            else:
                proc.set_param(key, value)
        g.add_link(prev, _pin(g, nid, "input"))
        prev = _pin(g, nid, "output")
    _output(g, prev)
    return g


# examples/channel_strip.py:51-64, its parameters as the script sets them.
EXAMPLE_STRIP = [
    ("audio_gate", dict(threshold_db=-45.0, ratio=6.0, release_ms=150.0)),
    ("audio_eq", dict(ls_gain_db=2.0, p2_freq=2500.0, p2_gain_db=3.0,
                      hs_gain_db=1.5)),
    ("audio_compressor", dict(threshold_db=-16.0, ratio=3.0, attack_ms=5.0,
                              release_ms=120.0, makeup_db=2.0)),
    ("audio_phaser", dict(rate_hz=0.4, f_min_hz=300.0, f_max_hz=2500.0,
                          wet=0.5)),
    ("audio_width", dict(width=1.4)),
    ("audio_pan", dict(pan=-0.25)),
    ("audio_delay", dict(delay_ms=240.0, feedback=0.35, wet=0.18)),
    ("audio_reverb", dict(decay_s=1.2, wet=0.2)),
    ("audio_fade", dict(in_ms=120.0, out_start_s=3.5, out_ms=600.0)),
    ("audio_limiter", dict(threshold_db=-1.0, release_ms=60.0)),
]
# Phase 28's graph (c): tremolo at 5 Hz, depth 0.5, then the chorus's
# defaults.
MODFX_CHAIN = [("audio_tremolo", dict(rate_hz=5.0, depth=0.5)),
               ("audio_chorus", {})]


def effect_passthroughs_on_card(tag: str, card: str) -> None:
    """Where the JAX node passes its input through bitwise, the port's node
    must on the card too: reverb, delay, phaser and chorus at wet 0 with dry
    1, tremolo at depth 0, width 1, pan 0 on stereo and a fade with no
    ramp, each node's ``lower`` on 0.5 s of stereo noise."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core.registry import (processor_map,
                                               register_all_processors)
    from nodey_tpu_torch.core.stream import Stream

    register_all_processors()
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((2, MASTER_RATE // 2))).astype(np.float32)
    data = torch.from_numpy(x).to(CARD)
    cases = [("audio_reverb", dict(wet=0.0, dry=1.0)),
             ("audio_delay", dict(wet=0.0, dry=1.0)),
             ("audio_phaser", dict(wet=0.0, dry=1.0)),
             ("audio_chorus", dict(wet=0.0, dry=1.0)),
             ("audio_tremolo", dict(depth=0.0)),
             ("audio_width", dict(width=1.0)),
             ("audio_pan", dict(pan=0.0)),
             ("audio_fade", dict(in_ms=0.0, out_start_s=0.0))]
    held = []
    for identifier, params in cases:
        node = processor_map[identifier].generate()
        for key, value in params.items():
            node.set_param(key, value)
        out = node.lower(None, {"input": Stream(
            data=data, length=x.shape[1], rate=MASTER_RATE,
            channels=2)})["output"].data
        same = bool(torch.equal(out, data))
        held.append(f"{identifier[6:]} {'bitwise' if same else 'NOT bitwise'}")
        check(same, f"{tag}: {identifier} does not pass its input through "
              f"bitwise on the card")
    print(f"[{tag}] passthroughs on the card: {', '.join(held)} ({card})")


def effects_phases(cli, card: str, tmp: str):
    """Phases 27-28 (see the module docstring): config 7 and the channel
    strips. No kernel of ours lies on these paths (48 kHz in and out: no
    resampler, no stretch); each path's launch counts are read and must
    stay 0. Returns the launch counts by path."""
    import numpy as np

    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.core.streaming import render_chunked
    from nodey_tpu_torch.host.decode import decode_file
    from nodey_tpu_torch.ops import delay, reverb

    paths, figures = {}, {}
    n = MASTER_RATE * SECONDS

    def no_launch(tag, what, counts):
        paths[what] = counts
        check(sum(counts.values()) == 0, f"{tag}: {what} launched {counts}")

    # -- 27. config 7 ------------------------------------------------------------
    tag = "27 config7"
    t0 = time.perf_counter()
    track, short, check_track = (
        masterbus_track(tmp, seconds, f"{seconds}s")
        for seconds in (SECONDS, SHORT_SECONDS, CONFIG_CHECK_SECONDS))
    check(reverb.ir_length(MASTER_RATE, 1.8, 20.0) == CONFIG7_IR,
          f"{tag}: the IR is not {CONFIG7_IR} samples long")
    proj7 = write_project(config7_graph([track]),
                          os.path.join(tmp, "config7.json"))
    wav7 = os.path.join(tmp, "config7.wav")
    _, counts = cli_export(cli, proj7, wav7, tag, card,
                           shape=(2, n + CONFIG7_IR - 1))
    no_launch(tag, "config7", counts)
    figures["config7_rtf"] = device_rtf(
        tag, "config7", config7_graph([track]), "export", card,
        profile=(tag, "config-7"))
    _, figures["config7_card_cpu_db"] = card_vs_cpu_db(
        tag, "config7", lambda: config7_graph([check_track]),
        CONFIG7_CARD_CPU_DB, card)
    streamed = streamed_export_checks(
        cli, tag, "config7", proj7, lambda: decode_file(wav7).data, 0.0, card,
        tmp, short_tracks=[short], min_db=CONFIG7_STREAM_DB)
    no_launch(tag, "config7_streamed", streamed["counts"])
    figures["config7_streamed_db"] = streamed["db"]
    figures["config7_streamed_peaks_mib"] = {
        s: p / 2**20 for s, p in streamed["peaks"].items()}
    figures["config7_streamed_wall_rtf"] = stream_times(
        cli, tag, "config7_streamed_wav", "config 7, WAV sink", proj7,
        os.path.join(tmp, "config7_timed.wav"), streamed["device_ms"],
        card).rtf
    graph = cli._load_graph(proj7)
    whole = []
    offline_peak = device_peak(lambda: whole.append(
        Runner(graph, device=CARD).render("export").master))
    result = []
    zero_counts()
    chunked_peak = device_peak(lambda: result.append(
        render_chunked(graph, device=CARD)))
    no_launch(tag, "config7_chunked", read_counts())
    chunked, rate, _fmt, _ = result[0]
    db = snr_db(whole[0], chunked)
    figures["config7_chunked_db"] = db
    print(f"[{tag}] render_chunked (30 s windows): master "
          f"{list(chunked.shape)} at {rate} Hz vs the offline render "
          f"{list(whole[0].shape)}: SNR {db:.1f} dB (min "
          f"{CONFIG7_CHUNKED_DB:.0f}), max|diff| "
          f"{float(np.abs(chunked - whole[0]).max()):.3e}; peak device "
          f"memory {chunked_peak / 2**20:.1f} MiB (offline render "
          f"{offline_peak / 2**20:.1f} MiB) ({card})")
    check(chunked.shape == whole[0].shape and db >= CONFIG7_CHUNKED_DB,
          f"{tag}: the chunked master disagrees with the offline render")
    check(chunked_peak < offline_peak,
          f"{tag}: the chunked render took more memory than the offline one")
    del whole, chunked, result
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")

    # -- 28. the channel strips -------------------------------------------------
    tag = "28 channel-strip"
    t0 = time.perf_counter()
    shipped = os.path.join(ROOT, "examples", "projects", "channel_strip.json")
    proj_a = project_with_tracks(shipped, [track],
                                 os.path.join(tmp, "strip_a.json"))
    check_a = project_with_tracks(shipped, [check_track],
                                  os.path.join(tmp, "strip_a_30s.json"))
    tail_a = reverb.ir_length(MASTER_RATE, 1.2, 20.0) - 1
    wav_a = os.path.join(tmp, "strip_a.wav")
    _, counts = cli_export(cli, proj_a, wav_a, tag, card,
                           shape=(2, n + tail_a))
    no_launch(tag, "strip_a", counts)
    _, figures["strip_a_card_cpu_db"] = card_vs_cpu_db(
        tag, "channel_strip.json", lambda: cli._load_graph(check_a),
        STRIP_CARD_CPU_DB, card)
    out_a = os.path.join(tmp, "strip_a_streamed.wav")
    zero_counts()
    rc, text, metrics = stream_export(cli, proj_a, out_a)
    no_launch(tag, "strip_a_streamed", read_counts())
    print("\n".join(f"[{tag}] channel_strip.json cli: {line}"
                    for line in text.splitlines()))
    same = bool(np.array_equal(decode_file(out_a).data,
                               decode_file(wav_a).data))
    path = "offline" if metrics is None and "(offline)" in text else "streamed"
    print(f"[{tag}] channel_strip.json run --stream: the {path} path ran "
          f"(the normalize node refuses the stream plan); master "
          f"{'bitwise' if same else 'NOT bitwise'} the offline export's "
          f"({card})")
    check(rc == 0 and path == "offline" and same,
          f"{tag}: channel_strip.json's run --stream did not fall back to "
          f"the offline render")

    proj_b = write_project(_chain([track], EXAMPLE_STRIP),
                           os.path.join(tmp, "strip_b.json"))
    wav_b = os.path.join(tmp, "strip_b.wav")
    d, k = delay.delay_params(MASTER_RATE, 240.0, 0.35)
    _, counts = cli_export(cli, proj_b, wav_b, tag, card,
                           shape=(2, n + k * d + tail_a))
    no_launch(tag, "strip_b", counts)
    streamed = streamed_export_checks(
        cli, tag, "strip_b", proj_b, lambda: decode_file(wav_b).data, 0.0,
        card, tmp, short_tracks=[short], min_db=STRIP_STREAM_DB)
    no_launch(tag, "strip_b_streamed", streamed["counts"])
    figures["strip_b_streamed_db"] = streamed["db"]
    figures["strip_b_streamed_peaks_mib"] = {
        s: p / 2**20 for s, p in streamed["peaks"].items()}
    figures["strip_b_streamed_wall_rtf"] = stream_times(
        cli, tag, "strip_b_streamed_wav", "the example's channel strip, WAV "
        "sink", proj_b, os.path.join(tmp, "strip_b_timed.wav"),
        streamed["device_ms"], card).rtf

    proj_c = write_project(_chain([check_track], MODFX_CHAIN),
                           os.path.join(tmp, "modfx.json"))
    wav_c = os.path.join(tmp, "modfx.wav")
    _, counts = cli_export(cli, proj_c, wav_c, tag, card,
                           shape=(2, MASTER_RATE * CONFIG_CHECK_SECONDS),
                           seconds=CONFIG_CHECK_SECONDS)
    no_launch(tag, "modfx", counts)
    _, figures["modfx_card_cpu_db"] = card_vs_cpu_db(
        tag, "tremolo -> chorus", lambda: _chain([check_track], MODFX_CHAIN),
        MODFX_CARD_CPU_DB, card)
    streamed = streamed_export_checks(
        cli, tag, "modfx", proj_c, lambda: decode_file(wav_c).data,
        MODFX_STREAM_TOL, card, tmp, min_steps=2)
    no_launch(tag, "modfx_streamed", streamed["counts"])
    figures["modfx_streamed_err"] = streamed["err"]
    effect_passthroughs_on_card(tag, card)
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[27-28 figures] {json.dumps(figures)}")
    return paths

# -- phase 29: the timeline nodes ---------------------------------------------


def splice_checks(tag: str, what: str, got, want, window, card: str):
    """``got`` against ``want`` ([C, n] on the host): equal shapes, bitwise
    outside the crossfade window (n0, n_dur), within SPLICE_TOL inside it.
    Returns max|got - want| inside the window."""
    import numpy as np

    n0, n_dur = window
    check(got.shape == want.shape,
          f"{tag}: {what}: master {got.shape}, want {want.shape}")
    outside = bool(np.array_equal(got[:, :n0], want[:, :n0])
                   and np.array_equal(got[:, n0 + n_dur:],
                                      want[:, n0 + n_dur:]))
    inside = float(np.abs(got[:, n0:n0 + n_dur]
                          - want[:, n0:n0 + n_dur]).max(initial=0.0))
    print(f"[{tag}] {what}: master {list(got.shape)}; outside the window "
          f"[{n0}, {n0 + n_dur}) {'bitwise' if outside else 'NOT bitwise'}, "
          f"inside max|diff| {inside:.3e} (tol {SPLICE_TOL:.0e}) ({card})")
    check(outside and inside <= SPLICE_TOL,
          f"{tag}: {what} disagrees with its reference")
    return inside


def _generator(g, **params) -> int:
    from nodey_tpu_torch.processors.generator import AudioGenerator

    gen = AudioGenerator()
    for key, value in params.items():
        gen.set_param(key, value)
    return g.add_node(gen)


def generator_trim_graph(waveform: str):
    """Phase 29's graph (b): audio_generator (``waveform``, seed 7, -12 dB,
    SECONDS at 48 kHz stereo) -> audio_trim (TRIM_SPAN of the clip) ->
    output. No audio file."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.editnodes import AudioTrim

    g = Graph()
    gen = _generator(g, waveform=waveform, seed=7, level_db=-12.0,
                     duration_s=SECONDS, rate=MASTER_RATE, channels=2)
    trim = g.add_node(AudioTrim())
    g.nodes[trim].processor.set_param("start_s", SECONDS * TRIM_SPAN[0])
    g.nodes[trim].processor.set_param("end_s", SECONDS * TRIM_SPAN[1])
    g.add_link(_pin(g, gen, "output"), _pin(g, trim, "input"))
    _output(g, _pin(g, trim, "output"))
    return g


def mixed_rate_graph(paths, seconds=SECONDS):
    """Phase 29's graph (c): the 44.1 kHz track and a 48 kHz triangle
    generator (97 Hz, -18 dB, ``seconds``) -> audio_amix 0.6 / 0.4 ->
    output (phase 32's (f) on BATCH_SECONDS)."""
    g, src = _input_graph(paths[:1])
    gen = _generator(g, waveform="triangle", freq=97.0, level_db=-18.0,
                     duration_s=seconds, rate=MASTER_RATE, channels=2)
    amix = _amix(g, (0.6, 0.4))
    g.add_link(_pin(g, src, "output_0"), _pin(g, amix, "input_1"))
    g.add_link(_pin(g, gen, "output"), _pin(g, amix, "input_2"))
    _output(g, _pin(g, amix, "output"))
    return g


def reverse_graph(paths):
    """Phase 29's graph (d): the track -> audio_reverse -> output."""
    from nodey_tpu_torch.processors.editnodes import AudioReverse

    g, src = _input_graph(paths[:1])
    rev = g.add_node(AudioReverse())
    g.add_link(_pin(g, src, "output_0"), _pin(g, rev, "input"))
    _output(g, _pin(g, rev, "output"))
    return g


def noise_mirror(seed: int, channels: int, pos0: int, n: int, gain: float):
    """The generator's noise at absolute samples [pos0, pos0 + n) from the
    numpy mirror of its hash (``_fmix32_np``): the top 23 bits centred,
    times the gain folded into one float32 constant, as the op computes
    them. [channels, n] float32."""
    import numpy as np

    from nodey_tpu_torch.ops.oscillator import _fmix32_np

    i = np.arange(pos0, pos0 + n, dtype=np.int64).astype(np.uint32)
    rows = []
    for c in range(channels):
        key = np.uint32((seed * 0x9E3779B9 + c * 0x7FEB352D) & 0xFFFFFFFF)
        with np.errstate(over="ignore"):
            h = _fmix32_np(i ^ key)
        centered = (h >> np.uint32(9)).astype(np.int32) - np.int32(1 << 22)
        rows.append(centered.astype(np.float32)
                    * np.float32(gain * 2.0 ** -22))
    return np.stack(rows)


@contextlib.contextmanager
def recorded_feeds(found):
    """Inside the block, every StreamExecutor's planned sources and hints
    (``_open_feeds``) are appended to ``found``."""
    from nodey_tpu_torch.core.stream_executor import StreamExecutor

    open_feeds = StreamExecutor._open_feeds

    def recording(self):
        feeds, sources, hints = open_feeds(self)
        found.append((sources, hints))
        return feeds, sources, hints

    StreamExecutor._open_feeds = recording
    try:
        yield
    finally:
        StreamExecutor._open_feeds = open_feeds


def timeline_phases(cli, card: str, tmp: str, track_44k: str):
    """Phase 29 (see the module docstring): the crossfade, the generator,
    trim and reverse. ``track_44k``: a SECONDS-long 44.1 kHz stereo s16
    track. Only path (c) resamples; every other path's launch counts must
    stay 0. Returns (the launch counts by path, the worst resampler
    launch's max|kernel - plain|)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core.errors import RunCancelled
    from nodey_tpu_torch.core.runner import Runner, RunnerState
    from nodey_tpu_torch.host.decode import decode_file, write_wav_s16
    from nodey_tpu_torch.ops import crossfade

    paths, figures = {}, {}
    n = MASTER_RATE * SECONDS

    def no_launch(what, counts):
        paths[what] = counts
        check(sum(counts.values()) == 0, f"{tag}: {what} launched {counts}")

    # -- (a) crossfade_splice.json --------------------------------------------
    tag = "29 timeline"
    t0 = time.perf_counter()
    tracks = {}
    for seconds in (SECONDS, SHORT_SECONDS, CONFIG_CHECK_SECONDS):
        tracks[seconds] = []
        for i, f0 in enumerate((220.0, 330.0)):
            path = os.path.join(tmp, f"splice_{i}_{seconds}s.wav")
            write_wav_s16(path, bench_tone(MASTER_RATE * seconds,
                                           MASTER_RATE, f0, 2, 10 + i),
                          MASTER_RATE)
            tracks[seconds].append(path)
    shipped = os.path.join(ROOT, "examples", "projects",
                           "crossfade_splice.json")
    proj_a, proj_check = (
        project_with_tracks(shipped, tracks[seconds], os.path.join(
            tmp, f"splice_{seconds}s.json"))
        for seconds in (SECONDS, CONFIG_CHECK_SECONDS))
    graph = cli._load_graph(proj_a)
    xfade = next(node.processor for node in graph.nodes.values()
                 if node.processor.info().identifier == "audio_crossfade")
    window = crossfade.crossfade_spec(MASTER_RATE, xfade.at_s, xfade.dur_ms)
    print(f"[{tag}] crossfade_splice.json: {xfade.law} over {xfade.dur_ms} "
          f"ms at {xfade.at_s} s, window {window} samples ({card})")
    wav_a = os.path.join(tmp, "splice.wav")
    _, counts = cli_export(cli, proj_a, wav_a, tag, card, shape=(2, n))
    no_launch("splice", counts)
    figures["splice_rtf"] = device_rtf(tag, "crossfade_splice", graph,
                                       "export", card)
    on_card = Runner(cli._load_graph(proj_check), device=CARD).render()
    on_cpu = Runner(cli._load_graph(proj_check), device="cpu").render()
    figures["splice_card_cpu_err"] = splice_checks(
        tag, f"card vs CPU, {CONFIG_CHECK_SECONDS} s", on_card.master,
        on_cpu.master, window, card)
    del on_card, on_cpu
    streamed = streamed_export_checks(
        cli, tag, "splice", proj_a, lambda: decode_file(wav_a).data,
        SPLICE_TOL, card, tmp, short_tracks=tracks[SHORT_SECONDS])
    no_launch("splice_streamed", streamed["counts"])
    figures["splice_streamed_err"] = splice_checks(
        tag, "streamed vs offline export",
        decode_file(os.path.join(tmp, "splice_streamed.wav")).data,
        decode_file(wav_a).data, window, card)
    figures["splice_streamed_peaks_mib"] = {
        s: p / 2**20 for s, p in streamed["peaks"].items()}
    figures["splice_streamed_wall_rtf"] = stream_times(
        cli, tag, "splice_streamed_wav", "crossfade_splice.json, WAV sink",
        proj_a, os.path.join(tmp, "splice_timed.wav"),
        streamed["device_ms"], card).rtf

    # -- (b) a graph with no audio file ----------------------------------------
    proj_b = write_project(generator_trim_graph("noise"),
                           os.path.join(tmp, "generator_trim.json"))
    wav_b = os.path.join(tmp, "generator_trim.wav")
    n0 = round(SECONDS * TRIM_SPAN[0] * MASTER_RATE)
    n1 = round(SECONDS * TRIM_SPAN[1] * MASTER_RATE)
    master_b, counts = cli_export(cli, proj_b, wav_b, tag, card,
                                  shape=(2, n1 - n0))
    no_launch("generator_trim", counts)
    gain = 10.0 ** (-12.0 / 20.0)
    same = bool(np.array_equal(master_b, noise_mirror(7, 2, n0, n1 - n0,
                                                      gain)))
    print(f"[{tag}] generator (noise, seed 7) -> trim [{n0}, {n1}): "
          f"{n1 - n0} samples, {'bitwise' if same else 'NOT bitwise'} the "
          f"_fmix32_np mirror at those positions ({card})")
    check(same, f"{tag}: the generator's noise is not its mirror's")
    del master_b
    streamed = streamed_export_checks(
        cli, tag, "generator_trim", proj_b, lambda: decode_file(wav_b).data,
        0.0, card, tmp)
    no_launch("generator_trim_streamed", streamed["counts"])
    figures["generator_trim_streamed_err"] = streamed["err"]
    figures["generator_trim_streamed_wall_rtf"] = streamed["metrics"].rtf
    _, figures["generator_sine_card_cpu_db"] = card_vs_cpu_db(
        tag, "generator (sine) -> trim", lambda: generator_trim_graph("sine"),
        GENERATOR_SINE_DB, card)

    # -- (c) a generator mixed with a decoded track at another rate ------------
    proj_c = write_project(mixed_rate_graph([track_44k]),
                           os.path.join(tmp, "mixed_rate.json"))
    wav_c = os.path.join(tmp, "mixed_rate.wav")
    offline_rs, streamed_rs, planned = [], [], []
    with recorded_launches(resamples=offline_rs):
        _, counts = cli_export(cli, proj_c, wav_c, tag, card, shape=(2, n))
    paths["mixed_rate"] = counts
    worst = check_resamples(f"{tag} offline", offline_rs,
                            counts["polyphase_resample"], card)
    with recorded_feeds(planned):
        streamed = streamed_export_checks(
            cli, tag, "mixed_rate", proj_c, lambda: decode_file(wav_c).data,
            STREAM_MIX_TOL, card, tmp,
            record=recorded_launches(resamples=streamed_rs))
    paths["mixed_rate_streamed"] = streamed["counts"]
    launched = streamed["counts"]["polyphase_resample"]
    worst = max(worst, check_resamples(f"{tag} streamed", streamed_rs,
                                       launched, card))
    sources, hints = planned[0]
    widths = sorted([spec.capacity for spec in sources.values()]
                    + [h["chunk_width"] for h in hints.values()])
    print(f"[{tag}] mixed rates: chunk widths {widths} (the 44.1 kHz feed "
          f"and the 48 kHz generator's hint on one {STREAM_CHUNK_SECONDS} s "
          f"quantum); {launched} resampler launches in "
          f"{streamed['metrics'].steps} steps, "
          f"{counts['polyphase_resample']} offline ({card})")
    check(widths == [STREAM_CHUNK_SECONDS * 44_100,
                     STREAM_CHUNK_SECONDS * MASTER_RATE],
          f"{tag}: the mixed-rate chunk widths are {widths}")
    check(counts["polyphase_resample"] > 0 and launched > 0,
          f"{tag}: the mixed-rate paths launched no resampler")
    figures["mixed_rate_streamed_err"] = streamed["err"]
    figures["mixed_rate_resampler_launches"] = {
        "offline": counts["polyphase_resample"], "streamed": launched}
    del offline_rs, streamed_rs

    # -- (d) reverse -------------------------------------------------------------
    track = tracks[SECONDS][0]
    proj_d = write_project(reverse_graph([track]),
                           os.path.join(tmp, "reverse.json"))
    wav_d = os.path.join(tmp, "reverse.wav")
    master_d, counts = cli_export(cli, proj_d, wav_d, tag, card,
                                  shape=(2, n))
    no_launch("reverse", counts)
    decoded = decode_file(track).data
    zero_counts()
    rendered = Runner(reverse_graph([track]), device=CARD).render().master
    on_card = torch.from_numpy(decoded).to(CARD).flip(1).cpu().numpy()
    same = bool(np.array_equal(rendered, on_card)
                and np.array_equal(master_d, decoded[:, ::-1]))
    del rendered, on_card, master_d, decoded
    print(f"[{tag}] reverse: the render "
          f"{'bitwise' if same else 'NOT bitwise'} the card's flip of the "
          f"decoded input, the export the host's ({card})")
    check(same, f"{tag}: reverse is not the flip of its input")
    out_d = os.path.join(tmp, "reverse_streamed.wav")
    runner = Runner(cli._load_graph(proj_d), device=CARD)
    seen = []
    metrics = runner.export_streamed(out_d, progress=seen.append)
    with open(out_d, "rb") as f1, open(wav_d, "rb") as f2:
        same = f1.read() == f2.read()
    monotone = seen == sorted(seen) and seen[-1] == n / MASTER_RATE
    print(f"[{tag}] reverse, export_streamed: the {metrics.mode} path ran, "
          f"the file {'bitwise' if same else 'NOT bitwise'} the offline "
          f"export's; progress called {len(seen)} times, "
          f"{'monotone' if monotone else 'NOT monotone'} up to {seen[-1]} "
          f"audio-s ({card})")
    check(metrics.mode == "offline" and same and monotone,
          f"{tag}: reverse's streamed export did not fall back offline")

    def stop(seconds):
        runner.stop()

    try:
        runner.export_streamed(out_d, progress=stop)
        cancelled = False
    except RunCancelled:
        cancelled = True
    ready = runner.state is RunnerState.READY and not os.path.exists(out_d)
    runner.export_streamed(out_d)
    with open(out_d, "rb") as f1, open(wav_d, "rb") as f2:
        again = f1.read() == f2.read()
    no_launch("reverse_streamed", read_counts())
    print(f"[{tag}] reverse, stop() from the first progress call: "
          f"{'RunCancelled' if cancelled else 'NOT cancelled'}, "
          f"{'no file, READY' if ready else 'NOT clean'}; the same runner "
          f"then exported in full, {'bitwise' if again else 'NOT bitwise'} "
          f"the offline export ({card})")
    check(cancelled and ready and again,
          f"{tag}: the fallback export did not cancel cleanly")
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[29 figures] {json.dumps(figures)}")
    return paths, worst


def s16_clips(signals, capacity: int):
    """Clips [B, C, n] float32 as the s16 wire [B, C, capacity] int16
    (round(x*32768), as Runner.decode keeps s16 sources), zero padded."""
    import numpy as np

    out = np.zeros((len(signals), signals[0].shape[0], capacity),
                   dtype=np.int16)
    for b, sig in enumerate(signals):
        out[b, :, : sig.shape[1]] = np.clip(np.round(sig * 32768.0), -32768,
                                            32767)
    return out


def batch_and_singles(key: str, clips, lengths, dev):
    """The batch's device args and each clip's single-render args."""
    import torch

    data = torch.from_numpy(clips).to(dev)
    return ({key: data}, {key: tuple(lengths)},
            [{key: (data[b], n)} for b, n in enumerate(lengths)])


def check_clips(tag: str, what: str, outs, singles, card: str,
                min_db=None) -> None:
    """Each clip of a batched render against its own single render: the
    lengths equal, the master (or the preview) bitwise (or, given
    ``min_db``, at least that SNR over the clip's length), each spectrum
    within BATCH_SPECTRUM_REL of its largest value, the tail past each
    clip's length zero."""
    import numpy as np
    import torch

    key = "master" if "master" in outs else "preview"
    data, lens = outs[key]
    worst_db, spectrum_rel, bitwise = math.inf, 0.0, True
    for b, single in enumerate(singles):
        one, n = single[key]
        check(lens[b] == n, f"{tag}: {what} clip {b}: length {lens[b]}, its "
                            f"single render {n}")
        check(not bool(data[b, :, n:].any()),
              f"{tag}: {what} clip {b}: the tail past its length is not zero")
        same = torch.equal(data[b], one)
        bitwise &= same
        if not same:
            worst_db = min(worst_db, snr_db(one[:, :n].cpu().numpy(),
                                            data[b, :, :n].cpu().numpy()))
        for k, v in single.items():
            if k.startswith("spectrum_"):
                spectrum_rel = max(spectrum_rel, float(
                    (outs[k][b] - v).abs().max() / v.abs().max()))
    print(f"[{tag}] {what}: each of {len(singles)} clips against its own "
          f"single render: lengths {list(lens)} equal, tails zero, {key}s "
          f"{'bitwise' if bitwise else f'{worst_db:.1f} dB at worst'}"
          + (f", spectra max|diff| / max {spectrum_rel:.3e} (tol "
             f"{BATCH_SPECTRUM_REL:g})" if any(k.startswith("spectrum_")
                                                for k in outs) else "")
          + f" ({card})")
    check(bitwise if min_db is None else worst_db >= min_db,
          f"{tag}: {what}: a clip disagrees with its single render")
    check(spectrum_rel <= BATCH_SPECTRUM_REL,
          f"{tag}: {what}: a clip's spectrum disagrees with its single render")


def refused_batch(tag: str, what: str, compiled, arrays, lengths,
                  detail: str, card: str) -> dict:
    """``compiled.run_batch(arrays, lengths)`` must raise a
    ProcessorRuntimeError whose detail holds ``detail``, before any launch
    or device allocation. Returns the path's launch counts."""
    import torch

    from nodey_tpu_torch.core.errors import ProcessorRuntimeError

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    zero_counts()
    try:
        compiled.run_batch(arrays, lengths)
        refused = None
    except ProcessorRuntimeError as exc:
        refused = exc
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    counts = read_counts()
    print(f"[{tag}] {what}: run_batch "
          f"{'raised: ' + refused.detail if refused else 'DID NOT RAISE'}; "
          f"launches {counts}; device memory allocated {grew} bytes more "
          f"({card})")
    check(refused is not None and detail in refused.detail,
          f"{tag}: {what} was not refused")
    check(sum(counts.values()) == 0 and grew == 0,
          f"{tag}: the refused batch launched {counts}, allocated {grew}")
    return counts


def batch_phase(cli, card: str, dev, tmp: str):
    """Phase 30 (see the module docstring): batched serving through
    ``CompiledGraph.run_batch``. Returns (the launch counts by path, the
    figures: rtf_batch8_serving, the batched config-4 times, and each
    kernel's batched launch held against its plain version, with its time
    and bound)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import write_wav_s16
    from nodey_tpu_torch.ops import cuda_resample
    from nodey_tpu_torch.ops import resample as tr
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.delay import AudioDelay
    from nodey_tpu_torch.processors.resample_node import AudioResample

    tag = "30 batch"
    t0 = time.perf_counter()
    paths, figures, kernels = {}, {}, {}
    n = RATE * BATCH_SECONDS

    def counts_match(what, batched, single):
        print(f"[{tag}] {what}: launches of the batch {batched}, of one "
              f"clip's render {single} ({card})")
        check(batched == single, f"{tag}: {what}: the batch launched "
                                 f"{batched}, one clip {single}")

    # -- (a) rtf_batch8_serving -----------------------------------------------
    tracks = []
    for i in range(2):
        path = os.path.join(tmp, f"batch_5node_{i}.wav")
        write_wav_s16(path, bench_tone(n, RATE, 220.0 * (i + 1), 2, i), RATE)
        tracks.append(path)
    runner = Runner(flagship_graph(tracks), device=CARD)
    arrays, lengths, sources = runner.decode()
    compiled = runner.compile(sources, "export")
    bargs = {k: torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(v, (BATCH,) + v.shape))).to(dev)
        for k, v in arrays.items()}
    blens = {k: (v,) * BATCH for k, v in lengths.items()}
    single_args = runner.ingest(arrays, lengths)
    resamples = []
    zero_counts()
    with recorded_launches(resamples=resamples):
        outs, meta = compiled.run_batch(bargs, blens)
    paths["5node_batch8"] = read_counts()
    zero_counts()
    single, _ = compiled(single_args)
    counts_match(f"5-node graph, {BATCH} x {BATCH_SECONDS} s",
                 paths["5node_batch8"], read_counts())
    kernels["resample_err"] = check_resamples(
        tag, resamples, paths["5node_batch8"]["polyphase_resample"], card)
    check_clips(tag, f"5-node graph, {BATCH} copies of {BATCH_SECONDS} s",
                outs, [single] * BATCH, card)
    rate = meta["master"]["rate"]
    audio_s = sum(outs["master"][1]) / rate
    del outs, single
    med, lo, hi, count = summary(cuda_ms(
        lambda: compiled.run_batch(bargs, blens), BATCH_ITERS, warmup=2))
    one_med = summary(cuda_ms(lambda: compiled(single_args), BATCH_ITERS,
                              warmup=2))[0]
    rtf = audio_s / (med / 1e3)
    figures["rtf_batch8_serving"] = rtf
    figures["5node_batch8_ms"] = med
    figures["5node_single_30s_ms"] = one_med
    print(f"[{tag}] rtf_batch8_serving: 5-node graph, {BATCH} x "
          f"{BATCH_SECONDS} s stereo uploaded once, run_batch back to back: "
          f"{audio_s:.3f} audio-s per call, device time median {med:.4f} ms "
          f"(min {lo:.4f}, max {hi:.4f}, n={count}, CUDA events), RTF "
          f"{rtf:.1f} audio-s per device-s; one {BATCH_SECONDS} s clip alone "
          f"{one_med:.4f} ms ({card})")
    # The batched resampler launch: its time beside its bound and plain.
    (x, G, M, W, bank, support), _ = resamples[0]
    rows = x.reshape(-1, x.shape[-1])
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (functools.partial(cuda_resample.apply_filter_bank_cuda, x, G, M,
                                W, support) if name == "kernel" else
              functools.partial(tr.apply_filter_bank_plain, x, G, M, W,
                                bank))
        runs[name] += cuda_ms(fn, 5)
    kernels["polyphase_resample"] = dict(
        shape=list(x.shape), ms=summary(runs["kernel"])[0],
        plain_ms=summary(runs["plain"])[0],
        bound=resample_work_bound(rows, G, M, bank))
    del resamples, bargs, x, rows

    # -- (b, c, e, f) config 4 on WSOLA and the PV, 8 x 30 s ------------------
    signals = [bench_tone(n, RATE, 220.0 + 20.0 * b, 2, 20 + b)
               for b in range(BATCH)]
    track = os.path.join(tmp, "batch_config4.wav")
    write_wav_s16(track, signals[0], RATE)
    for what, algo, options in (("config4", "wsola", False),
                                ("config4_pv", "pv", False),
                                ("config4_pv_options", "pv", True)):
        runner = Runner(config4_graph(track, algorithm=algo,
                                      transient=options, formants=options),
                        device=CARD)
        arrays, _, sources = runner.decode()
        compiled = runner.compile(sources, "export")
        [key] = arrays
        clips = s16_clips(signals, arrays[key].shape[1])
        bargs, blens, singles_args = batch_and_singles(key, clips, [n] * BATCH,
                                                       dev)
        resamples, chains, phase_paths, locks = [], [], [], []
        zero_counts()
        with recorded_launches(resamples=resamples, chains=chains,
                               phase_paths=phase_paths, locks=locks):
            outs, meta = compiled.run_batch(bargs, blens)
        batch_counts = read_counts()
        audio_s = sum(outs["master"][1]) / meta["master"]["rate"]
        paths[f"{what}_batch8"] = batch_counts
        single_chains, singles = [], []
        for b, args in enumerate(singles_args):
            zero_counts()
            with recorded_launches(chains=single_chains):
                singles.append(compiled(args)[0])
            if b == 0:
                counts_match(f"{what}, {BATCH} x {BATCH_SECONDS} s",
                             batch_counts, read_counts())
        check_clips(tag, f"{what}, {BATCH} clips of {BATCH_SECONDS} s (bench "
                         f"tones, seeds 20 to {19 + BATCH})", outs, singles,
                    card,
                    min_db=None if algo == "wsola" else BATCH_PV_DB)
        del outs, singles
        kernels[f"{what}_resample_err"] = check_resamples(
            f"{tag} {what}", resamples, batch_counts["polyphase_resample"],
            card)
        if algo == "wsola":
            check(len(chains) == batch_counts["wsola_chain"] == 2,
                  f"{tag}: {len(chains)} batched chains recorded")
            wsola_batch_checks(tag, chains, single_chains, kernels, card)
        else:
            pv_batch_checks(tag, what, phase_paths, locks, batch_counts,
                            kernels, card)
        del resamples, chains, single_chains, phase_paths, locks
        runs = {"batch": [], "singles": []}
        for name in ("batch", "singles", "singles", "batch"):
            fn = ((lambda: compiled.run_batch(bargs, blens)) if name == "batch"
                  else (lambda: [compiled(a) for a in singles_args]))
            runs[name] += cuda_ms(fn, BATCH_ITERS // 2, warmup=1)
        med, lo, hi, count = summary(runs["batch"])
        smed, slo, shi, scount = summary(runs["singles"])
        figures[f"{what}_batch8_ms"] = med
        figures[f"{what}_8_singles_ms"] = smed
        label = algo + (", pv_transient and preserve_formants" if options
                        else "")
        print(f"[{tag}] {what} ({label}), {BATCH} x {BATCH_SECONDS} s: "
              f"run_batch median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
              f"n={count}); {BATCH} single renders of the same clips median "
              f"{smed:.4f} ms (min {slo:.4f}, max {shi:.4f}, n={scount}), "
              f"{smed / med:.2f}x the batch's time; RTF "
              f"{audio_s / (med / 1e3):.1f} audio-s ({audio_s:.3f} of output) "
              f"per device-s batched (CUDA events) ({card})")
        del bargs, singles_args, compiled, runner

    # -- (d) one batch with differing lengths ---------------------------------
    cut = [int(RATE * s) for s in BATCH_LENGTHS_S]
    runner = Runner(config4_graph(track), device=CARD)
    arrays, _, sources = runner.decode()
    compiled = runner.compile(sources, "export")
    [key] = arrays
    clips = s16_clips([sig[:, :m] for sig, m in zip(signals, cut)],
                      arrays[key].shape[1])
    bargs, blens, singles_args = batch_and_singles(key, clips, cut, dev)
    zero_counts()
    outs, _ = compiled.run_batch(bargs, blens)
    paths["config4_batch_lengths"] = read_counts()
    singles = [compiled(a)[0] for a in singles_args]
    check_clips(tag, f"config4, clips of {list(BATCH_LENGTHS_S)} s in one "
                     f"{BATCH_SECONDS} s capacity", outs, singles, card)
    check(len(set(outs["master"][1])) == len(cut),
          f"{tag}: the clips' output lengths are not their own")
    del outs, singles, bargs, singles_args

    # -- (g) a graph with an unbatched node -----------------------------------
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = [track]
    g.update_node_pin(src)
    rs = g.add_node(AudioResample())
    g.nodes[rs].processor.set_target_rate(48_000)
    dl = g.add_node(AudioDelay())
    out = g.add_node(AudioOutput())
    g.add_link(_pin(g, src, "output_0"), _pin(g, rs, "input"))
    g.add_link(_pin(g, rs, "output"), _pin(g, dl, "input"))
    g.add_link(_pin(g, dl, "output"), _pin(g, out, "input"))
    # Every node type has a batched lowering: this delay's is taken away.
    g.nodes[dl].processor.batched = False
    runner = Runner(g, device=CARD)
    arrays, _, sources = runner.decode()
    compiled = runner.compile(sources, "export")
    [key] = arrays
    bargs, blens, _ = batch_and_singles(key, clips, cut, dev)
    paths["refused_batch"] = refused_batch(
        tag, "input -> resample -> delay (its batched lowering taken away) "
        "-> output", compiled, bargs, blens, f"node {dl} (audio_delay)", card)
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[30 figures] {json.dumps(figures)}")
    return paths, figures, kernels


def wsola_batch_checks(tag: str, chains, single_chains, kernels,
                       card: str, prefix: str = "", min_ties: int = 0) -> None:
    """Phases 30 and 31's WSOLA checks: every batched chain launch, clip by
    clip, against the plain scoring and assembly (check_chain, each clip's
    near ties at most TIE_SHARE of its K or ``min_ties``), each clip's
    splices equal to its single render's (``single_chains``: every single
    render's chains, clip by clip, as many a render as ``chains``), the
    batched energy prologue against its plain version, and both kernels'
    batched times of the first stage, under ``prefix`` in ``kernels``."""
    import torch

    from nodey_tpu_torch.ops import cuda_wsola, wsola

    worst = energy_rel = 0.0
    for stage, (x, head, args, (bs, body)) in enumerate(chains):
        geo = dict(zip(("K", "num", "den", "seq", "seek", "overlap"), args))
        B = x.shape[0]
        for b in range(B):
            _, _, err = check_chain(f"batched chain {stage}, clip {b}", x[b],
                                    head[b], geo, card, out=(bs[b], body[b]),
                                    phase=tag, min_ties=min_ties)
            worst = max(worst, err)
            single_bs = single_chains[len(chains) * b + stage][3][0]
            check(torch.equal(single_bs, bs[b]),
                  f"{tag}: chain {stage} clip {b}: splices differ from its "
                  f"single render's")
        K = geo["K"]
        first = min(K, cuda_wsola.BLOCK_FRAMES)
        got = cuda_wsola.wsola_energy_cuda(x, 0, 0, first, *args[1:])
        want = wsola.wsola_energy_plain(x, 0, 0, first, *args[1:])
        energy_rel = max(energy_rel, ((got - want).abs() / want).max().item())
        if stage == 0:
            C, ov, n_cand = x.shape[1], geo["overlap"], geo["seek"] + 1
            stride = geo["seq"] - ov
            runs = {"kernel": [], "plain": [], "one clip": []}
            for name in ("plain", "kernel", "one clip", "one clip", "kernel",
                         "plain"):
                fn = {"kernel": lambda: cuda_wsola.wsola_chain_cuda(
                          x, head, *args),
                      "plain": lambda: wsola.wsola_chain_plain(x, head, *args),
                      "one clip": lambda: cuda_wsola.wsola_chain_cuda(
                          x[0], head[0], *args)}[name]
                runs[name] += cuda_ms(fn, 1, warmup=1)
            eruns = cuda_ms(lambda: cuda_wsola.wsola_energy_cuda(
                x, 0, 0, K, *args[1:]), 3)
            kernels[prefix + "wsola_chain"] = dict(
                shape=list(x.shape), K=K, ms=summary(runs["kernel"])[0],
                plain_ms=summary(runs["plain"])[0],
                one_clip_ms=summary(runs["one clip"])[0],
                bound=bound(4 * (x.numel() + B * K + B * C * K * stride),
                            2 * B * C * ov * n_cand * K))
            kernels[prefix + "wsola_energy"] = dict(
                shape=[B, K, n_cand], ms=summary(eruns)[0],
                bound=bound(4 * (x.numel() + B * K * n_cand),
                            2 * B * C * ov * n_cand * K))
            t = kernels[prefix + "wsola_chain"]
            print(f"[{tag}] WSOLA chain, pitch stage, {B} clips x K={K} in "
                  f"one launch each of chain and prologue: median "
                  f"{t['ms']:.4f} ms beside {t['one_clip_ms']:.4f} ms for one "
                  f"clip alone and {t['plain_ms']:.4f} ms plain; bound "
                  f"{t['bound'][0]:.4f} ms by {t['bound'][1]}; the prologue "
                  f"alone {kernels[prefix + 'wsola_energy']['ms']:.4f} ms "
                  f"({card})")
    print(f"[{tag}] batched energy prologue, every clip of both stages: max "
          f"|kernel - plain| / plain = {energy_rel:.3e} (tol {ENERGY_REL:.0e})"
          f" ({card})")
    check(energy_rel <= ENERGY_REL, f"{tag}: the batched prologue disagrees")
    kernels[prefix + "wsola_err"] = worst
    kernels[prefix + "energy_rel"] = energy_rel


def pv_batch_checks(tag: str, what: str, phase_paths, locks, counts, kernels,
                    card: str) -> None:
    """Phase 30's PV checks: every batched phase-path launch against the
    plain phase path on its folded planes (>= PV_PLANE_DB), every batched
    lock launch against the plain lock (TOL, bitwise on finite inputs), and
    the first launch's time beside its bound and plain version."""
    from nodey_tpu_torch.ops import cuda_pv, pv

    check(len(phase_paths) == counts["pv_phase_path"]
          and len(locks) == counts["pv_lock"],
          f"{tag}: {what}: {len(phase_paths)} phase paths and {len(locks)} "
          f"locks recorded, the path counted {counts}")
    for (re, im, dpos, hop, n_fft, lock), got in phase_paths:
        want = pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)
        db = min(plane_snr_db(w, g) for w, g in zip(want, got))
        print(f"[{tag}] {what}: batched phase path, planes {list(re.shape)} "
              f"(clips folded into channels), lock {lock}: SNR {db:.1f} dB "
              f"against plain (min {PV_PLANE_DB:.0f}) ({card})")
        check(db >= PV_PLANE_DB, f"{tag}: a batched phase path disagrees")
        del want
    lock_err = 0.0
    for lock_in, got in locks:
        err, differ, finite = lock_against_plain(got, lock_in)
        print(f"[{tag}] {what}: batched lock, planes {list(lock_in[3].shape)}"
              f": max|kernel - plain| = {err:.3e} (tol {TOL:.0e}), {differ} "
              f"elements not bitwise (inputs finite: {finite}) ({card})")
        check(err <= TOL and (differ == 0 or not finite),
              f"{tag}: a batched lock disagrees with the plain lock")
        lock_err = max(lock_err, err)
    kernels[f"{what}_lock_err"] = lock_err
    if phase_paths and "pv_phase_path" not in kernels:
        (re, im, dpos, hop, n_fft, lock), _ = phase_paths[0]
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = (cuda_pv.phase_path_cuda if name == "kernel"
                  else pv.phase_path_plain)
            runs[name] += cuda_ms(lambda: fn(re, im, dpos, hop, n_fft, lock),
                                  2, warmup=1)
        kernels["pv_phase_path"] = dict(
            shape=list(re.shape), ms=summary(runs["kernel"])[0],
            plain_ms=summary(runs["plain"])[0],
            bound=bound(4 * 4 * re.numel(), 33 * re.numel()))
    if locks and "pv_lock" not in kernels:
        lock_in, _ = locks[0]
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = (cuda_pv.lock_to_peaks_cuda if name == "kernel"
                  else pv._lock_to_peaks)
            runs[name] += cuda_ms(lambda: fn(*lock_in), 2, warmup=1)
        kernels["pv_lock"] = dict(
            shape=list(lock_in[3].shape), ms=summary(runs["kernel"])[0],
            plain_ms=summary(runs["plain"])[0],
            bound=lock_work_bound(lock_in[3].shape))


def run_batch_case(tag: str, card: str, dev, tmp: str, paths: dict,
                   figures: dict, kernels: dict, what: str, make_graph,
                   rate: int, inputs: int, mode: str, quiet=False,
                   sibilant=False, lengths_s=None, timed=True,
                   profiled=False, seed=BATCH_SEED):
    """Phases 31 and 32: the graph (``make_graph`` on one track per input,
    clip 0 of each, which Runner decodes for the capacity) on a batch of
    clips (BATCH of BATCH_SECONDS, or one a length of ``lengths_s``;
    bench tones from ``seed`` on) beside their single renders: launch
    counts into ``paths[what + "_batch"]``, every clip bitwise its single
    render, every resampler and chain launch against plain (into
    ``kernels``), with ``timed`` both by CUDA events (into ``figures``),
    and with ``profiled`` both under torch.profiler. Returns the batch's
    resampler launches."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import write_wav_s16
    from nodey_tpu_torch.ops import scans

    lengths_s = lengths_s or (BATCH_SECONDS,) * BATCH
    signals = []
    for j in range(inputs):
        row = []
        for b, seconds in enumerate(lengths_s):
            x = bench_tone(rate * BATCH_SECONDS, rate,
                           160.0 + 25.0 * b + 60.0 * j, 2,
                           seed + 10 * j + b)
            if sibilant:
                add_sibilance(x)
            if quiet and b == 1:
                x *= np.float32(BATCH_QUIET)
            row.append(x[:, : int(rate * seconds)])
        signals.append(row)
    tracks = []
    for j, row in enumerate(signals):
        path = os.path.join(tmp, f"batch_{what}_{j}.wav")
        write_wav_s16(path, row[0], rate)
        tracks.append(path)
    runner = Runner(make_graph(tracks), device=CARD)
    arrays, _, sources = runner.decode()
    compiled = runner.compile(sources, mode)
    check(len(compiled.input_keys) == inputs,
          f"{tag}: {what}: inputs {compiled.input_keys}")
    bargs, blens = {}, {}
    for key, row in zip(compiled.input_keys, signals):
        bargs[key] = torch.from_numpy(
            s16_clips(row, arrays[key].shape[1])).to(dev)
        blens[key] = tuple(sig.shape[1] for sig in row)
    singles_args = [{key: (bargs[key][b], blens[key][b])
                     for key in compiled.input_keys}
                    for b in range(len(lengths_s))]
    resamples, chains, gemms = [], [], []
    gemm = scans._gemm

    def counted_gemm(v, m, clips=False):
        gemms.append(v.shape[0] if clips else 1)
        return gemm(v, m, clips)

    zero_counts()
    scans._gemm = counted_gemm
    try:
        with recorded_launches(resamples=resamples, chains=chains):
            outs, meta = compiled.run_batch(bargs, blens)
    finally:
        scans._gemm = gemm
    counts = paths[f"{what}_batch"] = read_counts()
    if gemms:
        print(f"[{tag}] {what}: {len(gemms)} scan and DFT GEMMs, run "
              f"clip by clip as {sum(gemms)} matmuls ({card})")
    single_chains, singles = [], []
    for b, args in enumerate(singles_args):
        zero_counts()
        with recorded_launches(chains=single_chains):
            singles.append(compiled(args)[0])
        if b == 0:
            single_counts = read_counts()
            print(f"[{tag}] {what}: launches of the batch {counts}, of "
                  f"one clip's render {single_counts} ({card})")
            check(counts == single_counts, f"{tag}: {what}: the batch "
                  f"launched {counts}, one clip {single_counts}")
    check_clips(tag, f"{what}, {len(lengths_s)} clips of "
                     f"{sorted(set(lengths_s), reverse=True)} s"
                     + (", the second 40 dB down" if quiet else ""),
                outs, singles, card)
    key = "master" if mode == "export" else "preview"
    audio_s = sum(outs[key][1]) / meta[key]["rate"]
    del outs, singles
    if counts["polyphase_resample"]:
        kernels[f"{what}_resample_err"] = check_resamples(
            f"{tag} {what}", resamples, counts["polyphase_resample"],
            card)
    if counts["wsola_chain"]:
        check(len(chains) == counts["wsola_chain"]
              == counts["wsola_energy"],
              f"{tag}: {what}: {len(chains)} batched chains recorded, "
              f"counted {counts}")
        # K = 821 here: 0.1% of a clip's frames rounds down to none,
        # so each clip may hold one near tie.
        wsola_batch_checks(f"{tag} {what}", chains, single_chains,
                           kernels, card, prefix=f"{what}_", min_ties=1)
    del chains, single_chains
    if timed:
        runs = {"batch": [], "singles": []}
        for name in ("batch", "singles", "singles", "batch"):
            fn = ((lambda: compiled.run_batch(bargs, blens))
                  if name == "batch"
                  else (lambda: [compiled(a) for a in singles_args]))
            runs[name] += cuda_ms(fn, BATCH_ITERS // 2, warmup=1)
        med, lo, hi, count = summary(runs["batch"])
        smed, slo, shi, scount = summary(runs["singles"])
        if profiled:
            profile_render(lambda: compiled.run_batch(bargs, blens),
                           card, tag, f"{what} batch", top=8)
            profile_render(lambda: [compiled(a) for a in singles_args],
                           card, tag, f"{what} {len(lengths_s)} singles",
                           top=8)
        figures[f"{what}_batch{len(lengths_s)}_ms"] = med
        figures[f"{what}_{len(lengths_s)}_singles_ms"] = smed
        print(f"[{tag}] {what} ({mode}), {len(lengths_s)} clips: "
              f"run_batch median {med:.4f} ms (min {lo:.4f}, max "
              f"{hi:.4f}, n={count}); {len(lengths_s)} single renders "
              f"of the same clips median {smed:.4f} ms (min {slo:.4f}, "
              f"max {shi:.4f}, n={scount}), {smed / med:.2f}x the "
              f"batch's time; RTF {audio_s / (med / 1e3):.1f} audio-s "
              f"({audio_s:.3f} of output) per device-s batched (CUDA "
              f"events) ({card})")
    del bargs, singles_args, compiled, runner
    return resamples


def batch_configs_phase(cli, card: str, dev, tmp: str):
    """Phase 31 (see the module docstring): BASELINE configs 2, 5, 6 and 7,
    graph A, the peak graph and split -> bimix_v2 through
    ``CompiledGraph.run_batch``. Returns (the launch counts by path, the
    figures: each timed batch beside eight single renders of its clips, by
    CUDA events, and config 5's batched launches of the resampler, the
    chain and the prologue held against their plain versions, with their
    times and bounds)."""
    import torch
    import torch.nn.functional as F

    from nodey_tpu_torch.ops import cuda_resample
    from nodey_tpu_torch.ops import resample as tr

    tag = "31 batch-configs"
    t0 = time.perf_counter()
    paths, figures, kernels = {}, {}, {}

    def run_case(*args, **kwargs):
        return run_batch_case(tag, card, dev, tmp, paths, figures, kernels,
                              *args, **kwargs)

    run_case("config2", config2_graph, RATE, 1, "export")
    resamples = run_case("config5", config5_graph, RATE, 4, "preview")
    # Config 5's batched -3 semitone transposition: its time beside its
    # bound, the plain version and F.conv1d.
    to_48k = tr._rational(RATE, MASTER_RATE)
    [(tx, G, M, W, bank, support)] = [
        args for args, _ in resamples
        if (args[4].shape[0], args[2]) != to_48k]
    del resamples
    rows = tx.reshape(-1, tx.shape[-1])
    transpose_bound = resample_work_bound(rows, G, M, bank)
    times = time_resampler(
        tag, f"config 5's batched transposition {bank.shape[0]}/{M}, x "
        f"{list(tx.shape)} (clips folded into rows)", {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        tx, G, M, W, support),
            "plain": functools.partial(tr.apply_filter_bank_plain, tx, G, M,
                                       W, bank),
            "conv1d": functools.partial(F.conv1d, rows.view(-1, 1,
                                                            rows.shape[-1]),
                                        bank.view(-1, 1, W), stride=M)},
        ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"), 5, card,
        transpose_bound)
    kernels["config5_transposition"] = dict(
        shape=list(tx.shape), ms=times["kernel"], plain_ms=times["plain"],
        library_ms=times["conv1d"], bound=transpose_bound)
    del tx, rows
    run_case("config6", config6_graph, MASTER_RATE, 1, "export", quiet=True)
    run_case("config6_lengths", config6_graph, MASTER_RATE, 1, "export",
             quiet=True, lengths_s=BATCH_LENGTHS_S, timed=False)
    run_case("config7", config7_graph, MASTER_RATE, 1, "export",
             profiled=True)
    run_case("graph_a", graph_a, MASTER_RATE, 1, "export", quiet=True,
             sibilant=True, timed=False)
    run_case("peak", peak_graph, RATE, 1, "export", quiet=True, timed=False)
    run_case("bimix_v2", bimix_v2_graph, RATE, 1, "export", timed=False)
    figures["gemm_fold"] = gemm_fold_probe(tag, dev, card)
    torch.cuda.synchronize()
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[31 figures] {json.dumps(figures)}")
    return paths, figures, kernels


# Phase 32's graph (c): every channel node in one chain, the fade anchored
# at each clip's own end.
CHANNEL_NODES = [
    ("audio_phaser", dict(rate_hz=0.4, f_min_hz=300.0, f_max_hz=2500.0,
                          wet=0.5)),
    ("audio_width", dict(width=1.4)),
    ("audio_pan", dict(pan=-0.25)),
    ("audio_delay", dict(delay_ms=240.0, feedback=0.35, wet=0.18)),
    ("audio_tremolo", dict(rate_hz=5.0, depth=0.5)),
    ("audio_chorus", {}),
    ("audio_fade", dict(in_ms=120.0, out_ms=600.0, anchor_end=True)),
]
BATCH_TRIM_S = (1.0, 25.0)       # phase 32 (e): trim's start and end


def batch_effects_phase(cli, card: str, dev, tmp: str):
    """Phase 32 (see the module docstring): the channel nodes, the
    crossfade, trim, reverse and the generator through
    ``CompiledGraph.run_batch``. Returns (the launch counts by path, the
    figures: each timed batch beside eight single renders of its clips, by
    CUDA events, and the mixed-rate batch's resampler launch held against
    its plain version, with its time, bound and library call)."""
    import torch.nn.functional as F

    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.ops import cuda_resample
    from nodey_tpu_torch.ops import resample as tr

    tag = "32 batch-effects"
    t0 = time.perf_counter()
    paths, figures, kernels = {}, {}, {}

    def run_case(*args, **kwargs):
        return run_batch_case(tag, card, dev, tmp, paths, figures, kernels,
                              *args, seed=40, **kwargs)

    def splice(tracks):
        shipped = os.path.join(ROOT, "examples", "projects",
                               "crossfade_splice.json")
        return cli._load_graph(project_with_tracks(
            shipped, tracks, os.path.join(tmp, "batch_splice.json")))

    run_case("example_strip", lambda p: _chain(p, EXAMPLE_STRIP),
             MASTER_RATE, 1, "export")
    run_case("modfx", lambda p: _chain(p, MODFX_CHAIN), MASTER_RATE, 1,
             "export")
    run_case("channel_nodes_lengths", lambda p: _chain(p, CHANNEL_NODES),
             MASTER_RATE, 1, "export", lengths_s=BATCH_LENGTHS_S,
             timed=False)
    run_case("splice", splice, MASTER_RATE, 2, "export")
    run_case("trim_reverse_lengths", lambda p: _chain(p, [
        ("audio_trim", dict(start_s=BATCH_TRIM_S[0], end_s=BATCH_TRIM_S[1])),
        ("audio_reverse", {})]), MASTER_RATE, 1, "export",
        lengths_s=BATCH_LENGTHS_S, timed=False)
    resamples = run_case("mixed_rate", functools.partial(
        mixed_rate_graph, seconds=BATCH_SECONDS), RATE, 1, "export")
    check(len(resamples) == 1 == paths["mixed_rate_batch"][
        "polyphase_resample"], f"{tag}: the mixed-rate batch launched the "
        f"resampler {len(resamples)} times")
    # The mixed-rate batch's 44.1 -> 48 kHz launch, clips folded into rows:
    # its time beside its bound, the plain version and F.conv1d.
    [((x, G, M, W, bank, support), _)] = resamples
    del resamples
    rows = x.reshape(-1, x.shape[-1])
    work_bound = resample_work_bound(rows, G, M, bank)
    times = time_resampler(
        tag, f"the mixed-rate batch's resample {bank.shape[0]}/{M}, x "
        f"{list(x.shape)} (clips folded into rows)", {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support),
            "plain": functools.partial(tr.apply_filter_bank_plain, x, G, M,
                                       W, bank),
            "conv1d": functools.partial(F.conv1d, rows.view(-1, 1,
                                                            rows.shape[-1]),
                                        bank.view(-1, 1, W), stride=M)},
        ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"), 5, card,
        work_bound)
    kernels["mixed_rate_resample"] = dict(
        shape=list(x.shape), ms=times["kernel"], plain_ms=times["plain"],
        library_ms=times["conv1d"], bound=work_bound)
    del x, rows

    # -- (g) a graph with no external input -----------------------------------
    g = Graph()
    gen = _generator(g, waveform="triangle", freq=97.0, level_db=-18.0,
                     duration_s=BATCH_SECONDS, rate=MASTER_RATE, channels=2)
    _output(g, _pin(g, gen, "output"))
    runner = Runner(g, device=CARD)
    _, _, sources = runner.decode()
    paths["refused_generator_batch"] = refused_batch(
        tag, "generator -> output", runner.compile(sources, "export"), {}, {},
        "no external input", card)
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[32 figures] {json.dumps(figures)}")
    return paths, figures, kernels


def gemm_fold_probe(tag: str, dev, card: str) -> dict:
    """What running the batch's GEMMs clip by clip costs: config 6's scan
    GEMM ([B, 2, blocks, 256] x [256, 256], B clips of BATCH_SECONDS at 48
    kHz) and config 7's forward and inverse DFT GEMMs ([B, 2, hops, 4096]
    x [4096, 2049], [B, 2, hops, 4098] x [4098, 4096]) on random data,
    folded into one matmul and clip by clip (``scans._gemm``): both times
    (CUDA events, medians) and whether the folded result is bitwise the
    clip-by-clip one. Then the loudness gate's float sums, which the batch
    runs over all clips at once: the 100 ms hop sums ([B, 2, hops, 4800]
    summed over the last axis) and ``integrated_lufs`` on B clips of other
    lengths, each against the clips one at a time."""
    import torch

    from nodey_tpu_torch.ops import loudness, reverb, scans

    n = MASTER_RATE * BATCH_SECONDS
    hops = -(-(n + reverb.ir_length(MASTER_RATE, 1.8, 20.0) - 1)
             // reverb.PARTITION)
    gen = torch.Generator(device=dev).manual_seed(31)
    cases = {"scan 256": ((-(-n // 256), 256), 256),
             "dft forward": ((hops, 2 * reverb.PARTITION), 2049),
             "dft inverse": ((hops, 4098), 2 * reverb.PARTITION)}
    out = {}
    for name, ((rows, k), cols) in cases.items():
        v = torch.randn((BATCH, 2, rows, k), generator=gen, device=dev)
        m = torch.randn((k, cols), generator=gen, device=dev)
        same = torch.equal(scans._gemm(v, m), scans._gemm(v, m, clips=True))
        runs = {"folded": [], "clip by clip": []}
        for order in ("folded", "clip by clip", "clip by clip", "folded"):
            runs[order] += cuda_ms(lambda: scans._gemm(
                v, m, clips=order == "clip by clip"), 3, warmup=1)
        med = {k: summary(r)[0] for k, r in runs.items()}
        out[name] = dict(shape=[list(v.shape), list(m.shape)],
                         folded_ms=med["folded"],
                         clip_ms=med["clip by clip"], bitwise=same)
        print(f"[{tag}] GEMM {name} {list(v.shape)} x {list(m.shape)}: "
              f"folded {med['folded']:.4f} ms, clip by clip "
              f"{med['clip by clip']:.4f} ms ({BATCH} launches); folded "
              f"{'bitwise' if same else 'NOT bitwise'} the clip-by-clip "
              f"result ({card})")
        del v, m
    x = 0.1 * torch.randn((BATCH, 2, n), generator=gen, device=dev)
    lengths = tuple(n - b * (n // (2 * BATCH)) for b in range(BATCH))
    hop = loudness.block_geometry(MASTER_RATE, n)[0]
    zz = x[..., : n // hop * hop].reshape(BATCH, 2, -1, hop) ** 2
    sums_same = torch.equal(zz.sum(dim=-1),
                            torch.stack([clip.sum(dim=-1) for clip in zz]))
    del zz
    fns = {"batch": lambda: loudness.integrated_lufs(x, lengths, MASTER_RATE,
                                                     clips=True),
           "clip by clip": lambda: torch.stack([
               loudness.integrated_lufs(x[b], lengths[b], MASTER_RATE)
               for b in range(BATCH)])}
    same = torch.equal(fns["batch"](), fns["clip by clip"]())
    runs = {"batch": [], "clip by clip": []}
    for order in ("batch", "clip by clip", "clip by clip", "batch"):
        runs[order] += cuda_ms(fns[order], 3, warmup=1)
    med = {k: summary(r)[0] for k, r in runs.items()}
    out["loudness"] = dict(shape=list(x.shape), batch_ms=med["batch"],
                           clip_ms=med["clip by clip"], hop_sums=sums_same,
                           bitwise=same)
    print(f"[{tag}] loudness gate on {list(x.shape)}, lengths "
          f"{list(lengths)}: hop sums over the batch "
          f"{'bitwise' if sums_same else 'NOT bitwise'} each clip's alone; "
          f"integrated_lufs of the batch {med['batch']:.4f} ms, clip by clip "
          f"{med['clip by clip']:.4f} ms, the batch's "
          f"{'bitwise' if same else 'NOT bitwise'} the clips' ({card})")
    return out


def peak_graph(paths):
    """Phase 31's peak graph: a 44.1 kHz track -> resample to 48 kHz ->
    gain 4 -> audio_limiter (-1 dB: acting on every clip but a quiet one) ->
    audio_normalize (peak, -3 dBFS) -> output."""
    from nodey_tpu_torch.processors.limiter import AudioLimiter
    from nodey_tpu_torch.processors.normalize import AudioNormalize
    from nodey_tpu_torch.processors.resample_node import AudioResample

    g, src = _input_graph(paths[:1])
    rs = AudioResample()
    rs.set_target_rate(MASTER_RATE)
    lim = AudioLimiter()
    lim.set_threshold_db(LIMITER_DB)
    norm = AudioNormalize()
    norm.set_mode("peak")
    norm.set_param("target_db", PEAK_DB)
    prev = _pin(g, src, "output_0")
    for nid in (g.add_node(rs), _gain(g, 4.0), g.add_node(lim),
                g.add_node(norm)):
        g.add_link(prev, _pin(g, nid, "input"))
        prev = _pin(g, nid, "output")
    _output(g, prev)
    return g


def bimix_v2_graph(paths):
    """Phase 31's split -> bimix_v2 graph: the 44.1 kHz stereo track ->
    audio_split -> audio_bimix_v2 -> output."""
    from nodey_tpu_torch.processors.bimix import AudioBimixV2
    from nodey_tpu_torch.processors.split import AudioSplit

    g, src = _input_graph(paths[:1])
    split = g.add_node(AudioSplit())
    merge = g.add_node(AudioBimixV2())
    g.add_link(_pin(g, src, "output_0"), _pin(g, split, "input"))
    g.add_link(_pin(g, split, "output_l"), _pin(g, merge, "input_l"))
    g.add_link(_pin(g, split, "output_r"), _pin(g, merge, "input_r"))
    _output(g, _pin(g, merge, "output"))
    return g


# -- phase 33: the web editor's server on the card ------------------------------

SERVE_POLL_S = 0.005                     # /api/state poll period
SERVE_TIMED_RUNS = 3                     # timed served and CLI exports, in turns
SERVE_VOLUMES = {"volumes0": 0.6, "volumes1": 0.4}  # the edit: amix levels


class ServeClient:
    """HTTP requests to a served editor on 127.0.0.1 with its token."""

    def __init__(self, srv):
        self.port = srv.server_address[1]
        self.token = srv.viewer.auth_token

    def request(self, method: str, path: str, body=None):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"X-Nodey-Token": self.token})
        resp = conn.getresponse()
        payload = resp.read()
        conn.close()
        return resp.status, payload

    def json(self, method: str, path: str, body=None):
        status, payload = self.request(method, path, body)
        check(status == 200, f"33 serve: {method} {path} answered {status}: "
                             f"{payload[:300]!r}")
        return json.loads(payload)

    def wait(self, until, timeout: float = 600.0):
        """Poll /api/state every SERVE_POLL_S until ``until(state)``; returns
        (the last state, every state polled)."""
        polls = []
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            polls.append(self.json("GET", "/api/state"))
            if until(polls[-1]):
                return polls[-1], polls
            time.sleep(SERVE_POLL_S)
        fail(f"33 serve: /api/state never reached the awaited state: "
             f"{polls[-1]}")

    def stream(self, path: str):
        """GET ``path`` read to EOF; returns (bytes, seconds from the request
        to the first byte past the 44-byte WAV header)."""
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        t0 = time.perf_counter()
        conn.request("GET", path, headers={"X-Nodey-Token": self.token})
        resp = conn.getresponse()
        check(resp.status == 200, f"33 serve: GET {path} answered "
                                  f"{resp.status}")
        parts, got, first = [], 0, None
        while True:
            part = resp.read1(1 << 16)
            if not part:
                break
            parts.append(part)
            got += len(part)
            if first is None and got > 44:
                first = time.perf_counter() - t0
        conn.close()
        return b"".join(parts), first


@contextlib.contextmanager
def counting_plain_resampler(calls: list):
    """Every call of the resampler's plain version in the block is counted
    in ``calls`` (the served paths must take the kernel alone)."""
    from nodey_tpu_torch.ops import resample as tr

    plain = tr.apply_filter_bank_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    tr.apply_filter_bank_plain = counted
    try:
        yield
    finally:
        tr.apply_filter_bank_plain = plain


def serve_phase(cli, card: str, tmp: str, proj_5node: str, excerpt_tracks):
    """Phase 33 (see the module docstring): the web editor's server
    (``nodey_tpu_torch.app.server``) on the card, in process on
    127.0.0.1:0. ``proj_5node``: phase 4's 300 s project; ``excerpt_tracks``:
    its 10 s tracks. Returns the launch counts by path."""
    import threading

    import numpy as np

    from nodey_tpu_torch.app import server
    from nodey_tpu_torch.core.streaming import StreamingSession

    tag = "33 serve"
    srv = server.serve(cli._load_graph(proj_5node), "phase 33",
                       "127.0.0.1", 0, project_path=proj_5node, device=CARD)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = ServeClient(srv)
    paths = {}
    try:
        graph = client.json("GET", "/api/graph")
        registry = client.json("GET", "/api/registry")
        applied = client.json("POST", "/api/edit/set",
                              {"node_id": 3, "params": SERVE_VOLUMES})
        edited = os.path.join(tmp, "served_two_track_mix.json")
        client.json("POST", "/api/save", {"path": edited})
        print(f"[{tag}] serving {os.path.basename(proj_5node)} on "
              f"{srv.viewer.device} at 127.0.0.1:{client.port}: /api/graph "
              f"{len(graph['nodes'])} nodes, {len(graph['links'])} links; "
              f"/api/registry {len(registry)} node types; /api/edit/set node "
              f"3 -> {applied['applied']}; saved to /api/save's path ({card})")
        check(len(graph["nodes"]) == 6 and len(registry) == 30,
              f"{tag}: the served graph or registry is not the project's")

        # -- the served export against the CLI's streamed export ----------------
        served_wav = os.path.join(tmp, "served.wav")
        plain_calls = []
        zero_counts()
        with counting_plain_resampler(plain_calls):
            t0 = time.perf_counter()
            client.json("POST", "/api/export", {"path": served_wav})
            state, polls = client.wait(lambda s: s["state"] != "running")
            served_wall = time.perf_counter() - t0
        paths["serve_export"] = counts = read_counts()
        staged = [p["stages"] for p in polls if p["stages"] is not None]
        check(state["state"] == "finished",
              f"{tag}: the served export ended {state['state']}: "
              f"{state['error']}")
        print(f"[{tag}] POST /api/export {SECONDS} s -> WAV: finished in "
              f"{served_wall:.3f} s wall from the request (wall RTF "
              f"{SECONDS / served_wall:.1f}; the runner's own RTF "
              f"{state['rtf_compute']:.1f}); {len(polls)} polls of "
              f"/api/state, {len(staged)} with stages (the last: "
              f"{staged[-1] if staged else None}); launches {counts}, plain "
              f"resampler calls {len(plain_calls)} ({card})")
        check(staged and all("steps" in s for s in staged),
              f"{tag}: no poll of /api/state showed the stage gauges")
        cli_wav = os.path.join(tmp, "served_cli.wav")
        cli_calls = []
        zero_counts()
        with counting_plain_resampler(cli_calls):
            rc, text, metrics = stream_export(cli, edited, cli_wav)
        paths["serve_cli_export"] = cli_counts = read_counts()
        print("\n".join(f"[{tag}] cli: {line}" for line in text.splitlines()))
        check(rc == 0, f"{tag}: run --stream exited {rc}")
        with open(served_wav, "rb") as f:
            served_bytes = f.read()
        with open(cli_wav, "rb") as f:
            cli_bytes = f.read()
        same = served_bytes == cli_bytes
        print(f"[{tag}] served export {len(served_bytes)} bytes vs `run "
              f"--export --stream --device {CARD}` of the saved project "
              f"{len(cli_bytes)} bytes: {'bitwise equal' if same else 'DIFFER'};"
              f" resampler launches {counts['polyphase_resample']} served, "
              f"{cli_counts['polyphase_resample']} by the CLI; plain "
              f"resampler calls {len(plain_calls)} and {len(cli_calls)}; CLI "
              f"wall RTF {metrics.audio_seconds / metrics.wall_seconds:.1f} "
              f"({card})")
        check(same, f"{tag}: the served export is not the CLI's")
        check(counts == cli_counts and counts["polyphase_resample"] >= 2,
              f"{tag}: launches {counts} served, {cli_counts} by the CLI")
        check(not plain_calls and not cli_calls,
              f"{tag}: the resampler's plain version ran")
        # The first streamed export of a process pays its cold start (seconds
        # on the card); timed in turns after it, the served export and the
        # CLI's stand side by side.
        walls = {"served": [], "cli": []}
        timed_wav = os.path.join(tmp, "served_timed.wav")
        for _ in range(SERVE_TIMED_RUNS):
            t0 = time.perf_counter()
            client.json("POST", "/api/export", {"path": timed_wav})
            state, _ = client.wait(lambda s: s["state"] != "running")
            walls["served"].append(time.perf_counter() - t0)
            check(state["state"] == "finished", f"{tag}: a timed served "
                                                f"export ended {state}")
            t0 = time.perf_counter()
            rc, _, _ = stream_export(cli, edited, timed_wav)
            walls["cli"].append(time.perf_counter() - t0)
            check(rc == 0, f"{tag}: a timed CLI export exited {rc}")
        rtf = {kind: "{:.1f} ({:.1f}-{:.1f})".format(
            *summary([SECONDS / w for w in ws])[:3])
            for kind, ws in walls.items()}
        print(f"[{tag}] wall RTF of {SERVE_TIMED_RUNS} more exports each, in "
              f"turns, warm (in process, after the earlier phases), median "
              f"(min-max): served (the POST to the poll that "
              f"reads finished, polls every {SERVE_POLL_S * 1e3:g} ms) "
              f"{rtf['served']}; `run --export --stream` {rtf['cli']} "
              f"({card})")

        # -- the live preview against a StreamingSession on the card ------------
        short = project_with_tracks(
            edited, excerpt_tracks, os.path.join(tmp, "served_10s.json"))
        client.json("POST", "/api/open", {"path": short})
        plain_calls = []
        zero_counts()
        with counting_plain_resampler(plain_calls):
            t0 = time.perf_counter()
            pcm, first = client.stream("/api/preview.wav?start=1")
            preview_wall = time.perf_counter() - t0
            state, _ = client.wait(lambda s: s["state"] != "running")
        paths["serve_preview"] = counts = read_counts()
        session = srv.viewer.preview_session
        reference = StreamingSession(cli._load_graph(short),
                                     device=CARD).start(streamed=True)
        want = b"".join(
            np.clip(block.T * np.float32(32767.0), -32768, 32767)
            .astype(np.int16).tobytes() for block in reference.blocks())
        reference.stop()
        same = pcm[44:] == want
        audio_s = (len(pcm) - 44) / (4 * 48_000)
        print(f"[{tag}] GET /api/preview.wav?start=1 on the "
              f"{EXCERPT_SECONDS} s project: {len(pcm) - 44} bytes of "
              f"s16 ({audio_s:.3f} audio-s) in {preview_wall:.3f} s wall, state "
              f"{state['state']}; first audible block {first:.4f} s after the "
              f"request, warm (in process, after the earlier phases; the "
              f"session's own first block after "
              f"{session.stats.first_block_seconds:.4f} s), "
              f"{session.stats.underruns} underruns, {session.stats.blocks} "
              f"blocks; vs a StreamingSession on the card: "
              f"{'bitwise equal' if same else 'DIFFER'}; launches {counts}, "
              f"plain resampler calls {len(plain_calls)} ({card})")
        check(state["state"] == "finished", f"{tag}: the preview ended "
                                            f"{state['state']}")
        check(pcm[:44] == server._wav_stream_header(),
              f"{tag}: the preview stream's header")
        check(same, f"{tag}: the served preview is not a StreamingSession's")
        check(counts["polyphase_resample"] >= 2 and not plain_calls,
              f"{tag}: the preview's resampler: launches {counts}, plain "
              f"calls {len(plain_calls)}")
        check(preview_wall >= 0.98 * audio_s,
              f"{tag}: the served preview ran ahead of 1.0x")

        # -- a stop mid-export ---------------------------------------------------
        client.json("POST", "/api/open", {"path": edited})
        stopped_wav = os.path.join(tmp, "served_stopped.wav")
        zero_counts()
        client.json("POST", "/api/export", {"path": stopped_wav})
        state, _ = client.wait(lambda s: s["seconds"] > 0
                               or s["state"] != "running")
        at = state["seconds"]
        client.json("POST", "/api/stop")
        srv.viewer._job_thread.join(60)
        state, _ = client.wait(lambda s: s["state"] != "running")
        paths["serve_stopped"] = counts = read_counts()
        left = os.path.exists(stopped_wav)
        notes = client.json("GET", "/api/notifications")
        print(f"[{tag}] POST /api/stop at {at:.1f} audio-s of {SECONDS}: "
              f"state {state['state']}, error {state['error']}, partial file "
              f"{'LEFT' if left else 'removed'}, last notification "
              f"{notes[-1]['message']!r}; launches {counts} ({card})")
        check(0 < at < SECONDS, f"{tag}: the stop did not land mid-export")
        check(state["state"] == "stopped" and state["error"] is None,
              f"{tag}: the stopped export reads {state['state']}")
        check(not left, f"{tag}: the stopped export left its partial file")
    finally:
        srv.viewer.stop_preview()
        srv.shutdown()
        srv.server_close()
        thread.join(10)

    # -- run --diagnostics --profile-nodes --trace, doctor -----------------------
    trace_dir = os.path.join(tmp, "trace")
    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["run", short, "--export", os.path.join(tmp, "diag.wav"),
                       "--device", CARD, "--diagnostics", "--profile-nodes",
                       "--trace", trace_dir])
    paths["run_diagnostics"] = read_counts()
    text = stdout.getvalue()
    print("\n".join(f"[{tag}] cli: {line}"
                    for line in text[:text.find("{")].splitlines()))
    check(rc == 0, f"{tag}: run --diagnostics --profile-nodes --trace exited "
                   f"{rc}")
    decoder = json.JSONDecoder()
    report, end = decoder.raw_decode(text, text.index("{"))
    profile, _ = decoder.raw_decode(text, text.index("{", end))
    traces = [os.path.join(trace_dir, name) for name in os.listdir(trace_dir)]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"[{tag}] diagnostics: device_s {report['stages']['device_s']}, "
          f"rtf {report['rtf']}; per-node device s "
          f"{ {nid: e['device_s'] for nid, e in profile.items()} }; trace "
          f"{os.path.basename(traces[0])}: {len(events)} events, "
          f"{len(kernels)} kernel events; launches "
          f"{paths['run_diagnostics']} ({card})")
    check(len(profile) == 6 and kernels,
          f"{tag}: the node profile or the trace's kernel events are missing")
    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["doctor", "--device", CARD])
    paths["doctor"] = read_counts()
    print("\n".join(f"[{tag}] doctor: {line}"
                    for line in stdout.getvalue().splitlines()))
    check(rc == 0, f"{tag}: doctor exited {rc}")
    return paths


# -- phase 34: the mesh ----------------------------------------------------------


def dryrun_chain_graph(path, algorithm="wsola", options=False):
    """The JAX package's multi-chip dry run's time-variant chain
    (__graft_entry__.py:191-282) with the port's processors: resample 48
    kHz -> pitch +3 -> velocity 1.25 keep_pitch -> EQ (p2 -3 dB) -> chorus
    (wet 0.3) -> phaser (wet 0.5) -> tremolo (depth 0.4) -> width 1.3 ->
    limiter -3 dB, both tempo nodes on ``algorithm`` (with ``options``,
    pv_transient on both and preserve_formants on the pitch node)."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.equalizer import AudioEq
    from nodey_tpu_torch.processors.limiter import AudioLimiter
    from nodey_tpu_torch.processors.modulation import (AudioChorus,
                                                       AudioPhaser,
                                                       AudioTremolo)
    from nodey_tpu_torch.processors.pan import AudioWidth
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.velocity import (PitchModifier,
                                                     VelocityModifier)

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    nodes = [src]

    def add(proc, **params):
        nid = g.add_node(proc)
        for key, value in params.items():
            proc.set_param(key, value)
        g.add_link(_pin(g, nodes[-1], "output_0" if nodes[-1] == src
                        else "output"), _pin(g, nid, "input"))
        nodes.append(nid)
        return proc

    add(AudioResample()).set_target_rate(48_000)
    pitch = add(PitchModifier())
    pitch.pitch = 3.0
    vel = add(VelocityModifier())
    vel.set_velocity(1.25)
    vel.keep_pitch = True
    for proc in (pitch, vel):
        proc.set_algorithm(algorithm)
        proc.pv_transient = options
    pitch.preserve_formants = options
    add(AudioEq(), p2_gain_db=-3.0)
    add(AudioChorus(), wet=0.3)
    add(AudioPhaser(), wet=0.5)
    add(AudioTremolo(), depth=0.4)
    add(AudioWidth(), width=1.3)
    add(AudioLimiter()).set_threshold_db(-3.0)
    out = g.add_node(AudioOutput())
    g.add_link(_pin(g, nodes[-1], "output"), _pin(g, out, "input"))
    return g


def mesh_render_times(tag: str, what: str, sharded_fn, single_fn,
                      single_what: str, iters: int, card: str) -> dict:
    """CUDA-event medians of a sharded render and of the single render(s)
    it stands for, timed in turns, printed side by side."""
    runs = {"sharded": [], "single": []}
    for name in ("single", "sharded", "sharded", "single"):
        runs[name] += cuda_ms(sharded_fn if name == "sharded" else single_fn,
                              iters, warmup=1)
    med, lo, hi, count = summary(runs["sharded"])
    smed, slo, shi, scount = summary(runs["single"])
    print(f"[{tag}] {what}: median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
          f"n={count}); {single_what} median {smed:.4f} ms (min {slo:.4f}, "
          f"max {shi:.4f}, n={scount}); {med / smed:.2f}x (CUDA events; a "
          f"virtual mesh of one card measures what the shards add: halos, "
          f"overlapping windows, a launch a shard; not scaling) ({card})")
    return {"ms": med, "single_ms": smed}


def mesh_spectrum_check(tag: str, what: str, got, want, card: str) -> bool:
    """A sharded spectrum's frames against the single render's: bitwise,
    or else their SNR (>= SNR_DB) printed with the reason."""
    import torch

    frames = want.shape[-2]
    got = got[..., :frames, :]
    if torch.equal(got, want):
        print(f"[{tag}] {what}: spectrum {list(want.shape)} bitwise the "
              f"single render's ({card})")
        return True
    db = plane_snr_db(want, got)
    print(f"[{tag}] {what}: spectrum {list(want.shape)} {db:.1f} dB against "
          f"the single render (min {SNR_DB:.0f}): not bitwise, as the "
          f"spectrum's DFT GEMM runs on a window's frame count and cuBLAS "
          f"picks its kernel, and so a frame's order of sums, by the GEMM's "
          f"shape ({card})")
    check(db >= SNR_DB, f"{tag}: {what}: the sharded spectrum disagrees")
    return False


def mesh_sp_case(tag: str, card: str, mesh, paths, kernels: dict) -> dict:
    """Phase 34 (a): the 5-node graph on ``paths`` sharded over the sp
    axis of ``mesh``, against the single render on the card. Returns the
    path's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.parallel import sharded

    g = flagship_graph(paths)
    arrays, lengths, sources = Runner(g, device=CARD).decode()
    rate = next(iter(sources.values())).rate
    sp = mesh.shape["sp"]
    cap = sharded.plan_capacity_for(g, rate, max(lengths.values()), mesh)
    sources = {k: dataclasses.replace(s, capacity=cap)
               for k, s in sources.items()}
    home = mesh.devices.flat[0]
    data = {k: torch.from_numpy(np.pad(v, ((0, 0), (0, cap - v.shape[1]))))
            .to(home) for k, v in arrays.items()}
    args = {k: (v, lengths[k]) for k, v in data.items()}
    single = compiler.compile_graph(g, sources, device=home)
    ref, _ = single(args)
    sc = sharded.compile_graph_sharded(g, sources, mesh)
    resamples = []
    zero_counts()
    with recorded_launches(resamples=resamples):
        out = sc.run(data, lengths)
    counts = read_counts()
    what = (f"5-node graph, two {SECONDS} s tracks, sp {sp} over "
            f"{[str(d) for d in mesh.devices.flat]}")
    print(f"[{tag}] {what}: capacity {cap}, plan chunk {sc.plan.chunk} + 2 x "
          f"halo {sc.plan.halo}; launches {counts} ({card})")
    check(counts["polyphase_resample"] == len(data) * sp,
          f"{tag}: {counts['polyphase_resample']} resampler launches, want "
          f"{len(data)} inputs x {sp} shards")
    kernels["resample_err"] = max(kernels.get("resample_err", 0.0),
                                  check_resamples(tag, resamples,
                                                  counts["polyphase_resample"],
                                                  card))
    del resamples
    (master, glen), (want, want_len) = out["master"], ref["master"]
    same = torch.equal(master, want)
    print(f"[{tag}] {what}: master {list(master.shape)}, length {glen} "
          f"(single {want_len}), {'bitwise' if same else 'NOT bitwise'} the "
          f"single render's ({card})")
    check(same and glen == want_len, f"{tag}: the sharded master differs")
    [key] = [k for k in ref if k.startswith("spectrum_")]
    kernels.setdefault("spectrum_bitwise", []).append(
        mesh_spectrum_check(tag, what, out[key], ref[key], card))
    del out, ref, master, want
    times = mesh_render_times(tag, what, lambda: sc.run(data, lengths),
                              lambda: single(args), "the single render", 3,
                              card)
    kernels.setdefault("times", {})[f"5node_sp{sp}"] = times
    return counts


def mesh_dp_sp_case(tag: str, card: str, mesh, tmp: str, kernels: dict,
                    dp_mesh=None) -> dict:
    """Phase 34 (b), and with ``dp_mesh`` (e): the 5-node graph over
    MESH_CLIPS clips of MESH_CLIP_SECONDS s sharded dp x sp on ``mesh``,
    each clip against its single render; then run_batch(mesh=dp_mesh)
    against run_batch. Returns the launch counts by path."""
    import dataclasses

    import torch

    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import write_wav_s16
    from nodey_tpu_torch.parallel import sharded

    n = RATE * MESH_CLIP_SECONDS
    tracks = []
    for i in range(2):
        path = os.path.join(tmp, f"mesh_5node_{i}.wav")
        if not os.path.exists(path):
            write_wav_s16(path, bench_tone(n, RATE, 220.0 * (i + 1), 2, i),
                          RATE)
        tracks.append(path)
    g = flagship_graph(tracks)
    _, _, sources = Runner(g, device=CARD).decode()
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    cap = sharded.plan_capacity_for(g, RATE, n, mesh)
    sources = {k: dataclasses.replace(s, capacity=cap)
               for k, s in sources.items()}
    home = mesh.devices.flat[0]
    lens = [n - 9_973 * b for b in range(MESH_CLIPS)]
    data, blens = {}, {}
    for i, key in enumerate(sorted(compiler.external_key(*k)
                                   for k in sources)):
        signals = [bench_tone(n, RATE, 220.0 * (i + 1) + 10.0 * b, 2,
                              60 + 10 * i + b)[:, :m]
                   for b, m in enumerate(lens)]
        data[key] = torch.from_numpy(s16_clips(signals, cap)).to(home)
        blens[key] = tuple(lens)
    sc = sharded.compile_graph_sharded(g, sources, mesh, dp_axis="dp")
    single = compiler.compile_graph(g, sources, device=home)
    what = (f"5-node graph, {MESH_CLIPS} clips of {MESH_CLIP_SECONDS} s, dp "
            f"{dp} x sp {sp}")
    paths, resamples = {}, []
    zero_counts()
    with recorded_launches(resamples=resamples):
        outs = sc.run(data, blens)
    paths[f"5node_dp{dp}_sp{sp}"] = counts = read_counts()
    print(f"[{tag}] {what}: launches {counts} ({card})")
    check(counts["polyphase_resample"] == len(data) * dp * sp,
          f"{tag}: {what}: {counts['polyphase_resample']} resampler launches,"
          f" want {len(data)} inputs x {dp * sp} shards")
    kernels["resample_err"] = max(kernels["resample_err"], check_resamples(
        tag, resamples, counts["polyphase_resample"], card))
    del resamples
    singles = [single({k: (v[b], blens[k][b]) for k, v in data.items()})[0]
               for b in range(MESH_CLIPS)]
    [key] = [k for k in singles[0] if k.startswith("spectrum_")]
    check_clips(tag, what, {"master": outs["master"]},
                [{"master": s["master"]} for s in singles], card)
    kernels.setdefault("spectrum_bitwise", []).append(mesh_spectrum_check(
        tag, what, outs[key], torch.stack([s[key] for s in singles]), card))
    del outs
    times = mesh_render_times(
        tag, what, lambda: sc.run(data, blens),
        lambda: [single({k: (v[b], blens[k][b]) for k, v in data.items()})
                 for b in range(MESH_CLIPS)],
        f"{MESH_CLIPS} single renders", 2, card)
    kernels.setdefault("times", {})[f"5node_dp{dp}_sp{sp}"] = times
    if dp_mesh is None:
        return paths

    # (e) run_batch(mesh=) against run_batch.
    ddp = dp_mesh.shape["dp"]
    zero_counts()
    plain, _ = single.run_batch(data, blens)
    one_batch = read_counts()
    zero_counts()
    meshed, _ = single.run_batch(data, blens, mesh=dp_mesh, dp_axis="dp")
    paths[f"5node_run_batch_dp{ddp}"] = counts = read_counts()
    same = all(torch.equal(plain[k][0] if isinstance(plain[k], tuple)
                           else plain[k],
                           meshed[k][0] if isinstance(meshed[k], tuple)
                           else meshed[k]) for k in plain)
    same &= plain["master"][1] == meshed["master"][1]
    print(f"[{tag}] run_batch(mesh=dp {ddp}) on the {what.split(',')[0]}'s "
          f"{MESH_CLIPS} clips: master, lengths and spectrum "
          f"{'bitwise' if same else 'NOT bitwise'} run_batch's; launches "
          f"{counts}, run_batch's {one_batch} ({card})")
    check(same, f"{tag}: run_batch(mesh=) differs from run_batch")
    check(counts["polyphase_resample"]
          == ddp * one_batch["polyphase_resample"],
          f"{tag}: run_batch(mesh=) launched {counts}, want {ddp} x "
          f"{one_batch}")
    del plain, meshed
    times = mesh_render_times(
        tag, f"run_batch(mesh=dp {ddp})",
        lambda: single.run_batch(data, blens, mesh=dp_mesh, dp_axis="dp"),
        lambda: single.run_batch(data, blens), "run_batch without a mesh", 3,
        card)
    kernels["times"][f"5node_run_batch_dp{ddp}"] = times
    return paths


def mesh_dp_chain_checks(tag: str, what: str, chains, single_chains,
                         dp: int, card: str) -> float:
    """Every WSOLA chain launch of a dp render (each of the ``dp`` shards'
    clips in one launch a stage) clip by clip against the plain scoring and
    assembly (check_chain), its splices equal to the clip's single render's
    (``single_chains``: the single renders' launches, clip by clip), and its
    first block's energy prologue against the plain version. Returns the
    worst max|body - plain|."""
    import torch

    from nodey_tpu_torch.ops import cuda_wsola, wsola

    n_stages = len(chains) // dp
    share = len(single_chains) // n_stages // dp
    worst = energy_rel = 0.0
    for launch, (x, head, args, (bs, body)) in enumerate(chains):
        d, stage = divmod(launch, n_stages)
        geo = dict(zip(("K", "num", "den", "seq", "seek", "overlap"), args))
        for j in range(x.shape[0]):
            clip = d * share + j
            _, _, err = check_chain(f"{what}, shard {d} stage {stage} clip "
                                    f"{clip}", x[j], head[j], geo, card,
                                    out=(bs[j], body[j]), phase=tag)
            worst = max(worst, err)
            check(torch.equal(single_chains[n_stages * clip + stage][3][0],
                              bs[j]),
                  f"{tag}: {what}: clip {clip} stage {stage}: splices differ "
                  f"from its single render's")
        first = min(geo["K"], cuda_wsola.BLOCK_FRAMES)
        got = cuda_wsola.wsola_energy_cuda(x, 0, 0, first, *args[1:])
        want = wsola.wsola_energy_plain(x, 0, 0, first, *args[1:])
        energy_rel = max(energy_rel, ((got - want).abs() / want).max().item())
    print(f"[{tag}] {what}: {len(chains)} chain launches, each clip's "
          f"splices equal to its single render's; energy prologue, first "
          f"block of each launch: max|kernel - plain| / plain = "
          f"{energy_rel:.3e} (tol {ENERGY_REL:.0e}) ({card})")
    check(energy_rel <= ENERGY_REL, f"{tag}: {what}: the prologue disagrees")
    return worst


def mesh_dp_cases(tag: str, card: str, dev, tmp: str, kernels: dict) -> dict:
    """Phase 34 (c): compile_graph_dp of the dry run's chain on WSOLA, on
    the PV and on the PV with its options, dp MESH_DP_WIDE, MESH_CLIPS
    clips of MESH_CLIP_SECONDS s. Returns the launch counts by path."""
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import write_wav_s16
    from nodey_tpu_torch.parallel import sharded
    from nodey_tpu_torch.parallel.mesh import make_mesh

    n = RATE * MESH_CLIP_SECONDS
    signals = [bench_tone(n, RATE, 200.0 + 25.0 * b, 2, 80 + b)
               for b in range(MESH_CLIPS)]
    track = os.path.join(tmp, "mesh_chain.wav")
    write_wav_s16(track, signals[0], RATE)
    dp = MESH_DP_WIDE
    mesh = make_mesh({"dp": dp}, [dev] * dp)
    lens = [n - 7_919 * b for b in range(MESH_CLIPS)]
    paths = {}
    for name, algo, options in (("wsola", "wsola", False), ("pv", "pv", False),
                                ("pv_options", "pv", True)):
        g = dryrun_chain_graph(track, algo, options)
        runner = Runner(g, device=CARD)
        arrays, _, sources = runner.decode()
        [key] = arrays
        clips = s16_clips([s[:, :m] for s, m in zip(signals, lens)],
                          arrays[key].shape[1])
        bargs, blens, singles_args = batch_and_singles(key, clips, lens, dev)
        dpg = sharded.compile_graph_dp(g, sources, mesh)
        resamples, chains, phase_paths, locks = [], [], [], []
        zero_counts()
        with recorded_launches(resamples=resamples, chains=chains,
                               phase_paths=phase_paths, locks=locks):
            outs = dpg.run(bargs, blens)
        paths[f"dryrun_chain_dp{dp}_{name}"] = counts = read_counts()
        single_chains, singles = [], []
        for b, args in enumerate(singles_args):
            zero_counts()
            with recorded_launches(chains=single_chains):
                singles.append(dpg.compiled(args)[0])
            if b == 0:
                one = read_counts()
        what = (f"dry-run chain on {name}, {MESH_CLIPS} clips of "
                f"{MESH_CLIP_SECONDS} s, dp {dp}")
        print(f"[{tag}] {what}: launches {counts}; one clip's render "
              f"{one} ({card})")
        check(counts == {k: dp * v for k, v in one.items()},
              f"{tag}: {what}: the dp render launched {counts}, want {dp} x "
              f"one clip's {one}")
        want_kernels = {"wsola": ("wsola_chain", "wsola_energy"),
                        "pv": ("pv_phase_path",),
                        "pv_options": ("pv_lock",)}[name]
        check(all(counts[k] > 0 for k in want_kernels),
              f"{tag}: {what}: no launch of {want_kernels}")
        check_clips(tag, what, outs, singles, card)
        del outs, singles
        kernels["resample_err"] = max(kernels["resample_err"], check_resamples(
            f"{tag} {name}", resamples, counts["polyphase_resample"], card))
        if algo == "wsola":
            kernels["wsola_err"] = mesh_dp_chain_checks(
                tag, what, chains, single_chains, dp, card)
        else:
            pv_figures = {}
            pv_batch_checks(tag, what, phase_paths, locks, counts,
                            pv_figures, card)
            kernels["lock_err"] = max(kernels.get("lock_err", 0.0),
                                      pv_figures[f"{what}_lock_err"])
        del resamples, chains, single_chains, phase_paths, locks
        times = mesh_render_times(
            tag, what, lambda: dpg.run(bargs, blens),
            lambda: [dpg.compiled(a) for a in singles_args],
            f"{MESH_CLIPS} single renders", 1, card)
        kernels.setdefault("times", {})[f"dryrun_chain_dp{dp}_{name}"] = times
        del bargs, singles_args, dpg, runner
    return paths


def _tv_chain_run(tag: str, card: str, dev, seconds: float, kernels: dict,
                  record: bool):
    """The dry run's chain on the PV over ``seconds`` of bench.py's tone:
    (launch counts, the sharded output and length, the single render and
    length, the single render with the plain phase path in place of the
    kernel, the sharded and single render functions). With ``record``,
    every lock and resampler launch of the sharded render is held against
    its plain version."""
    import torch

    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.ops import pv
    from nodey_tpu_torch.parallel import tv_sharded
    from nodey_tpu_torch.parallel.mesh import make_mesh

    n = int(RATE * seconds)
    x = torch.from_numpy(bench_tone(n, RATE, 233.0, 2, 90)).to(dev)
    g = dryrun_chain_graph("mesh_tv.wav", "pv")
    [src] = [nid for nid, node in g.nodes.items()
             if node.processor.info().identifier == "audio_input"]
    sources = {(src, "output_0"): compiler.SourceSpec(
        rate=RATE, channels=2, fmt="flt", capacity=n)}
    key = compiler.external_key(src, "output_0")
    sp = MESH_SP_TV
    chain = tv_sharded.compile_chain_sp_tv(
        g, sources, make_mesh({"sp": sp}, [dev] * sp))
    single = compiler.compile_graph(g, sources, device=dev)
    resamples, locks = [], []
    zero_counts()
    with contextlib.ExitStack() as stack:
        if record:
            stack.enter_context(recorded_launches(resamples=resamples,
                                                  locks=locks))
        out, out_len = chain.run(x, n)
    counts = read_counts()
    stages = [type(s).__name__ for s in chain.plan.stages]
    n_pv, n_rs = stages.count("_PvStage"), stages.count("_ResampleStage")
    what = (f"dry-run chain on the PV, one {seconds:g} s clip, sp {sp}")
    print(f"[{tag}] {what} (stages {stages}): capacity "
          f"{chain.plan.capacity}, chunk in {chain.plan.chunk_in} out "
          f"{chain.plan.chunk_out}; launches {counts} ({card})")
    check(counts["pv_lock"] == n_pv * sp and counts["pv_phase_path"] == 0
          and counts["polyphase_resample"] == n_rs * sp,
          f"{tag}: {what}: launches {counts}, want {n_pv * sp} locks, "
          f"{n_rs * sp} resampler launches and no phase path")
    if record:
        kernels["resample_err"] = max(kernels["resample_err"],
                                      check_resamples(
                                          tag, resamples,
                                          counts["polyphase_resample"], card))
        lock_err = 0.0
        for lock_in, got in locks:
            err, differ, finite = lock_against_plain(got, lock_in)
            check(err <= TOL and (differ == 0 or not finite),
                  f"{tag}: a shard's lock launch disagrees with the plain "
                  f"lock")
            lock_err = max(lock_err, err)
        print(f"[{tag}] {what}: {len(locks)} lock launches at shard shapes "
              f"{sorted({tuple(li[3].shape) for li, _ in locks})}: "
              f"max|kernel - plain| = {lock_err:.3e} (tol {TOL:.0e}), "
              f"bitwise on finite inputs ({card})")
        kernels["lock_err"] = max(kernels.get("lock_err", 0.0), lock_err)
    del resamples, locks
    ref, ref_len = single({key: (x, n)})[0]["master"]
    saved = pv.phase_path
    pv.phase_path = (lambda re, im, dpos, hop, n_fft, lock=True:
                     pv.phase_path_plain(re, im, dpos, hop, n_fft, lock))
    try:
        plain_ref, _ = single({key: (x, n)})[0]["master"]
    finally:
        pv.phase_path = saved
    return (counts, what, out, out_len, ref, ref_len, plain_ref,
            lambda: chain.run(x, n), lambda: single({key: (x, n)}))


def mesh_tv_case(tag: str, card: str, dev, kernels: dict) -> dict:
    """Phase 34 (d): compile_chain_sp_tv of the dry run's chain on the PV,
    sp MESH_SP_TV on a virtual mesh. On MESH_TV_SECONDS s (the shape of
    tests/test_tv_sharded.py's bar for two PV stages) the sharded render
    against the single render at MESH_TV_DB; on one SECONDS s clip the
    same, every lock and resampler launch against its plain version, the
    SNR held at PV_DEVICE_DB and within MESH_TV_OWN_DB of the single
    render's own float32 determinism (the single render with the plain
    phase path against it).
    Returns the launch counts by path."""

    def agreement(what, out, out_len, ref, ref_len, plain_ref):
        m = min(ref_len, ref.shape[1], out.shape[1])
        db = snr_db(ref[:, :m].cpu().numpy(), out[:, :m].cpu().numpy())
        own = snr_db(ref[:, :m].cpu().numpy(), plain_ref[:, :m].cpu().numpy())
        tail_zero = not bool(out[:, out_len:].any())
        check(out_len == ref_len and tail_zero,
              f"{tag}: {what}: length {out_len} (single {ref_len}), tail "
              f"zero {tail_zero}")
        return db, own

    paths = {}
    counts, what, out, out_len, ref, ref_len, plain_ref, _, _ = (
        _tv_chain_run(tag, card, dev, MESH_TV_SECONDS, kernels, False))
    db, own = agreement(what, out, out_len, ref, ref_len, plain_ref)
    print(f"[{tag}] {what}: length {out_len} (single {ref_len}), {db:.1f} dB "
          f"against the single render (min {MESH_TV_DB:.0f}: two PV stages "
          f"in series, tests/test_tv_sharded.py:267, at its 0.8 s); the "
          f"single render with the plain phase path {own:.1f} dB against it "
          f"({card})")
    check(db > MESH_TV_DB, f"{tag}: {what}: below {MESH_TV_DB} dB")
    paths[f"dryrun_chain_sp{MESH_SP_TV}_pv_short"] = counts
    kernels["tv_db_short"] = db

    counts, what, out, out_len, ref, ref_len, plain_ref, run_sp, run_one = (
        _tv_chain_run(tag, card, dev, SECONDS, kernels, True))
    db, own = agreement(what, out, out_len, ref, ref_len, plain_ref)
    print(f"[{tag}] {what}: length {out_len} (single {ref_len}), {db:.1f} dB "
          f"against the single render (min {PV_DEVICE_DB:.0f}, the PV's own "
          f"conditioning, as card vs CPU, and at most {MESH_TV_OWN_DB:g} dB "
          f"below the single render's own; "
          f"{'above' if db > MESH_TV_DB else 'BELOW'}"
          f" the {MESH_TV_DB:.0f} dB of the 0.8 s shape); the single render "
          f"with the plain phase path {own:.1f} dB against it: the second PV "
          f"stage turns the first stage's float32 roundings into whole-bin "
          f"phase steps, more of them the longer the clip ({card})")
    check(db > PV_DEVICE_DB and db >= own - MESH_TV_OWN_DB,
          f"{tag}: {what}: below {PV_DEVICE_DB} dB, or more than "
          f"{MESH_TV_OWN_DB} dB below the single render's own determinism")
    kernels["tv_db"] = db
    kernels["tv_own_db"] = own
    del out, ref, plain_ref
    times = mesh_render_times(tag, what, run_sp, run_one,
                              "the single render", 1, card)
    kernels.setdefault("times", {})[f"dryrun_chain_sp{MESH_SP_TV}_pv"] = times
    paths[f"dryrun_chain_sp{MESH_SP_TV}_pv"] = counts
    return paths


def mesh_phase(card: str, dev, tmp: str, paths_5node):
    """Phase 34 (see the module docstring): the mesh. Returns (the launch
    counts by path, the figures: errors against the plain versions, the
    PV chain's SNR, the render times)."""
    import torch

    from nodey_tpu_torch.parallel.mesh import make_mesh

    tag = "34 mesh"
    t0 = time.perf_counter()
    paths, kernels = {}, {}
    virtual = make_mesh({"sp": MESH_SP}, [dev] * MESH_SP)
    paths[f"5node_sp{MESH_SP}"] = mesh_sp_case(tag, card, virtual,
                                               paths_5node, kernels)
    dp_sp = make_mesh({"dp": MESH_DP, "sp": MESH_SP},
                      [dev] * (MESH_DP * MESH_SP))
    paths.update(mesh_dp_sp_case(tag, card, dp_sp, tmp, kernels,
                                 dp_mesh=make_mesh({"dp": MESH_DP_WIDE},
                                                   [dev] * MESH_DP_WIDE)))
    paths.update(mesh_dp_cases(tag, card, dev, tmp, kernels))
    paths.update(mesh_tv_case(tag, card, dev, kernels))
    count = torch.cuda.device_count()
    if count > 1:
        real = make_mesh({"sp": -1})
        paths["5node_sp_devices"] = mesh_sp_case(tag, card, real,
                                                 paths_5node, kernels)
        if count % 2 == 0:
            paths.update({f"{k}_devices": v for k, v in mesh_dp_sp_case(
                tag, card, make_mesh({"dp": 2, "sp": -1}), tmp,
                kernels).items()})
    else:
        print(f"[{tag}] torch.cuda.device_count() = {count}: only the "
              f"virtual mesh ran (every shard on {dev}); (a) and (b) over "
              f"real devices need more than one card ({card})")
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[34 figures] {json.dumps(kernels)}")
    return paths, kernels


def float64_conv(x, ir, out_len: int):
    """The linear convolution of ``x`` [.., C, N] with ``ir`` [C, L] in
    float64 (FFTs on x's device), the first ``out_len`` samples."""
    import torch

    n = 1 << (out_len - 1).bit_length()
    spec = torch.fft.rfft(x.double(), n) * torch.fft.rfft(
        ir.to(x.device).double(), n)
    return torch.fft.irfft(spec, n)[..., :out_len]


def against_float64(tag: str, what: str, exact, got, base) -> dict:
    """``got``'s SNR and max|error| over the peak against the float64
    ``exact``, held at TP_SLACK_DB and TP_MAXABS_FACTOR of ``base`` (the
    unsharded render's own figures)."""
    exact = exact.double()
    err = (got.double() - exact)
    db = 10 * math.log10(exact.square().sum().item()
                         / max(err.square().sum().item(), 1e-300))
    rel = (err.abs().max() / exact.abs().max()).item()
    if base is not None:
        check(db >= base["db"] - TP_SLACK_DB
              and rel <= TP_MAXABS_FACTOR * base["rel"],
              f"{tag}: {what}: {db:.1f} dB and max|error| / peak {rel:.3e} "
              f"against float64, the unsharded render's {base['db']:.1f} dB "
              f"and {base['rel']:.3e}")
    return {"db": db, "rel": rel}


def tp_conv_case(tag: str, card: str, dev, kernels: dict) -> None:
    """Phase 35 (a): the reverb convolution of config 7 (decay 1.8 s,
    pre-delay 20 ms, damping 0.5) on SECONDS s of 48 kHz stereo, sharded
    over tp at each of TP_SIZES on a virtual mesh of the card, and the
    card's unsharded partitioned_conv, each against the float64
    convolution (TP_SLACK_DB); each timed beside the unsharded conv."""
    import torch

    from nodey_tpu_torch.ops import reverb
    from nodey_tpu_torch.parallel import tp
    from nodey_tpu_torch.parallel.mesh import make_mesh

    n = MASTER_RATE * SECONDS
    x = torch.from_numpy(bench_tone(n, MASTER_RATE, 220.0, 2, 35)).to(dev)
    ir = torch.from_numpy(reverb.design_ir(MASTER_RATE, 2, 1.8, 20.0, 0.5))
    hr, hi = reverb.partitions(MASTER_RATE, 2, 1.8, 20.0, 0.5, dev)
    out_len = n + ir.shape[1] - 1
    k = hr.shape[1]
    t = -(-out_len // reverb.PARTITION)
    exact = float64_conv(x, ir, out_len)
    want = reverb.partitioned_conv(x, hr, hi, out_len)
    what = (f"config 7's reverb convolution, {SECONDS} s of 48 kHz stereo "
            f"(F {reverb._F}, {reverb._BINS} bins, K {k}, T {t})")
    base = against_float64(tag, what, exact, want, None)
    print(f"[{tag}] {what}, unsharded: {base['db']:.1f} dB against the "
          f"float64 convolution, max|error| / peak {base['rel']:.3e} "
          f"({card})")
    kernels["tp_float64"] = {"unsharded": base}
    single_fn = lambda: reverb.partitioned_conv(x, hr, hi, out_len)  # noqa: E731
    for size in TP_SIZES:
        mesh = make_mesh({"tp": size}, [dev] * size)
        zero_counts()
        got = tp.partitioned_conv_tp(x, hr, hi, out_len, mesh)
        counts = read_counts()
        check(not any(counts.values()),
              f"{tag}: the tp conv launched {counts}: no kernel of ours lies "
              f"on it")
        figures = against_float64(tag, f"{what}, tp {size}", exact, got, base)
        db = plane_snr_db(want, got)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"[{tag}] {what} at tp {size} (bins padded to "
              f"{tp._padded_bins(size)}): {figures['db']:.1f} dB against the "
              f"float64 convolution (min {base['db'] - TP_SLACK_DB:.1f}: the "
              f"unsharded conv's less {TP_SLACK_DB:g}), max|error| / peak "
              f"{figures['rel']:.3e} (max {TP_MAXABS_FACTOR:g} x the "
              f"unsharded conv's); {db:.1f} dB and {rel:.3e} against the "
              f"unsharded conv (tests/test_tp.py's 130 dB and 1e-6 cannot "
              f"hold where the unsharded conv is {base['db']:.1f} dB from "
              f"float64); the delay line's in-place launches "
              f"{4 * min(k, t) * size} (4 K a shard; unsharded "
              f"{4 * min(k, t)}) ({card})")
        kernels["tp_float64"][str(size)] = {**figures, "vs_unsharded_db": db,
                                            "vs_unsharded_rel": rel}
        del got
        times = mesh_render_times(
            tag, f"{what}, tp {size}",
            lambda: tp.partitioned_conv_tp(x, hr, hi, out_len, mesh),
            single_fn, "the unsharded conv", TP_ITERS, card)
        kernels.setdefault("times", {})[f"reverb_conv_tp{size}"] = times
    print(f"[{tag}] config 7's whole single render took 54.7686 ms in an "
          f"earlier run of this script on an H100 at 700 W (PERF.md section "
          f"5), the unsharded conv most of it ({card})")


def dp_sp_tp_case(tag: str, card: str, dev, tmp: str, kernels: dict) -> dict:
    """Phase 35 (b): compile_flagship_reverb_dpsptp of the 5-node graph on
    dp MESH_DP x sp MESH_DP x tp MESH_DP (a virtual mesh of the card) over
    MESH_CLIPS clips of MESH_CLIP_SECONDS s, each clip and the card's
    reference_pipeline against the same pipeline in float64 after the
    single render (TP_SLACK_DB); every resampler launch against plain.
    Returns the launch counts by path."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import write_wav_s16
    from nodey_tpu_torch.ops import reverb
    from nodey_tpu_torch.ops.scans import mask_tail
    from nodey_tpu_torch.parallel import dp_sp_tp, sharded
    from nodey_tpu_torch.parallel.mesh import make_mesh

    n = RATE * MESH_CLIP_SECONDS
    tracks = []
    for i in range(2):
        path = os.path.join(tmp, f"dst_5node_{i}.wav")
        write_wav_s16(path, bench_tone(n, RATE, 220.0 * (i + 1), 2, 100 + i),
                      RATE)
        tracks.append(path)
    g = flagship_graph(tracks)
    _, _, sources = Runner(g, device=CARD).decode()
    axes = {"dp": MESH_DP, "sp": MESH_DP, "tp": MESH_DP}
    mesh = make_mesh(axes, [dev] * (MESH_DP ** 3))
    cap = sharded.plan_capacity_for(g, RATE, n, mesh)
    sources = {k: dataclasses.replace(s, capacity=cap)
               for k, s in sources.items()}
    prog = dp_sp_tp.compile_flagship_reverb_dpsptp(g, sources, mesh)
    home = mesh.devices.flat[0]
    lens = [n - 8_887 * b for b in range(MESH_CLIPS)]
    data, blens = {}, {}
    for i, key in enumerate(sorted(compiler.external_key(*k)
                                   for k in sources)):
        signals = [bench_tone(n, RATE, 220.0 * (i + 1) + 15.0 * b, 2,
                              110 + 10 * i + b)[:, :m]
                   for b, m in enumerate(lens)]
        data[key] = torch.from_numpy(s16_clips(signals, cap)).to(home)
        blens[key] = tuple(lens)
    what = (f"5-node graph -> reverb tail (decay 0.25 s), {MESH_CLIPS} clips "
            f"of {MESH_CLIP_SECONDS} s, dp {MESH_DP} x sp {MESH_DP} x tp "
            f"{MESH_DP}")
    resamples = []
    zero_counts()
    with recorded_launches(resamples=resamples):
        out, glen = prog.run(data, blens)
    counts = read_counts()
    print(f"[{tag}] {what}: master capacity {prog.cap_master}, out "
          f"{prog.cap_out} (IR {prog.ir_len}, K {prog.hr.shape[1]}); launches "
          f"{counts} "
          f"({card})")
    check(counts["polyphase_resample"] == len(data) * MESH_DP * MESH_DP,
          f"{tag}: {what}: {counts['polyphase_resample']} resampler launches, "
          f"want {len(data)} inputs x {MESH_DP * MESH_DP} dp x sp shards")
    kernels["resample_err"] = max(kernels.get("resample_err", 0.0),
                                  check_resamples(
                                      tag, resamples,
                                      counts["polyphase_resample"], card))
    del resamples

    single = compiler.compile_graph(g, sources, device=home)
    ir = torch.from_numpy(reverb.design_ir(prog.out_rate, 2, 0.25, 4.0, 0.3))

    def reference(b):
        return dp_sp_tp.reference_pipeline(
            g, sources, {k: v[b] for k, v in data.items()},
            {k: v[b] for k, v in blens.items()}, prog.cap_master,
            prog.cap_out, prog.out_rate, device=home)

    worst = {"db": math.inf, "rel": 0.0, "ref_db": math.inf}
    for b in range(MESH_CLIPS):
        ref, ref_len = reference(b)
        check(glen[b] == ref_len,
              f"{tag}: {what}: clip {b}: length {glen[b]}, the reference's "
              f"{ref_len}")
        # The same pipeline in float64 after the single render's master.
        master, mlen = single({k: (v[b], blens[k][b])
                               for k, v in data.items()})[0]["master"]
        master = mask_tail(master[:, :prog.cap_master], mlen).double()
        exact = (prog.dry * F.pad(master, (0, prog.cap_out - prog.cap_master))
                 + prog.wet * float64_conv(master, ir, prog.cap_out))
        base = against_float64(tag, f"{what}: clip {b}: reference", exact,
                               ref, None)
        figures = against_float64(tag, f"{what}: clip {b}", exact, out[b],
                                  base)
        worst = {"db": min(worst["db"], figures["db"]),
                 "rel": max(worst["rel"], figures["rel"]),
                 "ref_db": min(worst["ref_db"], base["db"]),
                 "vs_reference_db": min(worst.get("vs_reference_db",
                                                  math.inf),
                                        plane_snr_db(ref, out[b]))}
    print(f"[{tag}] {what}: every clip's length the reference's; against "
          f"the float64 pipeline the worst clip {worst['db']:.1f} dB, max|"
          f"error| / peak {worst['rel']:.3e} (the reference_pipeline's worst "
          f"{worst['ref_db']:.1f} dB; each clip at most {TP_SLACK_DB:g} dB "
          f"below its reference's and within {TP_MAXABS_FACTOR:g} x its "
          f"max|error|); against the reference_pipeline the worst clip "
          f"{worst['vs_reference_db']:.1f} dB ({card})")
    kernels["dp_sp_tp_float64"] = worst
    del out
    times = mesh_render_times(
        tag, what, lambda: prog.run(data, blens),
        lambda: [reference(b) for b in range(MESH_CLIPS)],
        f"{MESH_CLIPS} reference pipelines (single render + unsharded conv)",
        2, card)
    kernels.setdefault("times", {})["5node_reverb_dp_sp_tp"] = times
    return {f"5node_reverb_dp{MESH_DP}_sp{MESH_DP}_tp{MESH_DP}": counts}


def tp_phase(card: str, dev, tmp: str):
    """Phase 35 (see the module docstring): tp and dp x sp x tp. Returns
    (the launch counts by path, the figures)."""
    tag = "35 tp"
    t0 = time.perf_counter()
    kernels = {}
    tp_conv_case(tag, card, dev, kernels)
    paths = dp_sp_tp_case(tag, card, dev, tmp, kernels)
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[35 figures] {json.dumps(kernels)}")
    return paths, kernels


def dcn_phase(cli, card: str, dev, tmp: str, excerpt_tracks):
    """Phase 36 (see the module docstring): the gloo mesh across processes,
    compat="swr" and MP3 where the codec runtime does not load. Returns
    (the launch counts by path, the figures)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core.errors import ProcessorRuntimeError
    from nodey_tpu_torch.host import encode
    from nodey_tpu_torch.host.decode import load_native
    from nodey_tpu_torch.ops import resample as tr
    from nodey_tpu_torch.parallel import dcn, sharded
    from nodey_tpu_torch.parallel.mesh import make_mesh

    tag = "36 dcn"
    t0 = time.perf_counter()
    paths, figures = {}, {}
    shards = DCN_PROCESSES * DCN_LOCAL
    # The same windows in this process, every launch against plain.
    g, src = dcn._dryrun_graph()
    mesh = make_mesh({"sp": shards}, [dev] * shards)
    sources, arrays, lengths = dcn._dryrun_inputs(g, src, mesh)
    sc = sharded.compile_graph_sharded(g, sources, mesh)
    resamples = []
    zero_counts()
    with recorded_launches(resamples=resamples):
        sc.run(arrays, lengths)
    counts = read_counts()
    paths["dcn_graph_one_process"] = counts
    figures["resample_err"] = check_resamples(
        tag, resamples, counts["polyphase_resample"], card)
    del resamples

    wall = time.perf_counter()
    reports = dcn.launch_dcn_dryrun(DCN_PROCESSES, DCN_LOCAL,
                                    timeout=DCN_TIMEOUT, device=CARD)
    wall = time.perf_counter() - wall
    check(len(reports) == DCN_PROCESSES,
          f"{tag}: {len(reports)} reports from {DCN_PROCESSES} processes")
    for r in reports:
        exact = r["bitwise_single"] and r["bitwise_sp"]
        print(f"[{tag}] process {r['rank']} of {DCN_PROCESSES} (gloo), shards "
              f"{r['shards']} of {shards} on {r['device']}: length "
              f"{r['length']}, {'bitwise' if exact else 'NOT bitwise'} the "
              f"single render and the one-process sp render (max|diff| "
              f"{r['max_abs_single']:.3e} / {r['max_abs_sp']:.3e}); sent "
              f"{r['bytes_sent']} bytes of halos through the host a step; "
              f"first step {r['seconds'] * 1e3:.2f} ms wall (cold), a second "
              f"{r['warm_seconds'] * 1e3:.2f} ms; launches in the first "
              f"{r['launches']} ({card})")
        check(exact, f"{tag}: process {r['rank']}'s shards are not bitwise "
              f"the single render and the one-process sp render")
        check(set(r["launches"]) == set(counts),
              f"{tag}: process {r['rank']} counted {sorted(r['launches'])}")
        check(r["launches"]["polyphase_resample"] == 2 * DCN_LOCAL,
              f"{tag}: process {r['rank']} launched the resampler "
              f"{r['launches']['polyphase_resample']} times, want 2 inputs "
              f"x {DCN_LOCAL}")
        paths[f"dcn_rank{r['rank']}"] = r["launches"]
    print(f"[{tag}] launch_dcn_dryrun({DCN_PROCESSES}, {DCN_LOCAL}, device="
          f"{CARD!r}): {wall:.2f} s wall, the processes' start and import "
          f"included ({card})")
    figures["dcn"] = {"wall_s": wall, "reports": reports}

    # compat="swr" and MP3 need the codec runtime; where it does not load
    # they refuse, with nothing rendered in their place.
    x = torch.from_numpy(bench_tone(2 * RATE, RATE, 440.0, 2, 36)).to(dev)
    runtime = load_native() is not None
    zero_counts()
    if runtime:
        from nodey_tpu_torch.host.resample_ref import swr_convert

        got = tr.resample_data(x, RATE, 48_000, compat="swr").cpu().numpy()
        want = swr_convert(x.cpu().numpy(), RATE, 48_000)
        m = min(got.shape[1], want.shape[1])
        db = snr_db(want[:, 200:m - 200], got[:, 200:m - 200])
        print(f"[{tag}] compat='swr' 44.1 -> 48 kHz on the card: {db:.1f} dB "
              f"against swr_convert (min {SWR_DB:.0f}) ({card})")
        check(db >= SWR_DB, f"{tag}: the compat resample is below {SWR_DB} dB")
    else:
        try:
            tr.resample_data(x, RATE, 48_000, compat="swr")
        except ProcessorRuntimeError as exc:
            print(f"[{tag}] compat='swr': the codec runtime does not load on "
                  f"this machine; the resample raised ProcessorRuntimeError "
                  f"({exc.message}) and launched "
                  f"{sum(read_counts().values())} kernels ({card})")
        else:
            fail(f"{tag}: compat='swr' rendered without the codec runtime")
        check(not any(read_counts().values()),
              f"{tag}: the refused compat resample launched a kernel")
        project = write_project(flagship_graph(excerpt_tracks),
                                os.path.join(tmp, "swr_compat.json"))
        saved = os.environ.get("NODEY_RESAMPLE_COMPAT")
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                rc = cli.main(["run", project, "--export",
                               os.path.join(tmp, "swr_compat.wav"),
                               "--device", CARD, "--swr-compat"])
        finally:
            if saved is None:
                os.environ.pop("NODEY_RESAMPLE_COMPAT", None)
            else:
                os.environ["NODEY_RESAMPLE_COMPAT"] = saved
        print(f"[{tag}] run --swr-compat --device {CARD}: exit {rc}, "
              f"{err.getvalue().strip().splitlines()[0] if err.getvalue() else ''}"
              f" ({card})")
        check(rc != 0,
              f"{tag}: run --swr-compat succeeded without the codec runtime")
        try:
            with encode.open_sink(os.path.join(tmp, "refused.mp3"), 48_000,
                                  2, 192) as sink:
                sink.write(np.zeros((2, 48_000), np.float32))
        except ProcessorRuntimeError as exc:
            print(f"[{tag}] MP3 has no card path: the codec runtime (LAME) "
                  f"does not load on this machine, and an MP3 export through "
                  f"open_sink raises ({exc.message}); no fallback ran "
                  f"({card})")
        else:
            fail(f"{tag}: an MP3 export ran without the codec runtime")
        try:
            encode.encode_mp3(os.path.join(tmp, "refused_one.mp3"),
                              np.zeros((2, 48_000), np.float32), 48_000, 192)
        except ProcessorRuntimeError as exc:
            print(f"[{tag}] encode_mp3 raises too ({exc.message}) ({card})")
        else:
            fail(f"{tag}: encode_mp3 ran without the codec runtime")
    figures["codec_runtime"] = runtime
    print(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} ({card})")
    print(f"[36 figures] {json.dumps(figures)}")
    return paths, figures


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
        from nodey_tpu_torch.app import cli
        from nodey_tpu_torch.core import chunkflow
        from nodey_tpu_torch.core.compiler import SourceSpec
        from nodey_tpu_torch.core.runner import Runner
        from nodey_tpu_torch.core.stream import Stream
        from nodey_tpu_torch.host.decode import decode_file
        from nodey_tpu_torch.ops import _build, cuda_pv, cuda_resample, cuda_wsola
        from nodey_tpu_torch.ops import pv, stretch, wsola
        from nodey_tpu_torch.ops import resample as tr
    except ImportError as exc:
        fail(f"the nodey_tpu_torch package is not beside this script ({exc})")
    import numpy as np
    import torch
    import torch.nn.functional as F

    # -- 1. device -------------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device(CARD)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {card}")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(clocks.returncode == 0, f"nvidia-smi failed: {clocks.stderr.strip()}")
    sm_clock_mhz = float(clocks.stdout.strip().splitlines()[0])
    print(f"[1 device] max SM clock {sm_clock_mhz:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2 build] {len(_build.kernel_names())} libraries ready in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)"
          f" ({card})")
    for name in _build.kernel_names():
        _build.load_library(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name}: ptxas: {line.strip()}")

    # -- 3. kernel against its plain version -----------------------------------
    rng = np.random.default_rng(1)
    resample_err = {}
    for in_rate, out_rate, n in KERNEL_PAIRS:
        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, n))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank, support = tr.bank_operands(data, in_rate, out_rate)
        got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        err = (got - want).abs().max().item()
        print(f"[3 kernel] {in_rate}->{out_rate} Hz, bank {list(bank.shape)}, "
              f"support {list(support.compact.shape)}, rows of "
              f"{support.row_used}, x {list(x.shape)}, G={G}, group tile "
              f"ragged={G % 128 != 0}: max|kernel - plain| = {err:.3e} (tol "
              f"{TOL:.0e}); plain version's peak {peak:.1f} MiB above its "
              f"inputs ({card})")
        check(err <= TOL, f"kernel disagrees with plain at {in_rate}->{out_rate}")
        resample_err[(in_rate, out_rate)] = err
        del data, x, got, want
    kernel_err = max(resample_err[p[:2]] for p in KERNEL_PAIRS[:2])

    with tempfile.TemporaryDirectory(prefix="nodey_chip_smoke_") as tmp:
        # -- 4. slice ----------------------------------------------------------
        signals = make_signals(SECONDS)
        n = signals[0].shape[1]
        paths = write_tracks(tmp, signals, f"{SECONDS}s")
        with open(os.path.join(ROOT, "examples/projects/two_track_mix.json")) as f:
            project = json.load(f)
        project["nodes"]["0"]["info"]["file_path"] = paths
        proj = os.path.join(tmp, "two_track_mix.json")
        with open(proj, "w") as f:
            json.dump(project, f)
        out_wav = os.path.join(tmp, "master.wav")
        proj_5node, wav_5node, paths_5node = proj, out_wav, paths

        zero_counts()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", CARD])
        counts_5node = read_counts()
        launches_5node = counts_5node["polyphase_resample"]
        print("\n".join(f"[4 slice] cli: {line}"
                        for line in stdout.getvalue().splitlines()))
        check(rc == 0, f"cli run exited {rc}")
        master = decode_file(out_wav).data
        n_out = -(-n * 160 // 147)
        check(master.shape == (2, n_out),
              f"exported master {master.shape}, want (2, {n_out})")
        check(bool(np.isfinite(master).all()), "exported master not finite")
        cap_out = -(-MAIN_CAPACITY * 160 // 147)
        frames = (cap_out - 1024) // 512 + 1
        want_line = f"spectrum 'spectrum_4': shape [2, {frames}, 513]"
        check(want_line in stdout.getvalue(), f"missing '{want_line}'")
        print(f"[4 slice] {SECONDS} s export: master {list(master.shape)} finite, "
              f"spectrum [2, {frames}, 513], kernel launches {launches_5node} "
              f"({card})")
        check(launches_5node >= 2,
              f"resample kernel launched {launches_5node} times, want >= 2")

        excerpt = write_tracks(
            tmp, [s[:, : RATE * EXCERPT_SECONDS] for s in signals],
            f"{EXCERPT_SECONDS}s",
        )
        on_card = Runner(flagship_graph(excerpt), device=CARD).render("export")
        on_cpu = Runner(flagship_graph(excerpt), device="cpu").render("export")
        check(on_card.master.shape == on_cpu.master.shape,
              f"master {on_card.master.shape} vs {on_cpu.master.shape}")
        err = float(np.abs(on_card.master - on_cpu.master).max())
        [key] = on_card.spectra
        snr = snr_db(on_cpu.spectra[key], on_card.spectra[key])
        print(f"[4 slice] {EXCERPT_SECONDS} s excerpt, gain 1.5, amix 0.6/0.4: "
              f"max|card - cpu| master = {err:.3e} (tol {TOL:.0e}), "
              f"spectrum SNR {snr:.1f} dB (min {SNR_DB:.0f}) ({card})")
        check(err <= TOL, "card master disagrees with the CPU plain path")
        check(snr >= SNR_DB, "card spectrum disagrees with the CPU plain path")

        # -- 5. times ----------------------------------------------------------
        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, MAIN_CAPACITY))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank, support = tr.bank_operands(data, *KERNEL_PAIRS[0][:2])
        resample_bound = resample_work_bound(x, G, M, bank)
        fns = {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support),
            "plain": functools.partial(tr.apply_filter_bank_plain, x, G, M, W,
                                       bank),
        }
        resample_times = {"44.1->48": time_resampler(
            "5 times", f"44.1->48 kHz, one {SECONDS} s stereo track",
            fns, ("plain", "kernel", "kernel", "plain"), 10, card,
            resample_bound)}
        kernel_ms = resample_times["44.1->48"]["kernel"]
        plain_ms = resample_times["44.1->48"]["plain"]
        del data, x, fns

        device_rtf("5 times", "5-node graph", flagship_graph(paths), "export",
                   card, iters=10, warmup=2)
        del paths

        # -- 6. wsola ----------------------------------------------------------
        for rate, tempo in GOLDEN_CASES:
            sig = torch.from_numpy(golden_signal(rate)).to(dev)
            x, head, geo = wsola_operands(sig, tempo, rate)
            bs, body = cuda_wsola.wsola_chain_cuda(x, head, *chain_args(geo))
            pbs, pbody = wsola.wsola_chain_plain(x, head, *chain_args(geo))
            torch.cuda.synchronize()
            same = torch.equal(bs, pbs)
            err = (body - pbody).abs().max().item()
            print(f"[6 wsola] golden signal {rate} Hz, tempo {tempo}: K="
                  f"{geo['K']}, offsets {'bitwise equal' if same else 'DIFFER'}"
                  f", max|body - plain| = {err:.3e} ({card})")
            check(same, f"WSOLA offsets differ on the golden {rate}_{tempo}")
            check(err <= TOL, f"WSOLA audio differs on the golden {rate}_{tempo}")

        # Config 4's two chains at full width, on the main path's own data:
        # track 1 at 48 kHz, then the pitch stage's transposed output.
        track = torch.zeros((2, MAIN_CAPACITY), device=dev)
        track[:, :n] = torch.from_numpy(signals[0]).to(dev)
        track1 = signals[0]
        del signals
        s48 = tr.resample_stream(Stream(data=track, length=n, rate=RATE,
                                        channels=2), 48_000)
        del track
        pitch = 2.0 ** (PITCH / 12.0)
        x1, head1, geo1 = wsola_operands(s48.data, 1.0 / pitch, 48_000)
        bs1, body1, err1 = check_chain(
            f"pitch +{PITCH:g} stage, tempo {1.0 / pitch:.5f}", x1, head1, geo1,
            card)
        out1 = torch.cat([head1, body1], dim=1)
        len1 = min(stretch._scale_length_exact(s48.length, 1.0 / pitch),
                   out1.shape[1])
        out1[:, len1:] = 0.0
        s2, len2 = stretch.transpose_rate(out1, len1, pitch)
        del s48, out1
        x2, head2, geo2 = wsola_operands(s2, VELOCITY, 48_000)
        bs2, body2, err2 = check_chain(f"velocity {VELOCITY:g} stage, tempo "
                                 f"{VELOCITY:g}", x2, head2, geo2, card)
        check((geo1["K"], geo2["K"]) == CONFIG4_FRAMES,
              f"frames {(geo1['K'], geo2['K'])}, want {CONFIG4_FRAMES}")
        wsola_err = max(err1, err2)
        energy_err = [check_energy(f"{tag} stage", x, geo, card)
                      for tag, x, geo in (("pitch", x1, geo1),
                                          ("velocity", x2, geo2))]
        del s2

        # -- 7. config4 --------------------------------------------------------
        [track_path] = write_tracks(tmp, [make_signals(SECONDS, seed=4)[0]],
                                    f"{SECONDS}s_config4")
        proj = os.path.join(tmp, "config4.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path).serialize(), f)
        out_wav = os.path.join(tmp, "config4.wav")
        proj_c4, wav_c4 = proj, out_wav
        zero_counts()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", CARD])
        counts_config4 = read_counts()
        config4_resample = counts_config4["polyphase_resample"]
        config4_wsola = counts_config4["wsola_chain"]
        print("\n".join(f"[7 config4] cli: {line}"
                        for line in stdout.getvalue().splitlines()))
        check(rc == 0, f"cli run exited {rc}")
        master = decode_file(out_wav).data
        print(f"[7 config4] {SECONDS} s export: master {list(master.shape)}, "
              f"finite {bool(np.isfinite(master).all())}; launches: wsola_chain "
              f"{config4_wsola}, polyphase_resample {config4_resample} ({card})")
        check(master.shape == (2, CONFIG4_LENGTH),
              f"config-4 master {master.shape}, want (2, {CONFIG4_LENGTH})")
        check(bool(np.isfinite(master).all()), "config-4 master not finite")
        check(config4_wsola >= 2, f"WSOLA kernel launched {config4_wsola} times")
        check(counts_config4["wsola_energy"] == config4_wsola,
              f"WSOLA energy prologue launched {counts_config4['wsola_energy']}"
              f" times beside {config4_wsola} chain launches")
        check(config4_resample >= 2,
              f"resample kernel launched {config4_resample} times")
        del master

        [excerpt4] = write_tracks(
            tmp, [make_signals(EXCERPT_SECONDS, seed=4)[0]],
            f"{EXCERPT_SECONDS}s_config4")
        decisions = []
        chain = wsola.wsola_chain

        def recording_chain(*a):
            bs, body = chain(*a)
            decisions.append(bs.cpu())
            return bs, body

        wsola.wsola_chain = recording_chain
        try:
            on_card = Runner(config4_graph(excerpt4), device=CARD).render("export")
            on_cpu = Runner(config4_graph(excerpt4), device="cpu").render("export")
        finally:
            wsola.wsola_chain = chain
        check(len(decisions) == 4, f"{len(decisions)} WSOLA chains, want 4")
        same = all(torch.equal(a, b) for a, b in zip(decisions[:2], decisions[2:]))
        check(on_card.master.shape == on_cpu.master.shape,
              f"master {on_card.master.shape} vs {on_cpu.master.shape}")
        err = float(np.abs(on_card.master - on_cpu.master).max())
        print(f"[7 config4] {EXCERPT_SECONDS} s excerpt: master "
              f"{list(on_card.master.shape)}, splice decisions card vs cpu "
              f"{'equal' if same else 'DIFFER'} ({[len(d) for d in decisions[:2]]}"
              f" frames), max|card - cpu| master = {err:.3e} (tol {TOL:.0e}) "
              f"({card})")
        check(same, "card and CPU chose different splices")
        check(err <= TOL, "card master disagrees with the CPU plain path")

        # -- 8. times ----------------------------------------------------------
        wsola_times, energy_times = {}, {}
        for tag, (x, head, geo) in (("pitch", (x1, head1, geo1)),
                                    ("velocity", (x2, head2, geo2))):
            args = (x, head, *chain_args(geo))
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (cuda_wsola.wsola_chain_cuda if name == "kernel"
                      else wsola.wsola_chain_plain)
                runs[name] += cuda_ms(lambda: fn(*args), 2, warmup=1)
            K, n_cand = geo["K"], geo["seek"] + 1
            C, ov, stride = x.shape[0], geo["overlap"], geo["seq"] - geo["overlap"]
            # Least work: x read once, bs and the body written once; the
            # correlations 2*C*overlap*(seek+1) flops per frame (the energies
            # could be running sums).
            wsola_times[tag] = dict(
                K=K,
                kernel=summary(runs["kernel"])[0],
                plain=summary(runs["plain"])[0],
                bound=bound(4 * (x.numel() + K + C * K * stride),
                            2 * C * ov * n_cand * K),
            )
            for name in ("kernel", "plain"):
                med, lo, hi, count = summary(runs[name])
                print(f"[8 times] WSOLA {tag} stage, K={K}, x {list(x.shape)}, "
                      f"{name}: median {med:.4f} ms (min {lo:.4f}, max "
                      f"{hi:.4f}, n={count}) ({card})")
            ms, by = wsola_times[tag]["bound"]
            print(f"[8 times] WSOLA {tag} stage bound: {ms:.4f} ms by {by}; "
                  f"kernel at {ms / wsola_times[tag]['kernel']:.2%} of it "
                  f"({card})")
            # The serial floor (an estimate): each candidate's correlation
            # is a chain of C*overlap dependent FFMAs (2*C*overlap flops).
            floor_us = C * ov * FFMA_LATENCY_CYCLES / sm_clock_mhz
            per_frame = wsola_times[tag]["kernel"] * 1e3 / K
            wsola_times[tag]["us_per_frame"] = per_frame
            print(f"[8 times] WSOLA {tag} stage: {per_frame:.4f} us per frame "
                  f"(prologue and chain, {-(-K // cuda_wsola.BLOCK_FRAMES)} "
                  f"launches each); serial floor ~{floor_us:.4f} us (estimate:"
                  f" {C * ov} dependent FFMAs x {FFMA_LATENCY_CYCLES} cycles at"
                  f" the {sm_clock_mhz:.0f} MHz max SM clock) ({card})")
            eargs = (x, 0, 0, *chain_args(geo))
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (cuda_wsola.wsola_energy_cuda if name == "kernel"
                      else wsola.wsola_energy_plain)
                runs[name] += cuda_ms(lambda: fn(*eargs), 3, warmup=1)
            # Least work: x read once, the table written once; a multiply
            # and an add per (candidate, channel, tap).
            energy_times[tag] = dict(
                kernel=summary(runs["kernel"])[0],
                plain=summary(runs["plain"])[0],
                bound=bound(4 * (x.numel() + K * n_cand),
                            2 * C * ov * n_cand * K))
            for name in ("kernel", "plain"):
                med, lo, hi, count = summary(runs[name])
                print(f"[8 times] WSOLA energy prologue, {tag} stage, K={K} "
                      f"in one launch, {name}: median {med:.4f} ms (min "
                      f"{lo:.4f}, max {hi:.4f}, n={count}) ({card})")
            ms, by = energy_times[tag]["bound"]
            print(f"[8 times] WSOLA energy prologue, {tag} stage bound: "
                  f"{ms:.4f} ms by {by}; kernel at "
                  f"{ms / energy_times[tag]['kernel']:.2%} of it ({card})")

        def conv1d_call(x3, weight, M_):
            return F.conv1d(x3, weight, stride=M_)

        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, KERNEL_PAIRS[1][2]))).astype(
                np.float32)).to(dev)
        x, G, M, W, bank, support = tr.bank_operands(data,
                                                     *KERNEL_PAIRS[1][:2])
        transpose_bound = resample_work_bound(x, G, M, bank)
        fns = {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support),
            "plain": functools.partial(tr.apply_filter_bank_plain, x, G, M, W,
                                       bank),
            "conv1d": functools.partial(conv1d_call, x.view(2, 1, -1),
                                        bank.view(-1, 1, W), M),
        }
        resample_times["635/504"] = time_resampler(
            "8 times", f"635/504 transposition, bank {list(bank.shape)}, x "
            f"{list(x.shape)}", fns,
            ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"), 5,
            card, transpose_bound)
        del data, x, fns

        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, MAIN_CAPACITY))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank, _ = tr.bank_operands(data, *KERNEL_PAIRS[0][:2])
        med, lo, hi, count = summary(cuda_ms(functools.partial(
            conv1d_call, x.view(2, 1, -1), bank.view(-1, 1, W), M), 10))
        library_ms = med
        print(f"[8 times] 44.1->48 kHz, one {SECONDS} s stereo track, conv1d: "
              f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}); "
              f"bound {resample_bound[0]:.4f} ms by {resample_bound[1]}; the "
              f"kernel {kernel_ms:.4f} ms ({card})")
        del data, x

        device_rtf("8 times", "config 4", config4_graph(track_path), "export",
                   card, iters=3, profile=("8 times", "config-4"))

        # -- 9. pv-kernels -----------------------------------------------------
        pv_worst = {"abs": 0.0, "lock": 0.0}
        for rate, tempo in GOLDEN_CASES:
            sig = torch.from_numpy(golden_signal(rate)).to(dev)
            worst, _ = check_pv(f"golden signal {rate} Hz, tempo {tempo}",
                                pv_operands(sig, tempo, rate), card)
            pv_worst = {k: max(pv_worst[k], worst[k]) for k in pv_worst}
        # Config 4's two PV stages at full width, on the main path's own
        # data: the 300 s track at 48 kHz, then the pitch stage's
        # transposed output.
        decoded = decode_file(track_path)
        track = torch.zeros((2, MAIN_CAPACITY), device=dev)
        track[:, : decoded.num_samples] = torch.from_numpy(decoded.data).to(dev)
        s48 = tr.resample_stream(Stream(data=track, length=decoded.num_samples,
                                        rate=RATE, channels=2), 48_000)
        del track, decoded
        pitch = 2.0 ** (PITCH / 12.0)
        pv_ops = {"pitch": pv_operands(s48.data, 1.0 / pitch, 48_000)}
        out1, len1 = pv.pv_stretch_at_rate(s48.data, s48.length, 1.0 / pitch,
                                           48_000)
        s2, _ = stretch.transpose_rate(out1, len1, pitch)
        del s48, out1
        pv_ops["velocity"] = pv_operands(s2, VELOCITY, 48_000)
        del s2
        frames = tuple(pv_ops[t][0].shape[1] for t in ("pitch", "velocity"))
        check(frames == CONFIG4_PV_FRAMES,
              f"PV frames {frames}, want {CONFIG4_PV_FRAMES}")
        lock_inputs = {}
        for tag, ops in pv_ops.items():
            worst, lock_inputs[tag] = check_pv(
                f"config-4 {tag} stage, K={ops[0].shape[1]}, planes "
                f"{list(ops[0].shape)}", ops, card)
            pv_worst = {k: max(pv_worst[k], worst[k]) for k in pv_worst}
        pv_worst["lock"] = max(pv_worst["lock"], lock_cases(lock_inputs, card))

        # -- 10. config4-pv ----------------------------------------------------
        proj = os.path.join(tmp, "config4_pv.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path, algorithm="pv").serialize(), f)
        _, counts_pv = cli_export(cli, proj, os.path.join(tmp, "config4_pv.wav"),
                                  "10 config4-pv", card)
        check(counts_pv["pv_phase_path"] >= 2,
              f"phase-path kernel launched {counts_pv['pv_phase_path']} times")
        check(counts_pv["pv_lock"] == 0,
              f"lock kernel launched {counts_pv['pv_lock']} times, want 0")
        check(counts_pv["polyphase_resample"] >= 2,
              f"resample kernel launched {counts_pv['polyphase_resample']} times")
        def render_excerpt(device, phase_path=None, analysis=None):
            """The PV config-4 excerpt's master; optionally with the phase
            path or the analysis replaced for this render only."""
            saved = pv.phase_path, pv._analysis
            pv.phase_path = phase_path or saved[0]
            pv._analysis = analysis or saved[1]
            try:
                return Runner(config4_graph(excerpt4, algorithm="pv"),
                              device=device).render("export").master
            finally:
                pv.phase_path, pv._analysis = saved

        def nudged_analysis(*a):
            """The analysis planes with re moved one ulp up or down."""
            re, im = saved_analysis(*a)
            up = torch.from_numpy(np.random.default_rng(0).random(re.shape)
                                  < 0.5).to(re.device)
            away = torch.where(up, math.inf, -math.inf).to(re.dtype)
            return torch.nextafter(re, away), im

        saved_analysis = pv._analysis
        on_card = render_excerpt(CARD)
        card_plain = render_excerpt(CARD, phase_path=pv.phase_path_plain)
        on_cpu = render_excerpt("cpu")
        cpu_nudged = render_excerpt("cpu", analysis=nudged_analysis)
        check(on_card.shape == card_plain.shape == on_cpu.shape,
              f"master {on_card.shape} vs {card_plain.shape}, {on_cpu.shape}")
        pv_excerpt_db = snr_db(card_plain, on_card)
        device_db = snr_db(on_cpu, on_card)
        nudge_db = snr_db(on_cpu, cpu_nudged)
        print(f"[10 config4-pv] {EXCERPT_SECONDS} s excerpt: master "
              f"{list(on_card.shape)}; kernels vs the plain versions, both on "
              f"the card: SNR {pv_excerpt_db:.1f} dB (min {PV_EXCERPT_DB:.0f}),"
              f" max|diff| {float(np.abs(on_card - card_plain).max()):.3e}; "
              f"card vs cpu: SNR {device_db:.1f} dB (min {PV_DEVICE_DB:.0f}); "
              f"cpu vs cpu with re one ulp off: SNR {nudge_db:.1f} dB ({card})")
        check(pv_excerpt_db >= PV_EXCERPT_DB,
              "the card's PV kernels disagree with its plain versions")
        check(device_db >= PV_DEVICE_DB,
              "card PV master disagrees with the CPU plain path")
        del on_card, card_plain, on_cpu, cpu_nudged

        # -- 11. config4-pv-options --------------------------------------------
        proj = os.path.join(tmp, "config4_pv_options.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path, algorithm="pv", transient=True,
                                    formants=True).serialize(), f)
        _, counts_opt = cli_export(
            cli, proj, os.path.join(tmp, "config4_pv_options.wav"),
            "11 config4-pv-options", card)
        check(counts_opt["pv_lock"] >= 2,
              f"lock kernel launched {counts_opt['pv_lock']} times, want >= 2")
        check(counts_opt["pv_phase_path"] == 0,
              f"phase-path kernel launched {counts_opt['pv_phase_path']} times")

        # -- 12. times ---------------------------------------------------------
        pv_times = {}
        for tag, (re, im, dpos, hop, n_fft) in pv_ops.items():
            lock_in = lock_inputs[tag]
            fns = {
                "phase kernel": lambda: cuda_pv.phase_path_cuda(
                    re, im, dpos, hop, n_fft, True),
                "phase plain": lambda: pv.phase_path_plain(
                    re, im, dpos, hop, n_fft, True),
                "lock kernel": lambda: cuda_pv.lock_to_peaks_cuda(*lock_in),
                "lock plain": lambda: pv._lock_to_peaks(*lock_in),
            }
            runs = {name: [] for name in fns}
            for name in ("phase plain", "phase kernel", "phase kernel",
                         "phase plain"):
                runs[name] += cuda_ms(fns[name], 3, warmup=1)
            for name in ("lock plain", "lock kernel", "lock kernel",
                         "lock plain"):
                runs[name] += cuda_ms(
                    fns[name], 3 if "plain" in name else 50, warmup=1,
                    queued=True)
            n = re.numel()
            # Least work: the phase path reads re, im and writes two planes;
            # ~33 operations per element, each transcendental counted as
            # one (magnitude, phase, wrap, advance, rotation, lock,
            # products). The lock: lock_work_bound.
            pv_times[tag] = {name: summary(runs[name])[0] for name in fns}
            pv_times[tag]["phase bound"] = bound(4 * 4 * n, 33 * n)
            pv_times[tag]["lock bound"] = lock_work_bound(re.shape)
            for name in fns:
                med, lo, hi, count = summary(runs[name])
                print(f"[12 times] PV {tag} stage, planes {list(re.shape)}, "
                      f"{name}: median {med:.4f} ms (min {lo:.4f}, max "
                      f"{hi:.4f}, n={count}) ({card})")
            for what in ("phase", "lock"):
                ms, by = pv_times[tag][f"{what} bound"]
                print(f"[12 times] PV {tag} stage {what} bound: {ms:.4f} ms by "
                      f"{by}; kernel at {ms / pv_times[tag][what + ' kernel']:.2%}"
                      f" of it ({card})")
            # The phase kernel's three passes, by the profiler's device time.
            passes = pass_ms(fns["phase kernel"], 5)
            pv_times[tag]["passes"] = passes
            parts = ", ".join(f"{name} {passes[name]:.4f} ms"
                              for name in PV_PASSES if name in passes)
            print(f"[12 times] PV {tag} stage, phase kernel by pass "
                  f"(torch.profiler, 5 calls): "
                  f"{parts or 'not measured (no device time seen)'}; sum "
                  f"{sum(passes.values()):.4f} ms beside the call's "
                  f"{pv_times[tag]['phase kernel']:.4f} ms and the bound "
                  f"{pv_times[tag]['phase bound'][0]:.4f} ms ({card})")
        del pv_ops, lock_inputs, fns

        device_rtf("12 times", "config 4 on the phase vocoder (rtf_config4_pv)",
                   config4_graph(track_path, algorithm="pv"), "export", card,
                   iters=3, profile=("12 times", "config-4 PV"))

        # -- 13. stream-kernel -------------------------------------------------
        # Config 4 streamed at 16 s chunks on phase 6's data (track 1, float
        # samples): the graph's own chunk steps, driven by hand, cut the
        # pitch stage's 48 kHz input as the streaming plan does. Every launch
        # of the chunk entry is held against the plain chunk chain on the
        # same operands, and each stage's splices of all steps against the
        # offline chain kernel's over the whole clip.
        chunk = STREAM_CHUNK_SECONDS * RATE
        graph13 = config4_graph(track_path)
        compiled = chunkflow.compile_stream_graph(
            graph13, {(0, "output_0"): SourceSpec(
                rate=RATE, channels=2, fmt="flt", capacity=chunk)},
            device=CARD)
        by_kind = {node.processor.info().identifier: node.processor
                   for node in graph13.nodes.values()}
        plans = {"pitch": by_kind["pitch_modifier"]._wsola_plan,
                 "velocity": by_kind["velocity_modifier"]._wsola_plan}
        calls = {"pitch": [], "velocity": []}
        chunk_chain = wsola.wsola_chunk_chain

        def recording_chunk_chain(*a):
            out = chunk_chain(*a)
            if a[4]:
                tag = "pitch" if a[5] == plans["pitch"].num else "velocity"
                calls[tag].append(((a[0].clone(), a[1].clone(), *a[2:]), out))
            return out

        wsola.wsola_chunk_chain = recording_chunk_chain
        try:
            states, pos, steps13 = compiled.init_states, 0, 0
            while True:
                n = max(0, min(chunk, track1.shape[1] - pos))
                block = torch.zeros((2, chunk), device=dev)
                block[:, :n] = torch.from_numpy(track1[:, pos : pos + n]).to(dev)
                pos += chunk
                states, outs = compiled.step(states, {"n0:output_0": (
                    block, n, pos >= track1.shape[1])})
                steps13 += 1
                if outs["master"][2]:
                    break
        finally:
            wsola.wsola_chunk_chain = chunk_chain
        torch.cuda.synchronize()
        del compiled, states, outs, block
        print(f"[13 stream-kernel] config 4 at {STREAM_CHUNK_SECONDS} s chunks: "
              f"{steps13} steps; plans k_cap pitch {plans['pitch'].k_cap}, "
              f"velocity {plans['velocity'].k_cap}; FIFO snapshot x "
              f"[2, {plans['pitch'].window + plans['pitch'].push_cap}] and "
              f"[2, {plans['velocity'].window + plans['velocity'].push_cap}] "
              f"({card})")
        stream_err = 0.0
        for tag, geo, offline_bs in (("pitch", geo1, bs1),
                                     ("velocity", geo2, bs2)):
            streamed_bs, err = check_chunk_calls(
                f"{tag} stage", calls[tag], geo, card)
            stream_err = max(stream_err, err)
            same = torch.equal(streamed_bs,
                               offline_bs[: streamed_bs.numel()])
            print(f"[13 stream-kernel] {tag} stage: splices of all "
                  f"{len(calls[tag])} steps ({streamed_bs.numel()} frames) "
                  f"{'equal' if same else 'DIFFER from'} the offline chain "
                  f"kernel's first {streamed_bs.numel()} of K={geo['K']} "
                  f"({card})")
            check(same, f"{tag}: streamed splices differ from offline")

        # -- 14. streamed export -----------------------------------------------
        # Both graphs at 300 s through `run --stream`, every step under the
        # sync debug mode, against the offline card renders of phases 4 and
        # 7, launch counts set to 0 just before. Then device memory: each
        # graph exported again at 100 s and at 300 s, the whole export's
        # peak each, beside the offline render's peak on the same project.
        short_paths = write_tracks(tmp, make_signals(SHORT_SECONDS, seed=5),
                                   f"{SHORT_SECONDS}s")
        streamed = {}
        for tag, proj, offline_wav, tol, short_tracks in (
                ("5node", proj_5node, wav_5node, STREAM_MIX_TOL, short_paths),
                ("config4", proj_c4, wav_c4, TOL, short_paths[:1])):
            streamed[tag] = streamed_export_checks(
                cli, "14 streamed", tag, proj,
                lambda wav=offline_wav: decode_file(wav).data, tol, card, tmp,
                short_tracks=short_tracks)
            check(streamed[tag]["counts"]["polyphase_resample"] >= 1,
                  f"{tag}: resampler launched "
                  f"{streamed[tag]['counts']['polyphase_resample']}")
        check(streamed["config4"]["counts"]["wsola_chain"] >= 2
              and streamed["config4"]["counts"]["wsola_energy"] >= 2,
              "the WSOLA kernel did not run on the streamed config 4")
        whole_clip_rss(cli, "14 streamed", "5node", proj_5node, short_paths,
                       tmp, streamed["5node"]["rss"], card)

        # -- 15. stream times --------------------------------------------------
        for tag, proj, name, what in (
                ("5node", proj_5node, "e2e_streamed_wav",
                 "5-node graph, two tracks"),
                ("config4", proj_c4, "e2e_streamed_timevariant",
                 "config 4 on WSOLA, WAV sink")):
            stream_times(cli, "15 stream times", name, what, proj,
                         os.path.join(tmp, f"{tag}_timed.wav"),
                         streamed[tag]["device_ms"], card)
        chunk_times = {}
        for tag in ("pitch", "velocity"):
            plan = plans[tag]
            args, _ = calls[tag][len(calls[tag]) // 2]
            args = (*args[:4], plan.k_cap, *args[5:])
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (cuda_wsola.wsola_chunk_chain_cuda if name == "kernel"
                      else wsola.wsola_chunk_chain_plain)
                runs[name] += cuda_ms(lambda: fn(*args), 2, warmup=1)
            C, ov = 2, plan.overlap
            span = plan.window - 2          # the k_cap frames' windows
            chunk_times[tag] = dict(
                K=plan.k_cap,
                kernel=summary(runs["kernel"])[0],
                plain=summary(runs["plain"])[0],
                bound=bound(4 * (C * span + C * ov + plan.k_cap
                                 + C * plan.k_cap * plan.stride_out + C * ov),
                            2 * C * ov * (plan.seek + 1) * plan.k_cap),
                total=sum(cuda_ms(lambda a=a: cuda_wsola.wsola_chunk_chain_cuda(
                    *a), 1, warmup=0)[0] for a, _ in calls[tag]),
            )
            t = chunk_times[tag]
            for name in ("kernel", "plain"):
                med, lo, hi, count = summary(runs[name])
                print(f"[15 stream times] chunk chain, {tag} stage, K=k_cap="
                      f"{plan.k_cap}, {name}: median {med:.4f} ms per launch "
                      f"(min {lo:.4f}, max {hi:.4f}, n={count}) ({card})")
            print(f"[15 stream times] chunk chain, {tag} stage bound: "
                  f"{t['bound'][0]:.4f} ms by {t['bound'][1]}; kernel at "
                  f"{t['bound'][0] / t['kernel']:.2%} of it; the kernel over "
                  f"the export's {len(calls[tag])} launches: {t['total']:.4f} "
                  f"ms ({card})")
        del calls

        # -- 16-18. wsola-table, probes, resample-data ----------------------
        stages = [("pitch", x1, head1, geo1, bs1, body1),
                  ("velocity", x2, head2, geo2, bs2, body2)]
        del x1, x2, head1, head2, body1, body2
        chain_us = wsola_times["pitch"]["kernel"] * 1e3 / geo1["K"]
        tool_paths, tool_entries = table_and_probe_phases(card, dev, stages,
                                                          chain_us)
        del stages

        # -- 19. stream-pv --------------------------------------------------
        pv_stream_paths, lock_chunk, stream_lock_err = stream_pv_phase(
            cli, card, dev, tmp, track1, track_path, excerpt4, short_paths[0])
        del track1

        # -- 20-21. realtime, chunked --------------------------------------
        session_paths = realtime_and_chunked_phases(cli, card, tmp, proj_5node,
                                                    excerpt)

        # -- 22-24. configs 1, 2, 3 and 5 ------------------------------------
        config_paths, config_figures = config_phases(cli, card, tmp,
                                                     short_paths[0])

        # -- 25-26. config 6 and the master-bus nodes ------------------------
        masterbus_paths = masterbus_phases(cli, card, tmp)

        # -- 27-28. config 7 and the channel strips --------------------------
        effects_paths = effects_phases(cli, card, tmp)

        # -- 29. the timeline nodes -------------------------------------------
        timeline_paths, timeline_resample_err = timeline_phases(
            cli, card, tmp, track_path)

        # -- 30. batched serving ----------------------------------------------
        batch_paths, _batch_figures, batch_kernels = batch_phase(cli, card,
                                                                 dev, tmp)

        # -- 31. batched serving of configs 2, 5, 6 and 7 ---------------------
        configs_paths, _configs_figures, configs_kernels = (
            batch_configs_phase(cli, card, dev, tmp))

        # -- 32. batched serving of the effect and timeline nodes -------------
        effects_batch_paths, _effects_figures, effects_kernels = (
            batch_effects_phase(cli, card, dev, tmp))

        # -- 33. the web editor's server ---------------------------------------
        serve_paths = serve_phase(cli, card, tmp, proj_5node, excerpt)

        # -- 34. the mesh --------------------------------------------------------
        mesh_paths, mesh_figures = mesh_phase(card, dev, tmp, paths_5node)

        # -- 35. tp and dp x sp x tp -----------------------------------------
        tp_paths, tp_figures = tp_phase(card, dev, tmp)

        # -- 36. the mesh across processes; what needs the codec runtime ------
        dcn_paths, dcn_figures = dcn_phase(cli, card, dev, tmp, excerpt)

    def by_path(name):
        return {path: counts[name] for path, counts in (
            ("5node", counts_5node), ("config4", counts_config4),
            ("config4_pv", counts_pv), ("config4_pv_options", counts_opt),
            ("5node_streamed", streamed["5node"]["counts"]),
            ("config4_streamed", streamed["config4"]["counts"]),
            *pv_stream_paths.items(), *session_paths.items(),
            *tool_paths.items(), *config_paths.items(),
            *masterbus_paths.items(), *effects_paths.items(),
            *timeline_paths.items(), *batch_paths.items(),
            *configs_paths.items(), *effects_batch_paths.items(),
            *serve_paths.items(), *mesh_paths.items(), *tp_paths.items(),
            *dcn_paths.items())}

    def batch8(name, source=None):
        # The kernel's first launch on phase 30's batch of 8 x 30 s clips (or
        # on phase 31's or 32's, from ``source``).
        t = (source or batch_kernels)[name]
        return {"shape": t["shape"], "ms": t["ms"],
                "plain_ms": t.get("plain_ms"), "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                **({"one_clip_ms": t["one_clip_ms"]} if "one_clip_ms" in t
                   else {})}

    def with_launches(entry):
        # resample_data is the polyphase kernel reached through the A/B
        # entry: its launches are those of that path alone.
        if entry["name"] == "resample_data":
            paths = {"resample_ab":
                     tool_paths["resample_ab"]["polyphase_resample"]}
        else:
            paths = by_path(entry["name"])
        return {**entry, "launches": sum(paths.values()),
                "launches_by_path": paths}

    pitch_times = wsola_times["pitch"]
    pv_pitch = pv_times["pitch"]
    print(json.dumps({"kernels": [
        {
            "name": "polyphase_resample",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/polyphase_resample.cu",
            "replaces": "nodey_tpu/ops/pallas_resample.py:245",
            "launches": sum(by_path("polyphase_resample").values()),
            "launches_by_path": by_path("polyphase_resample"),
            "max_abs_err": max(kernel_err, config_figures["resample_err"],
                               timeline_resample_err,
                               mesh_figures["resample_err"],
                               tp_figures["resample_err"],
                               dcn_figures["resample_err"],
                               *(v for k, v in {**batch_kernels,
                                                **configs_kernels,
                                                **effects_kernels}.items()
                                 if k.endswith("resample_err"))),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": resample_bound[0],
            "bound_by": resample_bound[1],
            "library_ms": library_ms,
            "transposition_635_504": {
                "ms": resample_times["635/504"]["kernel"],
                "plain_ms": resample_times["635/504"]["plain"],
                "bound_ms": transpose_bound[0],
                "bound_by": transpose_bound[1],
                "library_ms": resample_times["635/504"]["conv1d"]},
            "transposition_minus3": config_figures["transposition_minus3"],
            "batch8": batch8("polyphase_resample"),
            "batch8_config5_transposition": {
                **batch8("config5_transposition", configs_kernels),
                "library_ms": configs_kernels["config5_transposition"][
                    "library_ms"]},
            "batch8_mixed_rate": {
                **batch8("mixed_rate_resample", effects_kernels),
                "library_ms": effects_kernels["mixed_rate_resample"][
                    "library_ms"]},
        },
        {
            "name": "wsola_chain",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:452",
            "launches": config4_wsola,
            "launches_by_path": by_path("wsola_chain"),
            "max_abs_err": max(wsola_err, batch_kernels["wsola_err"],
                               configs_kernels["config5_wsola_err"],
                               mesh_figures["wsola_err"]),
            "ms": pitch_times["kernel"],
            "plain_ms": pitch_times["plain"],
            "bound_ms": pitch_times["bound"][0],
            "bound_by": pitch_times["bound"][1],
            "library_ms": None,
            "us_per_frame": pitch_times["us_per_frame"],
            "geometry_44100": config_figures["chain_44100"],
            "batch8": batch8("wsola_chain"),
            "batch8_config5": batch8("config5_wsola_chain", configs_kernels),
        },
        {
            "name": "wsola_chunk_chain",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:408",
            "launches": streamed["config4"]["counts"]["wsola_chain"],
            "launches_by_path": by_path("wsola_chain"),
            "max_abs_err": stream_err,
            "ms": chunk_times["pitch"]["kernel"],
            "plain_ms": chunk_times["pitch"]["plain"],
            "bound_ms": chunk_times["pitch"]["bound"][0],
            "bound_by": chunk_times["pitch"]["bound"][1],
            "library_ms": None,
        },
        {
            "name": "wsola_energy",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:452",
            "helper_of": "wsola_chain: no Pallas kernel of its own (the TPU "
                         "chain sums its energies in its serial loop)",
            "launches": sum(by_path("wsola_energy").values()),
            "launches_by_path": by_path("wsola_energy"),
            "max_abs_err": max(e[1] for e in energy_err),
            "max_rel_err": max(*(e[0] for e in energy_err),
                               batch_kernels["energy_rel"],
                               configs_kernels["config5_energy_rel"]),
            "ms": energy_times["pitch"]["kernel"],
            "plain_ms": energy_times["pitch"]["plain"],
            "bound_ms": energy_times["pitch"]["bound"][0],
            "bound_by": energy_times["pitch"]["bound"][1],
            "library_ms": None,
            "batch8": batch8("wsola_energy"),
            "batch8_config5": batch8("config5_wsola_energy", configs_kernels),
        },
        {
            "name": "pv_phase_path",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/pv_phase_path.cu",
            "replaces": "nodey_tpu/ops/pallas_phase.py:174",
            "launches": counts_pv["pv_phase_path"],
            "launches_by_path": by_path("pv_phase_path"),
            "max_abs_err": pv_worst["abs"],
            "ms": pv_pitch["phase kernel"],
            "plain_ms": pv_pitch["phase plain"],
            "bound_ms": pv_pitch["phase bound"][0],
            "bound_by": pv_pitch["phase bound"][1],
            "library_ms": None,
            "passes_ms": pv_pitch["passes"],
            "batch8": batch8("pv_phase_path"),
        },
        {
            # The main path is the streamed PV: its launches, and its times at
            # the pitch stage's chunk shape; the velocity stage's chunk shape
            # and the offline render's shape beside them.
            "name": "pv_lock",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/pv_lock.cu",
            "replaces": "nodey_tpu/ops/pallas_lock.py:126",
            "launches": pv_stream_paths["config4_pv_streamed"]["pv_lock"],
            "launches_by_path": by_path("pv_lock"),
            "max_abs_err": max(pv_worst["lock"], stream_lock_err,
                               batch_kernels["config4_pv_options_lock_err"],
                               mesh_figures["lock_err"]),
            "shape": lock_chunk[max(lock_chunk)]["shape"],
            "ms": lock_chunk[max(lock_chunk)]["kernel"],
            "plain_ms": lock_chunk[max(lock_chunk)]["plain"],
            "bound_ms": lock_chunk[max(lock_chunk)]["bound"][0],
            "bound_by": lock_chunk[max(lock_chunk)]["bound"][1],
            "library_ms": None,
            "velocity_chunk": {
                "shape": lock_chunk[min(lock_chunk)]["shape"],
                "ms": lock_chunk[min(lock_chunk)]["kernel"],
                "plain_ms": lock_chunk[min(lock_chunk)]["plain"],
                "bound_ms": lock_chunk[min(lock_chunk)]["bound"][0]},
            "offline": {
                "shape": [2, CONFIG4_PV_FRAMES[0], 1025],
                "ms": pv_pitch["lock kernel"],
                "plain_ms": pv_pitch["lock plain"],
                "bound_ms": pv_pitch["lock bound"][0]},
            "batch8": batch8("pv_lock"),
        },
        *map(with_launches, tool_entries),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

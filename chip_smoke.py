#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pypulsar_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result lines):

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every CUDA kernel of the port (one ``nvcc``
   per source, all started together);
2. each kernel against its plain PyTorch version on the card, on the
   shapes the 1024-channel x 1024-trial sweep gives it (gather-sum once
   per dedispersion stage), with its time (CUDA events around 10 calls
   back to back, after a warm-up; beside it the median of 10 single
   event-bracketed calls, the timer of the first port, which also counts
   a wrapper's host work the device waits for), the plain version's time
   and the least time the card could take for the same work; then on
   edge cases (gather-sum: a ragged last time tile, output rows per set
   not a multiple of the rows per block, one source row, shift spreads of
   ~2000, 15000 and 60000 samples, views whose rows start off a 16-byte
   boundary with windows at both ends, and a table past shared memory,
   which must raise ValueError; boxcar: unsorted widths that are not
   powers of two, widths past the 256 threads of a block, more than 8
   widths, a payload that is not a multiple of a block's stretch, views
   off a 16-byte boundary, ties).
   Tolerances: gather-sum exact (both add in k order from zero: max abs
   err 0); boxcar sums of squares and window maxima rtol 1e-5, payload
   sums rtol 1e-5 plus 1e-5 * sqrt(sum of squares) (a sum of zero-mean
   samples cancels), and each argbox start equal to the plain version's
   or holding the same maximum within rtol 1e-5;
3. the flat sweep on a small file (256 channels, 2^16 8-bit samples),
   on the card against the CPU; then the plain ``--write-dats`` writer
   (``sweep --write-dats`` without ``--accel-search``) on it over 16
   trials, its resident branch (the whole file a ``Spectra`` on the
   card, each trial's exact per-channel dedispersion) on the card against
   the same run with ``--device cpu``: every ``.dat`` within 1e-6 of the
   series' largest magnitude (float32 sums in another order; the 8-bit
   file's integer sums are exact, so 0 is expected), every ``.inf`` the
   same bytes; then the streamed branch once (the writer's crossover at
   0 bytes), on the card against the CPU under the same tolerance, and
   not the resident series. One ``path write_dats_plain:`` line (walls,
   largest differences);
4. the main path: ``python -m pypulsar_tpu_torch.cli.sweep``'s entry point
   on a 1024-channel, 2^20-sample 8-bit file with a pulsar at DM 70, over
   1024 trials; the pulsar must be found and every kernel (gather-sum
   of stage 1, of stage 2, boxcar) must have been launched by that run;
5. the acceleration search on the card against the port on the CPU, on
   8 seeded series of 2^15 samples (tones, drifting tones, a weak tone,
   noise): the card's normalized spectra within 2e-5 of the largest
   magnitude of a float64 transform's and the same bits twice (their
   difference from the CPU's printed), the candidates under the matched-candidate contract (dr, dz, dsig) =
   (0.5, 1.0, 0.5) above sigma_min + 0.5, and the card's candidates the
   same bits searched as one batch of 8 or two of 4; then a probe
   (printed, not a check) of whether cuFFT keeps a spectrum's bits when
   the search's transforms are batched, and what batching saves;
6. the survey's sweep stage on the same file, through the same entry
   point: ``--accel-search --write-dats`` over 16 trials from DM 62
   (the survey's defaults: zmax 200, 8 harmonics, sigma 2, batch 32;
   the survey's 32 trials cut to 16 for the script's time).
   First its kernels at its own shapes against the plain versions (both
   gather-sum stages of the single-pulse pass's plan and of the series
   pass's, at the group size the stage picks, and boxcar on the
   single-pulse pass's series; exact, and boxcar as in phase 2; run
   before phase 4 on the file phase 4 reads).
   Every artifact must be written, the DM-70 table must hold a harmonic
   of the pulsar's 3.8147 Hz with |z| <= 2 and sigma > 10, the series
   pass must have launched both gather-sum stages (counted apart from
   the single-pulse pass), and the DM-70 ``.dat`` must equal the series
   the handoff searched. Then the handoff once more, over 4 trials,
   under ``torch.profiler``: device time by op family and idle share;
7. the survey's fold stage on phase 6's output, at the survey's settings.
   First both forms of the fold kernel on the DM-70 ``.dat`` (2^20
   samples), 32 periods from 1.5 ms to 2 s that include the pulsar's, 64
   bins, 32 partitions, with f2 = 0 (the stage's coefficients) and with
   pdot and f2 != 0: the polynomial form (bins evaluated on the card in
   float64) must give, bit for bit, the profiles and counts of the array
   form fed numpy's bins (``phase_to_bins`` of the host's float64
   phases); the plain version's own bins on the card must be numpy's;
   both forms hold counts exact and profiles within rtol 1e-5 / atol 1e-3
   of their plain versions (float32 sums in another order; the JAX
   package's own fold tolerance); each candidate's profile has the same
   bits in one batch of 32, two of 16 and alone. Then edge cases of both
   forms (50 bins, T not a multiple of npart with an odd partition
   length, a series view 4 bytes off a 16-byte boundary, one candidate,
   every sample in one bin, the largest nbins, and one past it, which
   must raise ValueError; for the polynomial form also phases that turn
   back below zero or start negative, more than a turn a sample, and bins
   past 2^31), each form's kernel timed on inputs on the card beside its
   bound, its plain version and one ``index_add_`` of the same sums, and
   over all-short and all-long periods, and the polynomial form's wrapper
   with its host check and upload of the table. Then ``cli.sift`` over the stage's 16 ``.cand`` files (``-s 4
   --min-hits 2``), ``cli.foldbatch --datbase`` (``-n 64 --npart 32
   --batch 32``, the 33 x 17 refinement grid), ``cli.pfd_snr --json``,
   ``cli.foldbatch`` on the raw file (the stream source, ``-s 64
   --group-size 0``), and both sources once more at ``--batch 7``. Every
   sifted candidate must have its archives, each archive the same bytes
   at batch 32 and 7 from each source, both sources must have launched the
   polynomial form and the stream source both gather-sum stages, and a
   candidate within 2 DM of 70 at the pulsar's period or a harmonic (k or
   1/k an integer <= 8) must fold to SNR > 10 from both sources with a
   refined period within one grid step of the true one. Then one more
   ``--datbase`` fold under ``torch.profiler``: the fold kernel's,
   ``refine_chi2``'s and the copies' device time, the host prep's wall
   time and the idle share, and the fold kernel's launches counted twice,
   by the profiler (kernels matched by their whole name) and by the
   wrappers' counters over the same run, beside each call's candidates.

8. the survey's whole chain (``survey.dag.run_observation``: mask ->
   sweep ``--mask --journal`` -> sift -> fold -> snr) with the survey's
   default ``SurveyConfig`` but its trials (mask on, 1-s intervals, the
   chain journal; ``CHAIN_CFG``: 8 trials DM 58-72 in steps of 2, the
   default 32 cut for the script's time), on a copy of the phase-4 file with RFI
   written into its data bytes: a square-wave tone of period 16 samples
   at 0/255 on 16 adjacent channels, and +25 counts on every channel over
   one 1-s interval. First the mask stage's gates: the card's block
   statistics on the first read (16 intervals x 1024 channels; timed)
   within mean/std atol 1e-5 and max power rtol 2e-3 of the float64
   twin; the card's ``.mask`` of the file's first 2^18 samples the bytes
   of the port's on the CPU, or every differing flag within the
   statistics' bounds of its threshold by the twin
   (``ops.rfifind.decision_margins``).
   Then the chain, whose mask must zap the 16 tone channels and the
   interval whole and flag under 1% of the other cells; a candidate
   within 2 DM of 70 at the pulsar's period or a harmonic must fold to
   SNR > 10 in ``_snr.json``; the chain must have launched both
   gather-sum stages, boxcar and the polynomial fold; and a second run of
   its sweep stage with the same journal must search and sweep nothing
   and leave every artifact's sha256 unchanged. Each stage's wall time
   is printed beside phase 6's unmasked sweep stage, with the blocks the
   mask fill filled and its device time per block of each shape.

9. the sweep's other dedispersion paths. (a) Before the engines, the
   tree engine's widest merge level (gather-sum, K = 2 over the previous
   level's rows, written into the wider state buffer) and its snap (K = 1)
   at the 1024-trial sweep's shape against the plain version on random
   state rows (exact), timed beside their bounds (each distinct source
   row read once, each output written once); then ``cli.sweep --engine
   tree`` and ``--engine fourier`` over phase 4's 1024 trials: the pulsar
   found, every trial's SNR within 2e-6 relative of phase 4's gather run
   (``|a - b| / max(|b|, 1)``), every peak start equal or an exact tie
   proven on the file's integer samples (counted), the tree run through
   ``tree_level``, ``tree_snap`` and boxcar, the Fourier run through
   boxcar; wall, DM-trials/s, peak device memory and the tree's adds per
   sample and state bytes printed. (b) ``--accel-search --spectral``
   over phase 6's 16 trials: every ``.cand``/``.txtcand`` the bytes of
   phase 6's, the DM-70 harmonic found, no series byte copied to the
   host; wall and spectra/s beside phase 6's. (c) The decimated regime
   (``sweep_accel_stream(spectral=True, specfuse_mode="decimate")``, the
   Fourier engine, one chunk) over the same trials: the harmonic found
   with sigma > 10, and the candidates it and the stitched run do not
   match under (0.5, 1.0, 0.5) counted (printed only: decimation is
   circular dedispersion by design). (d) ``run_observation`` with
   ``SurveyConfig(**CHAIN_CFG, accel_spectral=True)`` on phase 8's RFI copy:
   each ``.cand``/``.txtcand`` the bytes of phase 8's chain, the pulsar
   folded to SNR > 10 from the raw-file stream, a journalled rerun of the
   sweep stage redoing nothing; each stage's wall beside phase 8's. (e)
   ``cli.sweep --ddplan --lodm 0 --hidm 512`` on the phase-4 file: the
   plan's steps printed, the best candidate within one step's dDM of DM
   70, every step through both gather-sum stages and boxcar; the wall.
   The tree snap (K = 1) is also held, exactly, to one ``torch.gather``
   of the flat state at index ``row * L + shift + t``, its library time.

10. prepfold and the archive folds (the channel fold kernel
   ``ops/csrc/fold_chan.cu``). (a) The kernel against its plain version
   on the card at the JAX package's fold benchmark (a resident [1024,
   2^20] float32 block made on the card from a seed, 128 bins, 64
   partitions), prepfold's default block ([32, 32768], 64 bins) and the
   widest archive ([1024, 16384], 128 bins), then padding and negative
   indices, one bin, the largest nbins and one past it (ValueError), T
   not a multiple of npart, partitions past the reference's 2^17-sample
   seam, 37 channels, row views 4 bytes off a 16-byte boundary; each
   channel folded alone has the bits of the same channel in the block,
   and the 1-D ``fold_bins`` the bits of the C = 1 fold and of the 2-D
   fold's row. Tolerances: counts exact, profiles rtol 1e-5 / atol 1e-3.
   Timed as phase 2 (``ms``, ``single_call_ms``), beside the bound, the
   plain version and the faster of one ``index_add_`` over the flattened
   cube and one ``torch.bmm`` with the one-hot (named). (b) ``fold_stats``
   and ``fold_snr_stats`` at that size with tests/test_timing.py's
   injected pulsar: SNR > 10, the refined period within that test's
   bound, the statistics within its tolerances of the plain version's
   (the rotated profiles' rtol taken of their largest magnitude). (c)
   ``cli.prepfold -p 0.262144 --dm 70`` on phase 4's file at prepfold's
   defaults and at ``--nsub 1024 -n 128 --npart 64``: each writes its
   ``.pfd`` and folds the pulsar to SNR > 10 through ``cli.pfd_snr
   --json``; the default run keeps the prepfold contract of the CPU tests
   against ``--device cpu``; the wide archive summed over subbands (bins
   and partitions paired) equals the default's at rtol 1e-5; wall,
   samples folded per second and the host's read + copy share printed.
   (d) ``prepfold --par`` on a barycentred 2^20-sample ``.dat`` of 64 us
   samples with a strong spin-down: contrast above 1.5 x the
   constant-period fold's, ``curr_p2`` within 10% of ``-f1 / f0^2``. (e)
   ``prepfold --cands`` on phase 7's sifted list with phase 7's fold
   flags: each archive the bytes of ``cli.foldbatch`` run with the argv
   prepfold builds. The timing rows of prepfold's blocks carry the
   library time of one ``torch.bmm`` with the one-hot at that block.

11. the batch broker's lane and the multi-series fold kernel (the
   series-index forms of ``ops/csrc/fold_parts.cu``). (a) Both forms at a
   lane's size: G = 4 series (phase 6's DM 70, 62, 66 and 77 ``.dat``
   files, 2^20 samples, sample times 1, 2, 1 and 0.5 x 64 us), K = 128
   candidates (32 a series, interleaved; f2 = 0 on two series, pdot and
   f2 != 0 on the others), 64 bins, 32 partitions, and at an odd T
   (100003, so rows sit off 16-byte boundaries): the polynomial form bit
   for bit the array form fed numpy's bins; each against its plain
   version (counts exact, profiles rtol 1e-5 / atol 1e-3); every row the
   bits (max abs difference 0) of ``fold_parts_poly`` / ``fold_parts_batch``
   of its own series alone; the fused batch, its halves and each row
   alone the same bits; a series index of G refused. Timed as phase 2,
   beside the bound, the plain version and one ``index_add_`` after a
   gather of the rows. (b) ``survey.lane.run_lane`` over 2 observations
   at the chain's size, phase 8's streamed ``SurveyConfig(**CHAIN_CFG)``: A
   is phase 8's RFI copy (held to phase 8's artifacts), B a second
   ``io/synth.py`` file from another seed with its own pulsar (DM 62,
   period 2048 samples; held to its own serial ``run_observation``).
   Every ``.mask``, ``.cands``, ``.dat``, ``.inf``, ``.cand``,
   ``.txtcand``, ``.accelcands`` and ``.pfd`` byte-equal to the serial
   run's and ``_snr.json`` equal apart from the archives' directory;
   both pulsars folded to SNR > 10; the broker's dispatches fewer than
   its submissions with at least 2 units coalesced, both the accel and
   the fold stage fused at least once, no unit rerun and no failed
   dispatch; the lane launched both gather-sum stages, boxcar and the
   multi-series fold. The lane's wall beside the sum of the serial
   walls, and its peak device memory. Then the same lane at the broker's
   default window (100 ms): the same bytes, its wall and fusions printed.

12. PSRFITS, float32 ``.fil`` and multi-file input. (a) PSRFITS copies
   of phase 4's file at 8 and 4 bits (the top nibble), subints of 2048
   spectra, seeded per-channel scales and offsets drifting up to 1% from
   subint to subint, 3 channels of weight 0; on every block the sweeps
   below read (the DDplan's steps of the 8-bit copy, the flat sweep of
   the 4-bit copy) the card's ingest (stored subints unpacked and scaled
   there) must have the bits of the plain version on the CPU. (b)
   ``cli.sweep --ddplan --lodm 0 --hidm 500`` on the 8-bit copy
   (``BASELINE.json`` configs[2]): best candidate within one step's dDM
   of 70, every kernel of the sweep launched. (c) The flat 1024-trial
   sweep of the 4-bit copy: best within 1 of DM 70, the same kernels.
   (d) ``run_observation`` (``SurveyConfig(**CHAIN_CFG)``) on an 8-bit
   PSRFITS copy of phase 8's RFI file (written beside (a)'s two copies,
   in parallel threads) with phase 8's gates (the tone and
   the interval zapped, < 1% of other cells flagged, a DM-70 harmonic of
   3.8147 Hz with |z| <= 2 and sigma > 10, a ``.pfd`` of SNR > 10, the
   polynomial fold launched). (e) A float32 ``.fil`` of the first 2^18
   samples with 12 non-finite cells, swept over 1024 trials: the scrub
   must count exactly the cells its blocks hold (a cell in two blocks'
   overlap counts twice), the pulsar found. (f) ``cli.rfifind`` of the
   file split in two ``.fil`` on an interval boundary: the ``.mask`` the
   bytes of the whole file's. One ``path NAME:`` line each: wall, bytes
   shipped to the card, peak device memory, the card.
13. The ``Spectra`` surface, ``BASELINE.json`` configs[0] and [1]. (a)
   A 10-s, 256-channel 8-bit file (156,250 samples of 64 us, the pulsar
   at DM 70 every 3,125 samples, a 0/255 tone on 4 channels) masked by
   ``cli.rfifind`` (the tone's channels must be zapped), then
   ``cli.waterfaller -T 0 -t 10 --dm 70 --downsamp 4 --width-bins 4``
   with ``-s 32 --mask`` and without, on the card, writing ``.npz``
   (the card's machine has no matplotlib). For both: the CLI's image the
   bits of ``get_data`` + ``prepare_data`` on the card; the card's read
   and mask bit for bit the CPU's, then each op on the card's input on
   both devices (subband, downsample rtol 1e-5 / atol 1e-5; the
   dedispersed, trimmed cells bit for bit; scale and smooth rtol 1e-4 /
   atol 1e-5), the whole chain rtol 1e-4 / atol 1e-4, and the summed
   series peaking within 24 samples of the pulse. (b) The first 60 s of
   phase 4's file (937,500 samples, 0.96 GB): ``cli.zero_dm_filter`` on
   the card (GB/s read + written), its header the input's and its first
   2^18 samples the bytes of the CPU port's but for float64-proven ties;
   ``cli.sweep --write-dats`` at DM 70 on the output; ``cli.spectrogram
   -t 1`` of the ``.dat``: the CLI's spectra ``get_spectra``'s, card
   against CPU within rtol 2e-4 of each bin plus 2e-4 of its block's
   mean power, and in every block the bins of the first 32 harmonics of
   3.8147 Hz at least 4x what as many noise bins hold; ``detrend_blocks``
   of the ``.dat`` in 1-s blocks (cells 6 sigma out omitted), card
   against CPU within 1e-4 of each block's largest |y|, the kept cells
   averaging 0. One ``path NAME:`` line each.
14. The standalone acceleration search at ``BASELINE.json`` configs[4]'s
   length. Four 1-hour ``.dat`` files (56,250,000 samples of 64 us, 225
   MB each, numpy from a seed in chunks): three carry 8 harmonics of an
   11.1 Hz signal drifting 20 bins over the hour at three amplitudes,
   one is noise. Each run at ``-z 200 --dz 2 -n 8``: (a)
   ``cli.accelsearch --batch 4`` (device prep) on the four: in each
   signal file a candidate at a harmonic within 1 bin, the fundamental's
   drift within 2 bins, sigma > 10, and the noise file's best sigma
   under 8; the first series' card prep against a float64 transform
   (2e-5 of the largest magnitude) and the CPU's (printed, with the
   spectrum, bin and each side's value beside float64's when past
   2e-5); (b) ``--batch 2 --no-device-prep`` on two, held to (a) under
   the matched-candidate contract; (c) ``--batch 1`` (host prep) on one,
   its ``.cand`` and ``.txtcand`` the bytes of (b)'s; (d)
   ``cli.plot_accelcands --no-plot -o accelcands.npz`` over the four
   ``.inf`` files. (e) At 2^20 samples, on the card and on the CPU and
   held to each other under the contract: ``.fft`` input, ``--zapfile``
   (one harmonic blanked), ``--coarse-dz 4`` (``-z 20 -n 4``) and the
   jerk search ``-z 10 -n 2 -w 40 --dw 20``. (f) Phase 6's sweep stage
   with ``--no-accel-device-prep``: the DM-70 harmonic found, every
   trial's candidates held to phase 6's under the contract, both
   gather-sum stages and boxcar launched. (g) ``cli.dissect`` (constant
   period, and ``--use-parfile`` with ``--toas``), ``cli.sum_profs`` and
   ``cli.pulses_to_toa`` on phase 6's DM-70 ``.dat``: the ``--use-parfile``
   TOAs' phases within 0.05 of the pulse's (plus the DM delay to
   mid-band) and spread under 0.05 (the JAX package's test bound), and
   pulses_to_toa's TOAs spread under 0.05. The serial-fallback counter
   must be 0 after every run. One ``path NAME:`` line each; the cut:
   4096 DM trials -> 7 spectra of 1 h.
15. Kill and resume, and the per-chunk single-pulse events. Each kill is
   a child run of the CLI (``KILL_RUNNER``, by ``python -c``) that
   SIGKILLs itself at a set point; each resume runs in this process with
   the counts set to 0. (a) ``cli.sweep --all-events`` over phase 4's
   1024 trials (64 chunks of 16384): uninterrupted with ``--checkpoint
   --checkpoint-every 4`` (each save timed), killed right after its 3rd
   save, then ``--resume``: the checkpoint's cursor after 12 chunks, the
   resumed ``.cands``, ``.events`` and ``.pulses`` the uninterrupted
   bytes, no chunk before the cursor accumulated, each sweep kernel
   launched for the 52 chunks after it only (the uninterrupted launches
   a chunk), the bytes shipped those chunks' blocks (at most one overlap
   more), and the events of DM 70's trial group (8 trials) held to the
   CPU port's per-chunk peaks on the same blocks (matched by DM, width
   and chunk; SNR within 2e-6 relative plus half the print's last digit;
   a differing sample must hold the same integer window sum). (b)
   ``--ddplan --lodm 0 --hidm 512 --chunk 65536``: uninterrupted; with
   ``--checkpoint --checkpoint-every 1`` killed right after step 0's done
   marker, then with ``--resume`` killed after step 1's first save, then
   resumed: the uninterrupted ``.cands`` bytes, step 0 not swept (no
   launch), step 1's launches only after its cursor, every later step's
   the uninterrupted ones, no checkpoint or marker left. (c)
   ``cli.foldbatch --journal`` on phase 7's sifted list (``--datbase``,
   batch 32) killed at its 3rd fold group, then run again: the
   polynomial fold launched once for each group left, every archive the
   bytes of phase 7's, every summary row's refined values phase 7's; a
   third run launches no fold. One ``path NAME:`` line each.
16. Telemetry and fault injection, reusing phase 6's, 7's, 8's and 10's
   outputs as the un-traced, un-faulted baselines. (a) Phase 6's sweep
   stage run again untraced and with ``--telemetry``, back to back (one
   pair: phase 22's time came from a second): the same kernel
   launches, and every ``.dat``,
   ``.cand``, ``.txtcand`` and the ``.cands`` the bytes of phase 6's; the trace opens with a
   version-1 meta record and ends with an end record, its ``h2d.bytes``
   equal the bytes the ship copied, its session-end device record's
   ``peak_bytes_in_use`` equals ``torch.cuda.max_memory_allocated()``;
   printed: each wall (the overhead: the traced run's over the
   untraced run's; and a bound on it, the host cost of a record timed
   over 4000 records times the trace's records), the trace's bytes and
   records, the seconds of
   every span name, ``d2h.bytes``, the pending-depth maxima and
   ``tlmsum``'s stage table. (b) The stage with ``--fault-inject
   oom:accel.batch_dispatch:1``: fired once, one OOM backoff, no serial
   fallback, phase 6's bytes. (c) ``foldbatch --telemetry --fault-inject
   oom:fold.batch_dispatch:N`` on phase 7's list (N: the first DM group
   of more than one candidate): fired once, one backoff, every archive
   the bytes of phase 7's. (d) The stage with ``--journal --accel-batch
   4 --fault-inject exit:accel.after_cand_write:3`` in a child, which
   must exit 137 after its third table with the fault's event in its
   trace; resumed here: phase 6's bytes, no boxcar launch (the
   single-pulse pass skipped) and the series pass's launches as in phase
   6. (e) ``prepfold --telemetry`` at phase 10's defaults (phase 10's
   launches and ``.pfd`` bytes, one ``fold_bins`` span a launch) and
   ``rfifind --telemetry`` on phase 8's RFI copy (the chain's ``.mask``
   bytes, ``rfifind.intervals`` and ``rfifind_block_stats`` in its
   trace). One ``path NAME:`` line each.
17. The sweep's last single-device formulations and the tool dispatcher,
   reusing phase 4's result and phase 6's and 7's outputs. (a)
   ``sweep.sweep_resident`` of phase 4's file held on the card ([1024,
   2^20] float32) at phase 4's grid (1024 trials, 64 subbands, group 8)
   in 4 chunks of 2^18, against ``sweep.sweep_spectra`` of the same
   tensor at the same chunking, after a warm-up call of each, run
   streamed, resident, resident, streamed: ``snr``, ``peak_sample``,
   ``mean`` and ``std`` bit for bit,
   the same launches (a whole number a chunk), the pulsar at DM 70;
   printed: walls, DM-trials/s, peak GB.
   (b) ``cli.sweep --engine scan`` on phase 4's grid: phase 4's rows and
   ``.cands`` bit for bit (the CPU test found the scan's sum order the
   gather kernel's) and its launches. (c) Phase 9's DDplan 0-512 with
   ``host_downsample=True`` and with the default card sums, alternately:
   every step's rows and launches and the ``.cands`` the same; host sums
   on exactly the downsampled steps, each shipping 2 / downsamp of the
   device path's bytes (within 5%), the downsamp-1 step the same bytes;
   printed: each step's wall both ways. Then at ``--chunk 65536`` the
   plan with card sums uninterrupted, and with host sums and
   ``--checkpoint --checkpoint-every 1`` in a child killed right after
   the downsamp-4 step's first save, resumed here: only that step swept,
   from host blocks re-rooted at its cursor, the uninterrupted
   ``.cands`` bytes, no checkpoint or marker left. (d) ``python -m
   pypulsar_tpu_torch.cli``: ``sift --known-sources`` (a catalog naming
   the pulsar, P 0.262144 s, DM 70) over phase 6's tables, ``pfd_snr
   --tsys 30 --gain 10 --haslam-map`` (a map written by
   ``skytemp.write_healpix_map``) and ``pfd_snr -m`` (a von Mises model)
   over phase 7's archives at DM 70, the three processes and the
   unknown tool's side by side: each the bytes of the
   tool's own ``main`` run here, the pulsar's rows (and only they)
   vetoed from phase 7's list, finite SNRs and a mean flux; an unknown
   tool exits 2 with a hint. One ``path NAME:`` line each.
18. The survey fleet: ``python -m pypulsar_tpu_torch.cli survey`` (its
   dispatcher's ``main``, in this process) over three full-width files,
   phase 8's RFI copy, phase 11's second file (DM 62, period 2048) and
   phase 4's clean file, at ``SurveyConfig(**CHAIN_CFG)``'s flags with
   ``--devices 1 --max-host-workers 2``, the broker at its default
   window. First the clean file's serial ``run_observation`` (phases 8
   and 11 give the other two). (a) The fleet, traced
   (``--telemetry-dir``): every artifact of each observation the bytes
   of its serial chain (``_snr.json`` apart from the archives'
   directory), each pulsar folded to SNR > 10, every manifest with its
   five stages done and no quarantine, no device evicted
   (``_fleet_health.json``), the candidate store holding a DM-70 row of
   the pulsar (its period or a harmonic) at SNR > 10, the warm pool's
   ``survey.precompile`` spans in the trace and its
   ``survey.precompiled`` counter at 1 or more (printed: each warmed
   observation's warmers' walls and each observation's first sweep chunk
   dispatch, warmed or not), which ``cands
   --near`` lists, both gather-sum stages, boxcar and a fold form
   launched; printed: the fleet's wall against the sum of the three
   serial chains, each stage's wall from the trace, the device lane's
   busy and idle time between its first and last device stage, the
   broker's counters, peak device memory. (b) ``--resume`` of the
   finished fleet: "0 stages run, 15 skipped", no launch, the archives'
   bytes unchanged. (c) The fleet in a child with ``--fault-inject
   exit:survey.stage_done.sweep:1`` (exit 137 right after the sweep's
   artifacts, before its manifest record), on the first file, then
   ``--resume`` here: exactly the stages the manifest did not record
   run, every artifact the serial chain's bytes. (d) ``--devices 2`` on
   the one card (two device stages in flight) over the first two files,
   traced as (a) is: the same bytes; its wall against their serial
   chains and its peak memory. (c) and (d) ran on two and three files
   before PR 18. (e) A batch lane of the fleet: (a)'s first two observations
   cut back to their sifts (the manifests lose the fold and snr
   records, those artifacts are removed), then resumed through
   ``FleetScheduler(..., resume=True)`` with the broker's window at
   phase 11's ``LANE_WAIT_MS``: both folds queue at once, so the lease
   runs them as one lane; gates: 4 stages run, 6 skipped, a lane, fused
   dispatches, ``fold_parts_multi_poly`` launched, every artifact the
   serial chains' bytes. (f) The flight
   recorder's cost to an untraced run: phase 6's stage with the ring
   off (``flightrec.configure(0)``) and on (the default ring), the same
   bytes, the ring records the stage wrote, and one session-off span
   and event with the ring off and on in alternating pairs. (g) A
   strike and a watchdog interrupt on the card: the second observation
   cut back to its sift and resumed with ``stall_s=3``, ``retries=2``
   and ``FLEET_FAULTS`` armed (an OOM at the fold's start, then a hang
   at the retry's second fold dispatch): one strike on card 0 (its
   cache emptied), no eviction, one stall interrupt (the card
   synchronized, the fold's outputs scrubbed), two retries, every
   artifact the serial chain's bytes. One ``path NAME:`` line each.
19. The multi-host fleet, the streaming daemon and the handoff's serial
   fallback, on phase 18's files and serial chains. (a)
   ``survey F1 F2 --hosts 2 --host-lease 6`` with phase 18's flags,
   traced: two host processes share the card; exit 0, every stage run
   once (10 done records, each with a fencing token), every artifact the
   serial chains' bytes, ``--status`` showing both hosts LEFT and an
   owner for each observation, ``--resume`` with the same flags (two
   hosts again, traced apart) running 0 stages and launching nothing on
   either host, ``tlmtrace --check`` over both hosts' traces
   passing; the wall against the serial sum. (b) Two hosts started here,
   ``--host-id host0`` and ``host1`` on the first two files, building
   the kernels into one fresh directory at once, started together (the
   build lock: one compiles, the other waits): host0
   armed with ``hang:survey.stage_start.fold:1`` (30 s, past the 6-s
   lease) is SIGKILLed once its flushed trace shows the fault; host1
   must log the adoption from the silent host, skip the three stages
   host0 recorded, run the rest with the serial chains' bytes, and the
   stitched trace must pass ``--check`` despite host0's torn tail; the
   host that built the kernels (its log says so) must count
   ``compile.cache_miss`` and no ``compile.persistent_hit`` in its trace,
   the host that waited ``compile.persistent_hit`` and no
   ``compile.cache_miss``; the time from the kill to the adoption. (c)
   ``survey --daemon --watch W
   --daemon-port 0 --status-port 0`` with two ``--tenant`` specs and
   ``--daemon-idle-exit``: the RFI file copied into W (teamA), the
   second file submitted on the socket (teamB), ``/status.json`` polled
   until both are done, ``/metrics`` carrying the ``survey.*``
   counters, ``/candidates`` near P 0.262144 s (or a harmonic) and DM 70
   returning the pulsar; SIGTERM drains it (exit 0), the artifacts have
   the serial bytes, and a restart on the directory replays the journal
   and runs 0 stages. (d) Phase 6's 32-trial stage in-process at
   ``--accel-batch 8`` with the second batch's dispatch raising a
   ``ValueError`` once (a patch of this script's): one serial fallback,
   every trial's ``.cand``/``.txtcand`` the bytes of phase 6's, the
   failed batch's trials too (searched one by one on the card, each
   prepped on the card as its batch was), and those also under the
   matched-candidate contract against phase 6's.
   The children's kernel launches are read from their traces
   (``kernel_launches.*`` counters); every child trace and every
   in-process phase before (d) must show no serial fallback. One
   ``path NAME:`` line each.

20. Several logical devices on the one card (meshes whose devices name
   it several times, and two processes sharing it), reusing phase 4's
   result, phase 6's outputs and phase 18's serial chain. (a)
   ``sweep.sweep_resident`` of phase 17's tensor (1024 trials, group 8,
   chunks of 2^18) over a 'dm' mesh of k = 1, 2 and 4 positions with
   ``pad_groups_to`` past the groups: ``snr``, ``peak_sample``, ``mean``
   and ``std`` bit for bit the single-device rows; the whole tensor as
   one chunk over a 2 x 2 'dm' x 'time' mesh (each time shard half the
   series, its halo a card-to-card copy) against ``sweep_spectra`` at a
   payload of half the series: peaks bit for bit, SNR within 2e-6
   relative; the tree engine at k = 2 bit for bit the single-device tree.
   (b) Phase 6's 32-trial stage as ``sweep --mesh 2`` in-process under
   ``device_lease`` of the card twice: every ``.cand``, ``.txtcand``,
   ``.dat`` and the ``.cands`` phase 6's bytes. (c) Two ranks on the card
   over gloo, each a child ``sweep --time-shard --coordinator
   127.0.0.1:PORT --num-processes 2 --process-id R`` of phase 4's grid on
   phase 4's file: both ranks' rows against phase 4's (peaks bit for
   bit, SNR within 2e-6); printed: each rank's wall and ``h2d.bytes``
   beside phase 4's. (d) ``survey --devices 2 --gang 2`` over phase 18's
   clean file: every artifact the serial chain's bytes, the sweep's
   ``survey.gang_decision`` k = 2 in the trace. One ``path NAME:`` line
   each.

21. Auto-tuning. (a) ``python -m pypulsar_tpu_torch.cli tune --search``
   in-process through the dispatcher, into a cache file in the temporary
   directory: the sweep stage at 64 channels, 2^16 samples, 32 DMs, and
   the accel stage at 2^14 samples, zmax 20, 2 harmonics, 4 trials each
   (``--trials 4``), measured on the card; each must store its entry and
   the sweep measure must launch both gather-sum stages. One ``path
   tune_search:`` line (trials, ``baseline_s``, ``best_s`` and the winner
   of each stage). (b) A cache whose entries differ from the defaults at
   phase 3's small file (accel: batch 16 and ``hbm_budget_bytes`` 2e9;
   sweep: ``chunk_fft_len`` 2^16), then ``sweep --accel-search
   --write-dats`` of that file over 32 trials (zmax 20, 2 harmonics) with
   ``--tune off`` and with ``--tune cache`` at that file: the accel
   dispatches (``accel.stream_batches``) must be 1 and 2, the series
   pass's chunks (``dedisperse.chunks``) 1 and 2, and every output file
   (``.dat``, ``.inf``, ``.cand``, ``.txtcand``, ``.cands``) the same
   bytes. The same pair again with ``--mask`` (channels 3 and 4 and one
   interval's channel 9 zapped): a mask fills zapped cells with each
   chunk's statistic, so the stored chunk must not be consulted (1 and 1
   chunks, one cache hit), the batch still moves (1 and 2 dispatches) and
   every file keeps its bytes. One ``path tune_consult:`` line.

22. Chaos mode, lockdep's race mode and the reader fuzz, on two copies of
   phase 3's small file. (a) ``survey`` of both (in this process, its
   dispatcher's ``main``) at ``CHAOS_FLAGS``, unfaulted; then the same
   fleet into another directory with ``--fault-chaos CHAOS_SPEC`` (a
   seeded spray of OOMs, IO errors and device faults over every fault
   point) and ``--fault-inject kill:survey.stage_done.sweep:1``,
   resumed with ``--resume --fault-chaos CHAOS_SPEC`` until a round
   finishes with no observation quarantined, at most 15 rounds (the
   reference's ``tests/test_survey.py`` recipe): the kill must fire, at
   least one chaos fault must fire, every artifact must have the bytes of
   the unfaulted fleet, and a final ``--resume`` without chaos must run
   0 stages and launch nothing; printed: the rounds and
   ``fired_counts()``. (b) Race mode (``locks.configure_race``) armed
   through (a): ``race_pauses()`` above 0. (c) ``run_reader_fuzz`` of
   the ``filterbank``, ``psrfits`` (spectra read onto the card) and
   ``dat`` readers, 60 mutations each at seed 11: no failure. One ``path
   NAME:`` line each.

23. The data-file tools and psrlint (``PALFA_*`` constants; ~15-25 s).
   (a) ``autozap`` at a PALFA beam's width: six ``.fft`` files of 2^22
   samples at 64 us (268 s, 2^21 + 1 bins each, the port's
   ``write_fft``) of noise, a persistent 60-Hz tone and its harmonic,
   one file also a pulsar (P 73.1 ms, 5% duty). ``autozap --device cuda``
   and ``--device cpu`` (in this process): both zaplists must hold both
   tones, and the masks may differ only at bins whose last honing put
   them within 1e-6 (relative) of their block's threshold (both detrend
   in float64; the count is printed). Then ``accelsearch -z 20 --dz 2
   -n 4`` of the pulsar's file on the card, without and with the card's
   zaplist: the tones' candidates (within 0.05 Hz of 60 or 120 Hz) must
   be there without it and gone with it, and the pulsar's (a harmonic of
   13.68 Hz, sigma > 6) must stay. (b) The host tools on phase 3's small
   file and phases 6, 7 and 14's outputs: ``combinefil`` of its two
   channel halves (the data the source's), ``stitchdat`` of two halves
   of phase 6's DM-70 ``.dat`` 1000 samples apart (the series the
   original's and the first half's median between), ``mockspecfil2
   subbands`` (each ``.sub`` its channel), ``demodulate`` of a 2^20-
   sample ``.dat`` at 2 ms with a BT binary's ``.par`` (PB 0.02 d, A1 2
   lt-s: samples dropped and added, an even length), ``pfdinfo`` of a
   phase-7 ``.pfd`` (its attributes the ``PfdFile``'s),
   ``pulse_energy_distribution -o X.npz`` over phase 14's pulse files
   and ``coordconv`` through ``python -m pypulsar_tpu_torch.cli``
   (b > 89 deg at the galactic pole). (c) ``python -m
   pypulsar_tpu_torch.cli psrlint --json`` on the checkout (started in a
   child at the phase's start, beside (a) and (b)): exit 0, no finding;
   and on a temporary tree with one planted violation of each of the 17
   rules and a stale suppression: exit 1, each rule named. One ``path
   NAME:`` line each: ``autozap``, ``s27_tools``, ``psrlint``.
24. The last host slice (~2-10 s). (a) Phase 3's file swept at 16 trials
   inside ``utils/profiling.trace`` (a ``torch.profiler`` session with
   the card's activity) in a fresh child started before phase 23: the
   results' bytes an untraced run's here, the Chrome trace written under
   the trace directory naming the gather-sum and boxcar kernels
   (launches from the child's wrapper counters). (b)
   ``cli/zero_dm_filter.filter`` of a uint8 [time, chan] block of that
   file on the card against ``device="cpu"`` (``unproven_differences``,
   phase 13's test). (c) ``massfunc``, ``pbdot`` and ``shapiro`` at fixed
   arguments, ``fitkepler`` recovering a known orbit from a text file,
   ``gridding`` recovering a pulsar's position from ``.pfd``s made by
   ``make_pfd`` at several offsets, ``pyppdot`` on the bundled catalog
   and ``pyplotres`` on a ``resid2.tmp`` of ``write_residuals``, all in
   process through the dispatcher, each plotting tool with ``-o X.npz``.
   (d) ``io/datafile.autogen_dataobj`` on a PSRFITS file named as a Mock
   spectrometer beam. (e) Whether the machine has ``pycparser``; with it
   a WAPP file's header and lags are read back. One ``path
   s27b_traced_sweep:`` line and one ``path s27b:`` line with each
   step's wall.
25. The host codec and its ``pread`` ring (~5-15 s). (a) Each of the
   seven loops of ``pypulsar_tpu_torch/native`` (built in phase 1 by
   ``g++``) against its NumPy twin at a PSRFITS subint's size (4096
   spectra x 1024 channels; packed 4/2/1-bit, uint8, uint16, float32):
   bit for bit, but ``zero_dm`` (atol 2e-4) and ``boxcar_peak_snr``
   (rtol 1e-5); each one's wall and GB/s. (b) Phase 4's ingest alone:
   ``ship_ahead(iter_blocks(payload, overlap, raw=True, prefetch=p))`` of
   phase 4's file to the card at phase 4's geometry, no kernel, the ring
   on and off twice each (on, off, on, off): walls, GB/s, the host's
   RSS while blocks arrive, and each device block's digest, equal in the
   four passes; the bytes shipped are phase 4's; phase 4's sweep wall
   (over the ring) beside them. (c) A consumer stopped after one block,
   and a truncated copy that raises ``DataFormatError``: the process's
   thread count (``/proc/self/task``) comes back each time. One ``path
   native_ingest:`` line.

Then a line of the script's slowest functions (``function walls s:``,
each function's calls and inclusive wall, the 40 longest), a line of each
phase's wall (``phase walls s:``, the script's time budget), one JSON line of per-kernel numbers (each with its launches on every
driven path, phase 10's ``archive_fold``, ``prepfold``, ``prepfold_par``
and ``prepfold_cands``, phase 11's ``lane``, phase 12's
``psrfits_ddplan``, ``psrfits_flat4``, ``psrfits_chain``, ``float32_fil``
and ``mask_split`` and phase 13's ``waterfaller_nsub_mask``,
``waterfaller_plain``, ``zero_dm_filter``, ``zero_dm_sweep``,
``spectrogram`` and ``detrend_blocks``, phase 15's
``checkpoint_resume``, ``ddplan_resume`` and ``fold_resume``, and phase
16's ``telemetry_stage``, ``fault_accel_oom``, ``fault_fold_oom``,
``fault_exit_resume`` and ``prepfold_traced``, and phase 17's
``sweep_resident``, ``sweep_scan``, ``ddplan_host_ds``,
``ddplan_device_ds`` and ``ddplan_host_ds_resume``, and phase 18's
``survey_fleet``, ``survey_fleet_resume``, ``survey_fleet_2leases``,
``survey_fleet_lanes``, ``stage_ring_on`` and ``survey_fleet_faults``,
and phase 19's ``survey_hosts``, ``survey_adopt``, ``survey_daemon``
and ``accel_serial_fallback``, and phase 20's ``mesh_resident_k1``,
``mesh_resident_k2``, ``mesh_resident_k4``, ``mesh_2d``,
``mesh_tree_k2``, ``mesh_stage``, ``time_shard_r0``, ``time_shard_r1``
and ``survey_gang``, phase 3's ``write_dats_plain`` and
``write_dats_streamed`` and phase 21's ``tune_search``, ``tune_off``,
``tune_cache``, ``tune_masked_off`` and ``tune_masked_cache``, phase
22's ``chaos_clean`` and ``chaos_fleet`` and phase 23's ``autozap`` and
``s27_tools`` and phase 24's ``s27b_traced_sweep`` among them), the
card line,
and the last line ``{"ok": true, "device":
{...}}``.
"""

import collections
import concurrent.futures
import contextlib
import functools
import glob
import hashlib
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM float64 outside the tensor cores: the data sheet's 34 TFLOP/s
# counts a fused multiply-add as two; the fold's bins take separate
# multiplies, adds and conversions, one instruction each
FP64_OPS_PER_S = 17e12
SEED = 20261016
#: phase 4's numbers that phase 20 reads (the bytes it shipped)
PHASE4 = {}
REPS = 10


#: the child processes of phases 1-20 consult no tuning cache
UNTUNED = ["--tune", "off"]


def untuned(tmp) -> None:
    """Phases 1-20 run at the defaults, whatever cache the machine holds:
    the entry points of this process consult an empty cache in ``tmp``
    (their children get :data:`UNTUNED`); phase 21 names its caches."""
    from pypulsar_tpu_torch.tune import cache

    path = os.path.join(tmp, "untuned", "tune.json")
    cache.default_cache_path = lambda: path


#: each function of this script: [calls, inclusive wall s]
FUNCTION_WALLS = collections.defaultdict(lambda: [0, 0.0])


def _walled(name, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            rec = FUNCTION_WALLS[name]
            rec[0] += 1
            rec[1] += time.perf_counter() - t0

    return wrapper


def wall_functions() -> None:
    """Count the calls and inclusive wall of every function of this
    script (:data:`FUNCTION_WALLS`), for the ``function walls s:`` line
    that budgets its time."""
    g = globals()
    for name, fn in list(g.items()):
        if callable(fn) and getattr(fn, "__module__", None) == __name__ \
                and not isinstance(fn, type) and name not in (
                    "main", "fail", "wall_functions", "_walled"):
            g[name] = _walled(name, fn)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = REPS, warmup: int = 1) -> float:
    """Device ms per call of ``fn()``: CUDA events around ``reps`` calls
    run back to back after a warm-up, so the host's work in a wrapper
    overlaps the device's and is not counted as device time."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def single_call_ms(fn, reps: int = REPS, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn()`` each,
    after a warm-up: the first port's timer, kept to compare with it."""
    import torch

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
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, reps: int = REPS) -> float:
    """Device ms per call of ``fn()``: CUDA events around ``reps`` replays
    of a CUDA graph of one call, so no host work (Python, argument checks,
    allocation) stands between the launches. Where a call's host work
    outlasts its kernels, ``cuda_time_ms`` measures the host; this does
    not."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak rate for their type (float32 unless
    ``ops_per_s`` says otherwise)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def path_geometry(device):
    """The plan, chunk geometry and first trial-group batch the main path
    builds for the 1024-channel, 1024-trial sweep below."""
    import numpy as np

    from pypulsar_tpu_torch.parallel import sweep

    C, tsamp = 1024, 64e-6
    freqs = 1500.0 + (-300.0 / C) * np.arange(C)
    dms = 0.5 * np.arange(1024)
    g = sweep.choose_group_size(dms, freqs, tsamp, 64)
    plan = sweep.make_sweep_plan(dms, freqs, tsamp, nsub=64, group_size=g)
    payload = sweep.default_chunk_payload(plan.min_overlap)
    out_len = payload + max(plan.widths)
    L1 = out_len + plan.max_shift2
    batches = sweep.group_batches(plan.stage1_bins, plan.stage2_bins, 64, L1,
                                  device)
    return plan, payload, out_len, L1, batches


def check_gather_exact(what, src, tables, n):
    """One gather-sum launch against the plain version: equal bits."""
    import torch

    from pypulsar_tpu_torch.ops import gather_sum as gs

    got = gs.shifted_gather_sum(src, tables, n)
    want = gs._torch_gather_sum(src, tables, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"gather_sum {what} disagrees with its plain version "
             f"(max abs err {err})")
    return got, err


def check_gather_stage(stage, src, tables, n, report):
    """One stage of the path against the plain version, then timed."""
    from pypulsar_tpu_torch.ops import gather_sum as gs

    got, err = check_gather_exact(stage, src, tables, n)
    B, J, K = tables.shifts.shape
    R, L = src.shape
    jb, e, threads, win, _ = gs.launch_config(J, K, tables.bounds.spreads)
    ms = cuda_time_ms(lambda: gs.shifted_gather_sum(src, tables, n))
    single_ms = single_call_ms(lambda: gs.shifted_gather_sum(src, tables, n))
    plain_ms = cuda_time_ms(lambda: gs._torch_gather_sum(src, tables, n))
    nbytes = 4.0 * R * L + 4.0 * (B * K + B * J * K + B * J) + 4.0 * B * J * n
    bms, by = bound(nbytes, float(B) * J * K * n)
    report.append(dict(
        name=f"gather_sum/{stage}", route="cuda",
        source="pypulsar_tpu_torch/ops/csrc/gather_sum.cu",
        replaces="pypulsar_tpu/ops/pallas_dedisperse.py:107",
        shape=f"data [{R}, {L}], src_rows [{B}, {K}], shifts [{B}, {J}, "
              f"{K}], out_len {n}; {jb} rows x {e} samples per thread, "
              f"{threads} threads, window {win}",
        max_abs_err=err, ms=ms, single_call_ms=single_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))
    print(f"gather_sum {stage}: [{R}x{L}] -> [{B * J}x{n}], B={B} J={J} "
          f"K={K} (JB={jb}, E={e}, window {win}): kernel {ms:.3f} ms "
          f"(single calls {single_ms:.3f} ms), plain "
          f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB), max abs err {err:.3g}")
    return got


def check_gather(device, report):
    """Both stages of the first trial-group batch of the path on random
    channels; returns the dedispersed series and the chunk payload."""
    import torch

    plan, payload, out_len, L1, batches = path_geometry(device)
    b = batches[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    data = torch.randn((1024, L1 + plan.max_shift1), generator=gen,
                       device=device)
    sub = check_gather_stage("stage1", data, b.stage1, L1, report)
    del data
    ts = check_gather_stage("stage2", sub, b.stage2, out_len, report)
    return ts, payload


def check_gather_edges(device):
    """Gather-sum shapes the path does not give it, against the plain
    version; tables past shared memory must raise before launching."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import gather_sum as gs

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    R, L = 48, 70001  # odd: row r of the tensor starts r floats past 16 bytes
    data = torch.randn((R, L), generator=gen, device=device)
    cases = [  # (what, B, J, K, out_len, shift spread)
        ("ragged tile", 3, 16, 8, 5037, 40),
        ("J=20 (16 rows per block)", 2, 20, 16, 4100, 30),
        ("J=12", 2, 12, 5, 3000, 30),
        ("K=1", 4, 9, 1, 2049, 10),
        ("J=5 (8 rows per block)", 3, 5, 24, 3100, 50),
        ("J=1 generic form", 6, 1, 32, 1000, 5000),
        ("spread 2000", 2, 64, 16, 6000, 2000),
    ]
    done = []
    for what, B, J, K, n, spread in cases:
        base = rng.integers(0, L - n - spread, size=(B, 1, K))
        shifts = base + rng.integers(0, spread + 1, size=(B, J, K))
        tables = gs.gather_tables(
            rng.integers(0, R, size=(B, K)), shifts,
            rng.permutation(B * J).reshape(B, J), device, "edge")
        check_gather_exact(what, data, tables, n)
        done.append(f"{what}: JB={gs.launch_config(J, K, tables.bounds.spreads)[0]}")
    # the halves of a set 15000 samples apart: too wide for 16 rows per
    # block, the wrapper narrows to 8; rows 60000 apart in turn: to one row
    # per block, whose window has no spread
    for what, far in (("spread 15000", np.repeat([0, 15000], 8)),
                      ("spread 60000", np.tile([0, 60000], 8))):
        shifts = np.repeat(far[None, :, None], 4, axis=2)
        tables = gs.gather_tables(rng.integers(0, R, size=(1, 4)), shifts,
                                  np.arange(16)[None, :], device, "edge")
        check_gather_exact(what, data, tables, 5000)
        done.append(f"{what}: JB="
                    f"{gs.launch_config(16, 4, tables.bounds.spreads)[0]}")
    # views of data[lead:] start lead floats past a 16-byte boundary; the
    # windows of their first row start at 0 and of their last row end at L
    for lead in (1, 2, 3):
        n, rv = 3000, R - lead
        src = rng.integers(0, rv, size=(2, 6))
        src[0, 0], src[1, -1] = 0, rv - 1
        shifts = (rng.integers(0, L - n - 30, size=(2, 1, 6))
                  + rng.integers(0, 31, size=(2, 12, 6)))
        shifts[0, :, 0] = np.arange(12) % 3
        shifts[1, :, -1] = L - n - np.arange(12) % 3
        tables = gs.gather_tables(src, shifts,
                                  rng.permutation(24).reshape(2, 12), device,
                                  "edge")
        check_gather_exact(f"view at +{lead}", data[lead:], tables, n)
        done.append(f"view at +{lead} floats: JB="
                    f"{gs.launch_config(12, 6, tables.bounds.spreads)[0]}")
    # 15000 source rows: their offsets alone pass shared memory
    tables = gs.gather_tables(np.zeros((1, 15000)), np.zeros((1, 1, 15000)),
                              np.zeros((1, 1)), device, "edge")
    try:
        gs.shifted_gather_sum(data, tables, 100)
    except ValueError as e:
        done.append(f"K=15000 refused ({e})")
    else:
        fail("gather_sum launched a block past shared memory")
    print("gather_sum edge cases equal the plain version: " + "; ".join(done))


def compare_boxcar(what, ts, widths, stat_len):
    """The kernel against the plain version on one input; returns
    (max abs err of the maxima, argbox cells that differ)."""
    import torch

    from pypulsar_tpu_torch.ops import boxcar_stats as bx

    got = bx.boxcar_stats(ts, widths, stat_len)
    want = bx._torch_boxcar_stats(ts, widths, stat_len)
    torch.cuda.synchronize()
    s, ss, mb, ab = got
    ws, wss, wmb, wab = want
    # a sum of zero-mean samples cancels: its tolerance scales with the
    # root of the sum of squares, the size of its terms' rounding
    scale = 1e-5 * wss.sqrt()
    if not ((s - ws).abs() <= 1e-5 * ws.abs() + scale).all():
        fail(f"boxcar_stats {what}: payload sums disagree with the plain "
             f"version")
    for name, g, w in (("sumsq", ss, wss), ("maxbox", mb, wmb)):
        if not torch.allclose(g, w, rtol=1e-5, atol=0.0):
            fail(f"boxcar_stats {what}: {name} disagrees with the plain "
                 f"version (max rel err "
                 f"{float(((g - w) / w).abs().max()):.3g})")
    # a different start is right only where it holds the maximum too
    cs = torch.cat([torch.zeros((ts.shape[0], 1), dtype=torch.float64,
                                device=ts.device),
                    torch.cumsum(ts.double(), dim=1)], dim=1)
    for k, w in enumerate(widths):
        a = ab[:, k].long()
        at = cs.gather(1, (a + w)[:, None])[:, 0] - cs.gather(1, a[:, None])[:, 0]
        near = (at - wmb[:, k].double()).abs() <= 1e-5 * wmb[:, k].double().abs()
        if not bool(((ab[:, k] == wab[:, k]) | near).all()):
            fail(f"boxcar_stats {what}: width {w} starts hold no maximum")
    return float((mb - wmb).abs().max()), int((ab != wab).sum())


def check_boxcar(device, report, ts_in, stat_len):
    import torch

    from pypulsar_tpu_torch.ops import boxcar_stats as bx

    widths = (1, 2, 4, 8, 16, 32)
    ts = ts_in.contiguous()
    err, n_diff = compare_boxcar("path", ts, widths, stat_len)
    # ties: constant rows tie everywhere, two equal pulses keep the first
    tie = torch.ones((4, 5000), device=device)
    tie[1:] = 0.0
    tie[1:, 3000:3004] = 5.0
    tie[1:, 700:704] = 5.0
    tg = bx.boxcar_stats(tie, widths, 4096)
    tw = bx._torch_boxcar_stats(tie, widths, 4096)
    if not (torch.equal(tg[3], tw[3]) and int(tg[3][0].max()) == 0
            and int(tg[3][1, 0]) == 700):
        fail(f"boxcar_stats: tie rule broken: {tg[3].tolist()}")
    # widths neither sorted nor powers of two, widths past the 256 threads
    # of a block (a level's halo takes several passes), more than 8 widths
    # (the kernel's second register layout), payloads off a stretch
    # boundary; then views of edge[lead:], whose rows start lead floats
    # past a 16-byte boundary (T is odd), with windows to the end of the
    # last row
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    T_edge = 60001
    edge = torch.randn((37, T_edge), generator=gen, device=device)
    edge[5, 33333:33340] += 40.0
    edges = []
    cases = [(0, (100, 3, 7, 5), 40001), (0, (300, 7, 1000), 50003),
             (0, (1, 2, 3, 5, 8, 13, 21, 34, 55, 89), 50003),
             (0, widths, 16385)]
    cases += [(lead, widths, T_edge - 32) for lead in (1, 2, 3)]
    for lead, w, n in cases:
        what = f"edge[{lead}:] widths {w} stat_len {n}"
        e_err, e_diff = compare_boxcar(what, edge[lead:], w, n)
        edges.append(f"{what}: max abs err {e_err:.3g}, {e_diff} argbox "
                     f"cells differ")
    ms = cuda_time_ms(lambda: bx.boxcar_stats(ts, widths, stat_len))
    single_ms = single_call_ms(lambda: bx.boxcar_stats(ts, widths, stat_len))
    plain_ms = cuda_time_ms(lambda: bx._torch_boxcar_stats(ts, widths,
                                                           stat_len))
    D, T = ts.shape
    W = len(widths)
    nbytes = 4.0 * D * T + D * (8.0 + 8.0 * W)
    bms, by = bound(nbytes, float(D) * stat_len * (2 + 2 * W))
    report.append(dict(
        name="boxcar_stats", route="cuda",
        source="pypulsar_tpu_torch/ops/csrc/boxcar_stats.cu",
        replaces="pypulsar_tpu/ops/pallas_kernels.py:133",
        shape=f"ts [{D}, {T}], stat_len {stat_len}, widths {list(widths)}",
        max_abs_err=err, ms=ms, single_call_ms=single_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))
    print(f"boxcar_stats: [{D}x{T}] stat_len={stat_len}: kernel {ms:.3f} ms "
          f"(single calls {single_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
          f"{nbytes / 1e9:.3f} GB), max abs err {err:.3g}, "
          f"{n_diff} argbox cells differ (all at maxima within 1e-5); "
          f"ties kept first; " + "; ".join(edges))


def check_small_sweep(tmp):
    """The flat sweep of a small file on the card against the CPU."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil
    from pypulsar_tpu_torch.parallel.staged import sweep_flat

    fn = os.path.join(tmp, "small.fil")
    write_synthetic_fil(fn, nchan=256, nsamp=1 << 16, dm=40.0,
                        period_samples=2048, seed=SEED)
    dms = np.arange(64) * 1.0
    res = {}
    for dev in ("cuda", "cpu"):
        with FilterbankFile(fn) as r:
            res[dev] = sweep_flat(r, dms, nsub=32, group_size=8,
                                  chunk_payload=20000,
                                  device=dev).steps[0].result
    a, b = res["cuda"], res["cpu"]
    if not (np.isfinite(a.snr).all() and a.snr.shape == (64, 6)):
        fail("small sweep: non-finite or misshapen SNR on the card")
    if not np.allclose(a.snr, b.snr, rtol=5e-6, atol=1e-4):
        fail(f"small sweep: card and CPU SNR differ by "
             f"{np.abs(a.snr - b.snr).max():.3g}")
    if a.best(1)[0]["dm"] != b.best(1)[0]["dm"]:
        fail("small sweep: card and CPU pick different best DMs")
    print(f"small sweep (256 chans, 2^16 samples, 64 trials): card vs CPU "
          f"max |dSNR| {np.abs(a.snr - b.snr).max():.3g}, peaks differing "
          f"{int((a.peak_sample != b.peak_sample).sum())}/{a.snr.size}, "
          f"best DM {a.best(1)[0]['dm']}")
    return fn


PLAIN_DMS = 16  # phase 3's plain --write-dats trials
PLAIN_ARGV = ["--lodm", "30", "--dmstep", "2", "--numdms", str(PLAIN_DMS),
              "--nsub", "32"]


def dat_diff(base_a, base_b):
    """The largest |difference| of two .dat sets of the same trials, and
    the largest magnitude of ``base_b``'s; fails on a missing file or a
    length or non-finite mismatch."""
    import numpy as np

    worst = scale = 0.0
    dats = sorted(glob.glob(base_b + "_DM*.dat"))
    if len(dats) != PLAIN_DMS:
        fail(f"{base_b}: {len(dats)} .dat files, not {PLAIN_DMS}")
    for fb in dats:
        a = np.fromfile(base_a + fb[len(base_b):], np.float32)
        b = np.fromfile(fb, np.float32)
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"{fb}: card series misshapen or non-finite")
        worst = max(worst, float(np.abs(a - b).max()))
        scale = max(scale, float(np.abs(b).max()))
    return worst, scale


def plain_write_dats(tmp, fn, card):
    """Phase 3 (F4): the plain --write-dats writer of the small file on
    the card against the CPU, resident and streamed; returns the launches
    of both card runs."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    dms = 30.0 + 2.0 * np.arange(PLAIN_DMS)
    sides = (("card", "cuda"), ("cpu", "cpu"))
    runs = {}
    for branch in ("plain", "streamed"):
        for side, dev in sides:
            base = os.path.join(tmp, f"{branch}_{side}")
            with PathMeter(f"write_dats_{branch}", card) as pm:
                if branch == "plain":
                    rc = cli.main([fn, *PLAIN_ARGV, "--write-dats", "-o",
                                   base, "--device", dev])
                    if rc != 0:
                        fail(f"plain --write-dats on {dev} exited {rc}")
                else:
                    with FilterbankFile(fn) as r:
                        how = cli.write_dats_auto(
                            base, r, dms, nsub=32, resident_limit=0,
                            device=dev)
                    if how != "streamed":
                        fail(f"the writer at crossover 0 took the {how} "
                             f"branch")
            runs[branch, side] = (base, pm.wall_s, pm.launches)
    diffs = {}
    for branch in ("plain", "streamed"):
        card_base, cpu_base = runs[branch, "card"][0], runs[branch, "cpu"][0]
        worst, scale = dat_diff(card_base, cpu_base)
        if worst > 1e-6 * scale:
            fail(f"{branch} --write-dats: card and CPU .dat differ by "
                 f"{worst:.3g} (scale {scale:.3g})")
        diffs[branch] = worst
        for fb in sorted(glob.glob(cpu_base + "_DM*.inf")):
            with open(fb, "rb") as b, \
                    open(card_base + fb[len(cpu_base):], "rb") as a:
                name = os.path.basename
                if a.read().replace(name(card_base).encode(),
                                    name(cpu_base).encode()) != b.read():
                    fail(f"{fb}: the card's .inf differs")
    if runs["streamed", "card"][2]["gather_sum/stage1"] < 1:
        fail("the streamed writer launched no gather-sum on the card")
    resident, streamed = (np.fromfile(runs[b, "card"][0] + "_DM60.00.dat",
                                      np.float32)
                          for b in ("plain", "streamed"))
    if np.array_equal(resident, streamed):
        fail("the resident and streamed branches wrote the same series")
    torch.cuda.synchronize()
    print("path write_dats_plain: " + json.dumps({
        "wall_s": runs["plain", "card"][1],
        "cpu_wall_s": runs["plain", "cpu"][1],
        "max_abs_diff": diffs["plain"], "scale": scale,
        "streamed_wall_s": runs["streamed", "card"][1],
        "streamed_cpu_wall_s": runs["streamed", "cpu"][1],
        "streamed_max_abs_diff": diffs["streamed"], "trials": PLAIN_DMS,
        "card": card, "launches": runs["plain", "card"][2],
        "streamed_launches": runs["streamed", "card"][2]}))
    return {"write_dats_plain": runs["plain", "card"][2],
            "write_dats_streamed": runs["streamed", "card"][2]}


def launch_counts() -> dict:
    """Every kernel's launch count, by the kernels line's names."""
    from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
    from pypulsar_tpu_torch.ops.fold import (
        fold_chan,
        fold_parts_batch,
        fold_parts_multi,
        fold_parts_multi_poly,
        fold_parts_poly,
    )
    from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum

    return {"gather_sum/stage1": shifted_gather_sum.launches["stage1"],
            "gather_sum/stage2": shifted_gather_sum.launches["stage2"],
            "gather_sum/tree_level": shifted_gather_sum.launches["tree_level"],
            "gather_sum/tree_snap": shifted_gather_sum.launches["tree_snap"],
            "boxcar_stats": boxcar_stats.launches,
            "fold_parts_batch": fold_parts_batch.launches,
            "fold_parts_poly": fold_parts_poly.launches,
            "fold_parts_multi": fold_parts_multi.launches,
            "fold_parts_multi_poly": fold_parts_multi_poly.launches,
            "fold_chan": fold_chan.launches}


SWEEP_KERNELS = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats")


def sweep_launches() -> dict:
    """The launch counts of the sweep's kernels."""
    counts = launch_counts()
    return {k: counts[k] for k in SWEEP_KERNELS}


def reset_launch_counts() -> None:
    from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
    from pypulsar_tpu_torch.ops.fold import (
        fold_chan,
        fold_parts_batch,
        fold_parts_multi,
        fold_parts_multi_poly,
        fold_parts_poly,
    )
    from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum

    shifted_gather_sum.launches.clear()
    for wrapper in (boxcar_stats, fold_parts_batch, fold_parts_poly,
                    fold_parts_multi, fold_parts_multi_poly, fold_chan):
        wrapper.launches = 0


def write_obs(tmp):
    """The full-width file both driven paths read."""
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil

    fn = os.path.join(tmp, "obs.fil")
    t0 = time.perf_counter()
    info = write_synthetic_fil(fn, nchan=1024, tsamp=64e-6, nsamp=1 << 20,
                               fch1=1500.0, bw=300.0, dm=70.0,
                               period_samples=4096, width=8, nbits=8,
                               seed=SEED)
    print(f"wrote {info['nsamp']} x {info['nchan']} 8-bit samples "
          f"({os.path.getsize(fn) / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    return fn, info


def main_path(tmp, fn, info):
    """The CLI's entry point on the full-width file; returns its numbers."""
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel import staged

    from pypulsar_tpu_torch.parallel import prefetch

    out = os.path.join(tmp, "obs")
    argv = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
            "--nsub", "64", "-o", out, "--device", "cuda"]
    reset_launch_counts()
    prefetch.ship_ahead.bytes = 0
    torch.cuda.synchronize()
    with Timed(staged, "sweep_flat") as sp:  # keeps the result for phase 9
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = sweep_launches()
    PHASE4["h2d_bytes"] = int(prefetch.ship_ahead.bytes)
    if rc != 0:
        fail(f"sweep CLI exited {rc}")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the main path: {launches}")
    with open(out + ".cands") as f:
        rows = [ln.split() for ln in f.read().splitlines()[1:]]
    if not rows:
        fail("the sweep wrote no candidates")
    best = max(rows, key=lambda r: float(r[1]))
    if abs(float(best[0]) - 70.0) > 1.0:
        fail(f"best candidate at DM {best[0]}, not the injected 70")
    duration = info["nsamp"] * info["tsamp"]
    print(f"main path: 1024 trials x {info['nsamp']} samples x 1024 chans in "
          f"{wall:.3f} s wall: {1024 / wall:.1f} DM-trials/s, "
          f"{1024 * info['nsamp'] / wall / 1e9:.3f} G trial-samples/s, "
          f"real-time factor {duration / wall:.2f} ({duration:.1f} s of data); "
          f"best DM {best[0]} SNR {best[1]}; launches {launches}")
    profile_main_path(cli, argv)
    return launches, wall, sp.result.steps[0].result


def profile_main_path(cli, argv):
    """The main path once more under torch.profiler: device time by
    kernel and copy, against the wall time of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}  # device-side events only: kernels, copies, sets
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy_ms = sum(v[0] for k, v in rows.items() if "Memcpy" not in k)
    copy_ms = sum(v[0] for k, v in rows.items() if "Memcpy" in k)
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]
    print("profile: " + json.dumps({
        "wall_ms": wall * 1e3, "kernel_ms": busy_ms, "copy_ms": copy_ms,
        "kernel_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "top": [[k[:80], round(v[0], 3), v[1]] for k, v in top]}))


ACCEL_BATTERY = [  # (f0 Hz, z bins over T, amplitude)
    (37.0, 0.0, 0.30), (61.0, 0.0, 0.18), (43.0, 8.0, 0.25),
    (29.0, -12.0, 0.25), (53.0, 4.0, 0.10), (71.0, 0.0, 0.07),
    (47.0, 0.0, 0.0), (83.0, -4.0, 0.20)]


def unmatched(a, b, floor, dr=0.5, dz=1.0, dsig=0.5):
    """Candidates of ``a`` above ``floor`` with no partner in ``b`` within
    (dr, dz, dsig): the matched-candidate contract's violations."""
    return [c for c in a if c.sigma > floor and not any(
        abs(c.r - o.r) < dr and abs(c.z - o.z) < dz
        and abs(c.sigma - o.sigma) < dsig for o in b)]


def prep_reference(series):
    """``prep_spectra_batch``'s spectra from a float64 transform: numpy's
    rfft of each mean-subtracted series, rounded to complex64 and
    dereddened on the CPU. It tells which of the card and the CPU strayed
    when the two disagree."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fourier import kernels

    s64 = np.asarray(series, dtype=np.float64)
    fft = np.fft.rfft(s64 - s64.mean(axis=1, keepdims=True), axis=1)
    return kernels.deredden(torch.from_numpy(fft.astype(np.complex64)))


def check_prep_against_float64(series, device, what):
    """The card's normalized spectra of ``series[B, n]``, held to 2e-5 of
    the largest magnitude against :func:`prep_reference` (a float64
    transform) and required to repeat bit for bit; their difference from
    the CPU port's is printed, and where it passes 2e-5 a note names the
    spectrum and bin and gives each side's value beside float64's (a
    float32 transform on the host is no oracle for the card's: it has
    strayed past 2e-5 in rare runs on other hosts). Returns (card
    spectra, CPU spectra, a summary)."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fourier import kernels

    card = kernels.prep_spectra_batch(series, device=device)
    again = kernels.prep_spectra_batch(series, device=device)
    cpu = kernels.prep_spectra_batch(series, device="cpu")
    ref = prep_reference(series)
    card_h = card.cpu()
    diff = (card_h - cpu).abs()
    prep_err = float(diff.max() / cpu[:, 1:].abs().max())
    scale = float(ref[:, 1:].abs().max())
    card_ref = float((card_h - ref).abs().max()) / scale
    cpu_ref = float((cpu - ref).abs().max()) / scale
    same_bits = bool(torch.equal(again, card))
    del again
    where = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    said = (f"spectra max abs diff card vs CPU {prep_err:.3g} of the "
            f"largest magnitude; against the float64 transform: card "
            f"{card_ref:.3g}, CPU {cpu_ref:.3g}; largest card-CPU "
            f"difference at spectrum {where[0]}, bin {where[1]}; a second "
            f"prep on the card "
            f"{'has the same bits' if same_bits else 'differs'}")
    if not card_ref < 2e-5:
        fail(f"{what}: the card's spectra differ from the float64 "
             f"transform by {card_ref:.3g} of the largest magnitude "
             f"({said})")
    if not same_bits:
        fail(f"{what}: two preps of the same series on the card differ "
             f"({said})")
    if not prep_err < 2e-5:
        # the card holds against float64, so the CPU's float32 transform
        # strayed: the CPU port's prep is tested on the CPU, not here
        i, k = where
        print(f"chip_smoke: note: {what}: card and CPU spectra differ by "
              f"{prep_err:.3g} of the largest magnitude ({said}); at "
              f"spectrum {i}, bin {k}: card {complex(card_h[i, k])}, CPU "
              f"{complex(cpu[i, k])}, float64 {complex(ref[i, k])} "
              f"(card - float64 {abs(complex(card_h[i, k] - ref[i, k])):.3g}"
              f", CPU - float64 {abs(complex(cpu[i, k] - ref[i, k])):.3g})",
              file=sys.stderr)
    return card, cpu, said


def check_small_accel(device):
    """Prep and search on the card against the port on the CPU: the prep
    by :func:`check_prep_against_float64`, the searches on the two held
    to the matched-candidate contract."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fourier import accelsearch as accel
    from pypulsar_tpu_torch.fourier import kernels

    n, dt = 1 << 15, 2.5e-4
    T = n * dt
    t = np.arange(n) * dt
    rng = np.random.default_rng(SEED)
    rows = []
    for f0, z, amp in ACCEL_BATTERY:
        ts = rng.standard_normal(n).astype(np.float32)
        ts += (amp * np.cos(2 * np.pi * (f0 * t + 0.5 * z / T ** 2 * t * t))
               ).astype(np.float32)
        rows.append(ts)
    series = np.stack(rows)
    cfg = accel.AccelSearchConfig(zmax=20.0, dz=2.0, numharm=4,
                                  sigma_min=3.0, seg_width=1 << 12)
    card, cpu, said = check_prep_against_float64(series, device,
                                                 "small accel")
    got = accel.accel_search_batch(card, T, cfg, device=device)
    want = accel.accel_search_batch(cpu, T, cfg, device="cpu")
    bound = cfg.sigma_min + 0.5
    for i, (g, w) in enumerate(zip(got, want)):
        bad = unmatched(g, w, bound) + unmatched(w, g, bound)
        if bad:
            fail(f"small accel: spectrum {i} breaks the matched-candidate "
                 f"contract: {bad[:3]}")
    detecting = sum(any(c.sigma > bound for c in g) for g in got)
    if detecting < 6:
        fail(f"small accel: only {detecting}/8 spectra detect a tone")
    # the same spectra prepped and searched as two batches of 4
    halves = []
    for s in (slice(0, 4), slice(4, 8)):
        halves += accel.accel_search_batch(
            kernels.prep_spectra_batch(series[s], device=device), T, cfg,
            device=device)
    torch.cuda.synchronize()
    if halves != got:
        fail("small accel: the card's candidates differ between one batch "
             "of 8 and two batches of 4")
    print(f"small accel (8 x 2^15 samples, zmax 20, 4 harmonics, card vs "
          f"CPU): {said}; candidates {sum(map(len, got))} card / "
          f"{sum(map(len, want))} CPU, every one above {bound} matched; "
          f"{detecting}/8 spectra detect; batch of 8 and 2 x 4 on the card: "
          f"identical candidates")


def probe_batched_transforms(device):
    """Whether cuFFT gives a spectrum the same bits transformed alone and
    in a batch, at the shapes of the stage's search (a segment slice of
    L = 32,768 at an odd offset of the padded spectra, and the inverse
    FFT of its product with a 402-row bank) and of its prep (rfft of 2^20
    samples), and the device time of each form. The search transforms
    each spectrum alone (``accelsearch._run_stage_batch``); this measures
    what batching them would keep and save."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)

    def crandn(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))

    L, rows, start = 32768, 402, 4097
    tf = crandn(rows, L)
    res = {}
    for B in (8, 32):
        pad = crandn(B, 2 * L + 13)
        one = torch.stack([torch.fft.fft(pad[b, start:start + L])
                           for b in range(B)])
        many = torch.fft.fft(pad[:, start:start + L])
        fwd_same = torch.equal(one, many)
        big = torch.fft.ifft(many[:, None] * tf, dim=2)
        inv_same = all(torch.equal(torch.fft.ifft(many[b] * tf, dim=1),
                                   big[b]) for b in range(B))
        del big, one

        def fwd_alone():
            for b in range(B):
                torch.fft.fft(pad[b, start:start + L])

        def inv_alone():
            for b in range(B):
                torch.fft.ifft(many[b] * tf, dim=1)

        res[f"B={B}"] = {
            "fft_same_bits": fwd_same, "ifft_same_bits": inv_same,
            "fft_ms_alone": cuda_time_ms(fwd_alone, reps=3),
            "fft_ms_batched": cuda_time_ms(
                lambda: torch.fft.fft(pad[:, start:start + L]), reps=3),
            "ifft_ms_alone": cuda_time_ms(inv_alone, reps=3),
            "ifft_ms_batched": cuda_time_ms(
                lambda: torch.fft.ifft(many[:, None] * tf, dim=2), reps=3)}
        del pad, many
        torch.cuda.empty_cache()
    series = torch.randn((32, 1 << 20), generator=gen, device=device)
    one = torch.stack([torch.fft.rfft(row) for row in series])
    res["rfft 32 x 2^20"] = {
        "same_bits": torch.equal(one, torch.fft.rfft(series)),
        "ms_alone": cuda_time_ms(
            lambda: [torch.fft.rfft(row) for row in series], reps=3),
        "ms_batched": cuda_time_ms(lambda: torch.fft.rfft(series), reps=3)}
    del series, one, tf
    torch.cuda.empty_cache()
    print("fft batching probe: " + json.dumps(res))


class Timed:
    """For one run, wrap ``module.name`` to add up the wall seconds of its
    calls (the device synchronized at the end of each), the kernel
    launches inside them, and keep its last result."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.seconds, self.calls, self.result = 0.0, 0, None
        self.launches = collections.Counter()

    def __enter__(self):
        import torch

        def wrapper(*a, **kw):
            before = collections.Counter(launch_counts())
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.launches.update(collections.Counter(launch_counts())
                                 - before)
            self.result = out
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


# the sweep stage's trials: DM 62..77 (the survey's 32 cut to 16 for the
# script's time; the pulsar's DM 70 inside)
STAGE_LODM, STAGE_DMS = 62, 16
# the survey chains' and fleets' trials: DM 58..72 in steps of 2 (the
# survey's 32 cut to 8 for the script's time; both pulsars' DMs, 62 and
# 70, on the grid, each with a trial on either side)
CHAIN_LODM, CHAIN_DMSTEP, CHAIN_DMS = 58.0, 2.0, 8
CHAIN_CFG = dict(lodm=CHAIN_LODM, dmstep=CHAIN_DMSTEP, numdms=CHAIN_DMS)
CHAIN_FLAGS = ["--lodm", str(CHAIN_LODM), "--dmstep", str(CHAIN_DMSTEP),
               "--numdms", str(CHAIN_DMS)]


def check_stage_kernels(fn, device):
    """The kernels at the sweep stage's own shapes, on the card against
    the plain versions: both gather-sum stages of the first trial-group
    batch of each pass's plan (the single-pulse pass with the sweep's
    widths, the series pass with one width, both at the group size the
    stage picks over its whole grid), and boxcar on the single-pulse
    pass's series. Random channels; any difference fails."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    dms = STAGE_LODM + 1.0 * np.arange(STAGE_DMS)
    with FilterbankFile(fn) as r:
        src = staged.ReaderSource(r)
        g = sweep.choose_group_size(dms, src.frequencies, src.tsamp, 64)
        plan, payload, _ = staged.step_geometry(
            src, dms, 1, 64, g, sweep.DEFAULT_WIDTHS, None)
        passes = {"single-pulse pass": (plan, payload,
                                        payload + max(plan.widths))}
        plan, payload, _ = staged.dats_geometry(r, dms, nsub=64,
                                                group_size=g)
        passes["series pass"] = (plan, payload, payload)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    done = []
    for what, (plan, payload, out_len) in passes.items():
        L1 = out_len + plan.max_shift2
        b = sweep.group_batches(plan.stage1_bins, plan.stage2_bins,
                                plan.nsub, L1, device)[0]
        data = torch.randn((len(plan.freqs), L1 + plan.max_shift1),
                           generator=gen, device=device)
        sub, _ = check_gather_exact(f"{what} stage 1", data, b.stage1, L1)
        del data
        ts, _ = check_gather_exact(f"{what} stage 2", sub, b.stage2, out_len)
        del sub
        B1, J1, _ = b.stage1.shifts.shape
        line = (f"{what} (group {plan.group_size}, widths "
                f"{list(plan.widths)}): stage 1 -> [{B1 * J1}x{L1}], "
                f"stage 2 -> [{ts.shape[0]}x{out_len}] exact")
        if plan.widths != (1,):
            err, n_diff = compare_boxcar(what, ts, plan.widths, payload)
            line += (f", boxcar stat_len {payload}: max abs err {err:.3g}, "
                     f"{n_diff} argbox cells differ")
        done.append(line)
        del ts
    torch.cuda.empty_cache()
    print("sweep stage kernels equal the plain versions: "
          + "; ".join(done))


def stage_argv(fn, out, lodm, numdms, extra=()):
    """The sweep stage's argv with the survey's defaults."""
    return [fn, "--lodm", str(lodm), "--dmstep", "1", "--numdms",
            str(numdms), "--nsub", "64", "--group-size", "0", "--threshold",
            "6", "-o", out, "--device", "cuda", "--accel-search",
            "--accel-zmax", "200", "--accel-dz", "2", "--accel-numharm", "8",
            "--accel-sigma", "2", "--accel-batch", "32", *extra]


def stage_path(tmp, fn, info):
    """The sweep stage with its streamed handoff at full width; returns
    the launches of its two passes."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.fourier import accelsearch as accel
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands
    from pypulsar_tpu_torch.parallel import accelpipe, staged

    out = os.path.join(tmp, "stage")
    D, lodm = STAGE_DMS, STAGE_LODM
    argv = stage_argv(fn, out, lodm, D, ["--write-dats"])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with Timed(staged, "sweep_flat") as sp, \
            Timed(accelpipe, "sweep_accel_stream") as ho, \
            Timed(accelpipe, "stream_series") as ser, \
            Timed(accelpipe, "accel_search_batch") as srch:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = sweep_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        fail(f"sweep stage exited {rc}")
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the sweep stage: {launches}")
    for what, counts in (("single-pulse pass", sp.launches),
                         ("series pass", ser.launches)):
        if min(counts["gather_sum/stage1"], counts["gather_sum/stage2"]) < 1:
            fail(f"the {what} launched no gather-sum stage: {dict(counts)}")
    dms = lodm + np.arange(D)
    want = {".dat": D, ".inf": D, "_ACCEL_200.cand": D,
            "_ACCEL_200.txtcand": D}
    for suffix, n in want.items():
        got = len(glob.glob(f"{out}_DM*{suffix}"))
        if got != n:
            fail(f"sweep stage wrote {got} {suffix} files, not {n}")
    if not os.path.exists(out + ".cands"):
        fail("sweep stage wrote no .cands")
    i70 = int(np.nonzero(dms == 70)[0][0])
    series = ser.result[0]
    dat = np.fromfile(f"{out}_DM70.00.dat", dtype=np.float32)
    if not np.array_equal(dat, series[i70]):
        fail("the DM-70 .dat differs from the series the handoff searched")
    if not np.isfinite(series).all() or series.shape != (D, info["nsamp"]):
        fail(f"series buffer misshapen or non-finite: {series.shape}")
    T = info["nsamp"] * info["tsamp"]
    f0 = 1.0 / (info["period_samples"] * info["tsamp"])
    cands = read_rzwcands(f"{out}_DM70.00_ACCEL_200.cand")

    def harmonic(c):
        k = (c.r / T) / f0
        return k > 0.5 and abs(k - round(k)) < 0.02

    hits = [c for c in cands[:10] if harmonic(c) and abs(c.z) <= 2.0
            and c.sig > 10]
    if not hits:
        fail(f"the DM-70 table holds no harmonic of {f0:.4f} Hz with "
             f"|z| <= 2 and sigma > 10: {cands[:5]}")
    # the host's bank build, which the stage's first search call paid
    # for, timed once more from an empty cache; then the stage chunks the
    # search planned (host arithmetic on the banks)
    cfg = accel.AccelSearchConfig()
    N = info["nsamp"] // 2 + 1
    accel._BANK_CACHE.clear()
    accel._BANK_CACHE_BYTES[0] = 0
    t0 = time.perf_counter()
    setup = accel._search_setup(N, T, cfg)
    bank_build_s = time.perf_counter() - t0
    banks = setup[6]
    chunks = {}
    for H in cfg.stages:
        fixed = accel._stage_fixed_bytes(
            [banks[Fraction(b, H)][0] for b in range(1, H + 1)])
        per = accel._stage_chunk_bytes(len(cfg.zs), 1, cfg.seg_width)
        chunks[H] = max(1, min(D, (int(accel.ACCEL_HBM_BYTES) - fixed)
                               // per))
    accel_s = ho.seconds - ser.seconds
    numbers = {
        "trials": D, "samples": info["nsamp"], "spectral_bins": N,
        "wall_s": wall, "single_pulse_s": sp.seconds, "handoff_s": ho.seconds,
        "series_s": ser.seconds, "accel_s": accel_s,
        "search_calls_s": srch.seconds, "search_calls": srch.calls,
        "bank_build_s": bank_build_s,
        "spectra_per_s": D / accel_s, "peak_device_gb": peak_gb,
        "stage_chunk_spectra": chunks,
        "launches": launches,
        "launches_single_pulse": dict(sp.launches),
        "launches_series": dict(ser.launches),
        "dm70_best": [{"r": c.r, "z": c.z, "sigma": c.sig,
                       "harmonic": round((c.r / T) / f0)} for c in hits[:3]]}
    print("stage: " + json.dumps(numbers))
    profile_handoff(cli, fn, os.path.join(tmp, "prof"))
    return sp.launches, ser.launches, wall, numbers


# op families of the handoff's device time, by the aten op that launched
# each kernel (its self device time)
FAMILIES = (
    ("fft/ifft", ("fft",)),
    ("multiply, |.|^2", ("aten::mul", "aten::abs", "aten::square",
                         "aten::pow")),
    ("stretch gather + accumulate", ("aten::index_select", "aten::gather",
                                     "aten::add")),
    ("topk/detection", ("aten::topk", "aten::ge", "aten::gt",
                        "aten::bitwise_and", "aten::__and__", "aten::where",
                        "aten::constant_pad_nd", "aten::index",
                        "aten::full_like", "aten::stack")),
    ("deredden sort", ("aten::sort",)),
)


PROFILE_DMS = 2  # the profiled handoff's trials


def profile_handoff(cli, fn, out):
    """The handoff (``--accel-only``) over 2 trials from DM 69 under
    torch.profiler (4 before: the profiler's own host work, cut for the
    script's time): device time by op family, and the device's idle
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    argv = stage_argv(fn, out, 69, PROFILE_DMS, ["--accel-only"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            fail("profiled handoff failed")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms, copy_ms, ours = 0.0, 0.0, 0.0
    fam, other = collections.Counter(), collections.Counter()
    top = []
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if "Memcpy" in ev.key or "Memset" in ev.key:
                copy_ms += ms
            else:
                kernel_ms += ms
                top.append((ev.key[:70], round(ms, 3), ev.count))
            if "gather_sum" in ev.key or "boxcar" in ev.key:
                ours += ms
        elif ms > 0:
            name = next((f for f, keys in FAMILIES
                         if any(k in ev.key for k in keys)), "other ops")
            fam[name] += ms
            if name == "other ops":
                other[ev.key] += ms
    fam["dedispersion kernels (gather-sum)"] = ours
    top.sort(key=lambda r: -r[1])
    print("handoff profile: " + json.dumps({
        "trials": PROFILE_DMS, "wall_ms": wall_ms, "kernel_ms": kernel_ms,
        "copy_ms": copy_ms, "idle_share": 1.0 - kernel_ms / wall_ms,
        "by_family_ms": dict(fam),
        "other_ops_ms": dict(other.most_common(8)),
        "top_kernels": top[:12]}))


FOLD_NBINS, FOLD_NPART = 64, 32  # the survey's fold stage (-n 64 --npart 32)


def fold_coeffs(periods, pdots=None, pdds=None):
    """[K, 3] float64 (f0, f1 / 2.0, f2) of each (period, pdot, pdd), the
    fold stage's phase coefficients."""
    import numpy as np

    from pypulsar_tpu_torch.core import psrmath

    rows = []
    for i, p in enumerate(periods):
        f0, f1, f2 = psrmath.p_to_f(
            float(p), 0.0 if pdots is None else float(pdots[i]),
            0.0 if pdds is None else float(pdds[i]))
        rows.append((f0, f1 / 2.0, f2))
    return np.asarray(rows, np.float64)


def fold_bins(T, dt, coeffs, nbins):
    """[K, T] int32 bins of the fold stage's host expression, numpy's
    ``t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0))`` through ``phase_to_bins``
    (the parity anchor of the polynomial form)."""
    import numpy as np

    from pypulsar_tpu_torch.fold.engine import phase_to_bins

    t = np.arange(T, dtype=np.float64) * dt
    return np.stack([phase_to_bins(t * (f0 + t * (h1 + t * f2 / 6.0)), nbins)
                     for f0, h1, f2 in coeffs])


def compare_fold(what, s, b, nbins, npart):
    """The array form against its plain version: counts exact, profiles
    rtol 1e-5 / atol 1e-3; returns (profiles, counts, max abs err)."""
    import torch

    from pypulsar_tpu_torch.ops import fold

    got_p, got_c = fold.fold_parts_batch(s, b, nbins, npart)
    want_p, want_c = fold._torch_fold_parts_batch(s, b, nbins, npart)
    torch.cuda.synchronize()
    if not torch.equal(got_c, want_c):
        fail(f"fold_parts_batch {what}: counts differ from the plain version")
    err = float((got_p - want_p).abs().max()) if got_p.numel() else 0.0
    if not torch.allclose(got_p, want_p, rtol=1e-5, atol=1e-3):
        fail(f"fold_parts_batch {what}: profiles differ from the plain "
             f"version (max abs err {err:.3g})")
    return got_p, got_c, err


def compare_poly(what, s, c, dt, nbins, npart, bins_np):
    """The polynomial form (a) bit for bit against the array form fed
    numpy's bins ``bins_np``, (b) against its plain version (counts exact,
    profiles rtol 1e-5 / atol 1e-3), whose bins (c) must be numpy's;
    returns (profiles, counts, max abs err against the plain version)."""
    import torch

    from pypulsar_tpu_torch.ops import fold

    n = npart * (s.shape[0] // npart)
    b = torch.from_numpy(bins_np).to(s.device)
    c_dev = torch.from_numpy(c).to(s.device)
    if not torch.equal(fold.poly_bins(c_dev, dt, n, nbins), b[:, :n]):
        fail(f"fold_parts_poly {what}: the plain version's bins on the card "
             f"differ from numpy's")
    got_p, got_c = fold.fold_parts_poly(s, c, dt, nbins, npart)
    arr_p, arr_c = fold.fold_parts_batch(s, b, nbins, npart)
    want_p, want_c = fold._torch_fold_parts_poly(s, c_dev, dt, nbins, npart)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, arr_p) and torch.equal(got_c, arr_c)):
        fail(f"fold_parts_poly {what}: not the bits of the array form fed "
             f"numpy's bins (counts differ in "
             f"{int((got_c != arr_c).sum())} bins)")
    if not torch.equal(got_c, want_c):
        fail(f"fold_parts_poly {what}: counts differ from the plain version")
    err = float((got_p - want_p).abs().max()) if got_p.numel() else 0.0
    if not torch.allclose(got_p, want_p, rtol=1e-5, atol=1e-3):
        fail(f"fold_parts_poly {what}: profiles differ from the plain "
             f"version (max abs err {err:.3g})")
    return got_p, got_c, err


def batch_invariant(fn, K):
    """fn(lo, hi) -> profiles of candidates [lo, hi): the bits of one batch
    of K, two halves and each alone must agree."""
    import torch

    whole = fn(0, K)
    halves = torch.cat([fn(0, K // 2), fn(K // 2, K)])
    alone = torch.cat([fn(k, k + 1) for k in range(K)])
    torch.cuda.synchronize()
    return torch.equal(halves, whole) and torch.equal(alone, whole)


def fold_flops(coeffs, n):
    """float64 instructions the polynomial form's bins take for these
    candidates over n samples, none a fused multiply-add: 7 a sample
    ((double)i, t = i*dt, t*h1, f0 + that, t * that, * nbins, the floor),
    3 more where f2 != 0."""
    return float(sum((10 if f2 != 0.0 else 7) * n for _, _, f2 in coeffs))


def check_fold(device, report, datfn, dt):
    """Both forms of the fold kernel at the fold stage's shapes (the DM-70
    series, 32 periods from 1.5 ms to 2 s that include the pulsar's, 64
    bins, 32 partitions), with f2 = 0 (the stage's) and with f2 != 0:
    the polynomial form bit for bit against the array form fed numpy's
    bins, both against their plain versions, a candidate's bits in one
    batch of 32, two of 16 and alone; then the edge cases; each form's
    kernel timed on inputs on the card beside its bound, its plain
    version, and one ``index_add_`` of the same sums from precomputed
    indices, and each wrapper as called; then both kernels over all-short
    and all-long periods (printed, not a check)."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import fold

    series = np.fromfile(datfn, dtype=np.float32)
    T, nbins, npart = len(series), FOLD_NBINS, FOLD_NPART
    psr = 4096 * 64e-6
    periods = np.sort(np.append(np.geomspace(1.5e-3, 2.0, 31), psr))
    K = len(periods)
    coeffs_np = fold_coeffs(periods)
    bins_np = fold_bins(T, dt, coeffs_np, nbins)
    s = torch.from_numpy(series).to(device)
    b = torch.from_numpy(bins_np).to(device)
    profs, counts, err = compare_fold("stage shapes", s, b, nbins, npart)
    pprofs, _, perr = compare_poly("stage shapes", s, coeffs_np, dt, nbins,
                                   npart, bins_np)
    if not batch_invariant(lambda lo, hi: fold.fold_parts_batch(
            s, b[lo:hi], nbins, npart)[0], K):
        fail("fold_parts_batch: a candidate's profile changes with its batch")
    if not batch_invariant(lambda lo, hi: fold.fold_parts_poly(
            s, coeffs_np[lo:hi], dt, nbins, npart)[0], K):
        fail("fold_parts_poly: a candidate's profile changes with its batch")
    # f2 != 0 and pdot != 0 at the same shapes
    rng = np.random.default_rng(SEED + 5)
    c2_np = fold_coeffs(periods, rng.choice([-1.0, 1.0], K) * 10.0
                        ** rng.uniform(-12, -9, K),
                        rng.choice([-1.0, 1.0], K) * 10.0
                        ** rng.uniform(-20, -16, K))
    _, _, perr2 = compare_poly("stage shapes, f2 != 0", s, c2_np, dt, nbins,
                               npart, fold_bins(T, dt, c2_np, nbins))
    if not batch_invariant(lambda lo, hi: fold.fold_parts_poly(
            s, c2_np[lo:hi], dt, nbins, npart)[0], K):
        fail("fold_parts_poly (f2 != 0): a candidate's profile changes with "
             "its batch")
    done = []
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    odd = torch.randn(100003, generator=gen, device=device)
    tmax = T * dt
    # array form (what, series, bins, nbins, npart): 50 bins; T not a
    # multiple of npart with an odd part_len (3125) and bin rows off a
    # 16-byte boundary at odd k; a view whose samples start 4 bytes past
    # one; a lone candidate; every sample in one bin; the largest nbins
    cases = [
        ("nbins 50", s, torch.from_numpy(fold_bins(
            T, dt, coeffs_np[::8], 50)).to(device), 50, npart),
        ("T 100003, part_len 3125", odd, torch.from_numpy(rng.integers(
            0, nbins, (5, 100003), dtype=np.int32)).to(device), nbins, npart),
        ("series view at +1 float, npart 7", odd[1:100002], torch.from_numpy(
            rng.integers(0, nbins, (3, 100001), dtype=np.int32)).to(device),
         nbins, 7),
        ("K 1", s, b[13:14], nbins, npart),
        ("one bin", odd, torch.full((2, 100003), 17, dtype=torch.int32,
                                    device=device), nbins, npart),
        (f"nbins {fold.MAX_NBINS}", odd[:8000], torch.from_numpy(
            rng.integers(0, fold.MAX_NBINS, (2, 8000),
                         dtype=np.int32)).to(device), fold.MAX_NBINS, 2),
    ]
    for what, es, eb, enb, enp in cases:
        _, _, e_err = compare_fold(what, es, eb, enb, enp)
        done.append(f"array {what}: {fold.launch_threads(enb)} threads, max "
                    f"abs err {e_err:.3g}")
    # polynomial form (what, series, coeffs, nbins, npart), each against
    # the array form fed numpy's bins: the same shapes, then phases that
    # turn back below zero or start negative, more than a turn a sample,
    # and bins past 2^31
    pcases = [
        ("nbins 50", s, coeffs_np[::8], 50, npart),
        ("T 100003, part_len 3125", odd, c2_np[::7], nbins, npart),
        ("series view at +1 float, npart 7", odd[1:100002], c2_np[3:6],
         nbins, 7),
        ("K 1", s, coeffs_np[13:14], nbins, npart),
        ("one bin", odd, np.zeros((2, 3)), nbins, npart),
        ("negative and turning phases", s, np.array(
            [(37.0, -2.0 * 37.0 / tmax, 0.0), (-211.3, 0.0, 0.0),
             (0.01, 3.0e-5, -1.0e-5)]), nbins, npart),
        ("more than a turn a sample", s, np.array(
            [(1.0 / (0.7 * dt), 0.0, 0.0), (1.0 / (0.3 * dt), 1.0, 0.0)]),
         nbins, npart),
        ("past 2^31 bins", s, np.array([(5.0e7, 0.0, 0.0),
                                        (3.1e6, -20.0, 1e-3)]), nbins, npart),
        (f"nbins {fold.MAX_NBINS}", odd[:8000], coeffs_np[20:22],
         fold.MAX_NBINS, 2),
    ]
    for what, es, ec, enb, enp in pcases:
        ec = np.ascontiguousarray(ec, np.float64)
        _, _, e_err = compare_poly(what, es, ec, dt, enb, enp,
                                   fold_bins(es.shape[0], dt, ec, enb))
        done.append(f"poly {what}: max abs err {e_err:.3g}")
    for form, call in (
            ("fold_parts_batch", lambda nb: fold.fold_parts_batch(
                odd[:8000], torch.zeros((1, 8000), dtype=torch.int32,
                                        device=device), nb, 2)),
            ("fold_parts_poly", lambda nb: fold.fold_parts_poly(
                odd[:8000], coeffs_np[:1], dt, nb, 2))):
        try:
            call(fold.MAX_NBINS + 1)
        except ValueError as e:
            done.append(f"{form} nbins {fold.MAX_NBINS + 1} refused ({e})")
        else:
            fail(f"{form} launched past its largest nbins")
    P = T // npart
    threads = fold.launch_threads(nbins)
    # the library yardstick: one index_add_ of the same sums into a flat
    # [K * npart * nbins] buffer from precomputed flat indices (profiles
    # only, float atomics: a time, not a port)
    t = torch.arange(npart * P, device=device)
    flat = ((torch.arange(K, device=device)[:, None] * npart + t // P) * nbins
            + b[:, :npart * P].long()).reshape(-1)
    src = s[:npart * P].repeat(K)
    buf = torch.zeros(K * npart * nbins, device=device)
    library_ms = cuda_time_ms(lambda: buf.index_add_(0, flat, src))
    buf.zero_().index_add_(0, flat, src)
    lib_err = float((buf.reshape(K, npart, nbins) - profs).abs().max())
    del flat, src, buf, t
    # the kernel is timed on inputs already on the card; the polynomial
    # form's wrapper also checks the host table and uploads it (its own
    # time, wrapper_ms)
    c_dev = torch.from_numpy(coeffs_np).to(device)
    forms = {}
    for name, call, wrapper, plain, nbytes, nops, ops_rate, lib in (
            ("fold_parts_batch",
             lambda: fold.fold_parts_batch(s, b, nbins, npart),
             lambda: fold.fold_parts_batch(s, b, nbins, npart),
             lambda: fold._torch_fold_parts_batch(s, b, nbins, npart),
             4.0 * K * T + 4.0 * T + 8.0 * K * npart * nbins,
             float(K) * npart * P, FP32_OPS_PER_S, library_ms),
            ("fold_parts_poly",
             lambda: fold._cuda_fold_parts_poly(s, c_dev, dt, nbins, npart),
             lambda: fold.fold_parts_poly(s, coeffs_np, dt, nbins, npart),
             lambda: fold._torch_fold_parts_poly(s, c_dev, dt, nbins, npart),
             4.0 * T + 24.0 * K + 8.0 * K * npart * nbins,
             fold_flops(coeffs_np, npart * P), FP64_OPS_PER_S, None)):
        ms = cuda_time_ms(call)
        single_ms = single_call_ms(call)
        wrapper_ms = cuda_time_ms(wrapper)
        plain_ms = cuda_time_ms(plain, reps=3)
        bms, by = bound(nbytes, nops, ops_rate)
        forms[name] = dict(ms=ms, single_call_ms=single_ms,
                           wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, nbytes=nbytes,
                           nops=nops, library_ms=lib)
    # all-short and all-long periods: the run-length accumulation's range
    by_periods = {}
    for label, p in (("32 x 1.5 ms", 1.5e-3), ("32 x 2 s", 2.0)):
        pc_np = fold_coeffs(np.full(K, p))
        pc = torch.from_numpy(pc_np).to(device)
        pb = torch.from_numpy(fold_bins(T, dt, pc_np, nbins)).to(device)
        by_periods[label] = {
            "fold_parts_batch": cuda_time_ms(
                lambda: fold.fold_parts_batch(s, pb, nbins, npart)),
            "fold_parts_poly": cuda_time_ms(
                lambda: fold._cuda_fold_parts_poly(s, pc, dt, nbins, npart))}
        del pb
    shape = (f"series [{T}], nbins {nbins}, npart {npart}; {threads} threads "
             f"per block")
    for name, f, e, extra in (
            ("fold_parts_batch", forms["fold_parts_batch"], err,
             f"bin_idx [{K}, {T}] int32"),
            ("fold_parts_poly", forms["fold_parts_poly"], perr,
             f"coeffs [{K}, 3] float64, f2 = 0")):
        report.append(dict(
            name=name, route="cuda",
            source="pypulsar_tpu_torch/ops/csrc/fold_parts.cu",
            replaces="pypulsar_tpu/fold/engine.py:323",
            shape=f"{shape}, {extra}", max_abs_err=e, ms=f["ms"],
            single_call_ms=f["single_call_ms"], wrapper_ms=f["wrapper_ms"],
            plain_ms=f["plain_ms"],
            bound_ms=f["bound_ms"], bound_by=f["bound_by"],
            library_ms=f["library_ms"],
            ms_by_periods={k: v[name] for k, v in by_periods.items()}))
        print(f"{name}: series [{T}] x {K} candidates -> [{K}x{npart}x"
              f"{nbins}] ({extra}): kernel {f['ms']:.4f} ms (single calls "
              f"{f['single_call_ms']:.4f} ms), wrapper {f['wrapper_ms']:.4f} "
              f"ms, plain {f['plain_ms']:.3f} ms, "
              f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}: "
              f"{f['nbytes'] / 1e9:.4f} GB, {f['nops'] / 1e9:.4f} G ops), "
              f"max abs err {e:.3g}, counts exact; all 1.5 ms / all 2 s "
              f"periods {by_periods['32 x 1.5 ms'][name]:.4f} / "
              f"{by_periods['32 x 2 s'][name]:.4f} ms")
    print(f"fold forms: polynomial == array fed numpy's bins, bit for bit "
          f"(f2 = 0 and f2 != 0, max abs err vs plain {perr:.3g} / "
          f"{perr2:.3g}); index_add_ {library_ms:.4f} ms (max abs diff "
          f"{lib_err:.3g}); batch of 32, 2 x 16 and alone: identical bits; "
          + "; ".join(done))
    del s, b, c_dev, profs, counts, pprofs, odd
    torch.cuda.empty_cache()


def harmonic_of(period, psr):
    """(k, true period at that harmonic) when ``period`` is the pulsar's
    or a harmonic of it, |P k / psr - 1| < 1e-3 with k or 1/k an integer
    <= 8; else None."""
    ratio = period / psr
    m = round(1.0 / ratio) if ratio < 1 else round(ratio)
    if not 1 <= m <= 8:
        return None
    k = m if ratio < 1 else 1.0 / m
    if abs(period * k / psr - 1.0) >= 1e-3:
        return None
    return k, psr / k


def fold_stage(tmp, fn, info, device, report):
    """Phase 7: sift -> foldbatch -> pfd_snr on the sweep stage's output at
    the survey's settings, the stream source over the same list, a second
    ``--datbase`` fold at batch 7, then a profiled ``--datbase`` fold.
    Returns the launches of the ``.dat`` and the stream folds."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import foldbatch, pfd_snr, sift
    from pypulsar_tpu_torch.fold import profile_snr
    from pypulsar_tpu_torch.io.accelcands import parse_candlist
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    stage = os.path.join(tmp, "stage")
    dt = info["tsamp"]
    check_fold(device, report, f"{stage}_DM70.00.dat", dt)
    cand_files = sorted(glob.glob(f"{stage}_DM*_ACCEL_200.cand"))
    sifted = os.path.join(tmp, "fold.accelcands")
    t0 = time.perf_counter()
    rc = sift.main(cand_files + ["-s", "4", "--min-hits", "2", "-o", sifted])
    sift_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"sift exited {rc}")
    n_sifted = len(parse_candlist(sifted))
    if n_sifted == 0:
        fail("sift kept no candidate")
    fold_args = ["--cands", sifted, "-n", str(FOLD_NBINS), "--npart",
                 str(FOLD_NPART), "--device", "cuda"]

    def run_fold(out, extra):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = foldbatch.main(fold_args + ["-o", out, *extra])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if rc != 0:
            fail(f"foldbatch {' '.join(extra)} exited {rc}")
        with open(f"{out}_foldbatch.json") as f:
            summary = json.load(f)
        return (summary, took, launch_counts(),
                torch.cuda.max_memory_allocated() / 1e9)

    dats = os.path.join(tmp, "fold_dats")
    summ, fold_dats_s, l_dats, peak_dats = run_fold(
        dats, ["--datbase", stage, "--batch", "32"])
    t0 = time.perf_counter()
    rc = pfd_snr.main([f"{dats}_*.pfd", "--json", dats + "_snr.json"])
    pfd_snr_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"pfd_snr exited {rc}")
    stream = os.path.join(tmp, "fold_stream")
    _, fold_stream_s, l_stream, peak_stream = run_fold(
        stream, [fn, "-s", "64", "--group-size", "0"])
    b7 = os.path.join(tmp, "fold_b7")
    run_fold(b7, ["--datbase", stage, "--batch", "7"])
    s7 = os.path.join(tmp, "fold_stream_b7")
    run_fold(s7, [fn, "-s", "64", "--group-size", "0", "--batch", "7"])
    if min(l_dats["fold_parts_poly"], l_stream["fold_parts_poly"]) < 1:
        fail(f"a fold source launched no fold kernel: {l_dats}, {l_stream}")
    if min(l_stream["gather_sum/stage1"], l_stream["gather_sum/stage2"]) < 1:
        fail(f"the stream fold launched no gather-sum stage: {l_stream}")
    results = summ["results"]
    if len(results) != n_sifted or summ["n_folded"] != n_sifted:
        fail(f"{summ['n_folded']} of {n_sifted} sifted candidates folded")
    for r in results:
        for base in (dats, stream, b7, s7):
            if not os.path.exists(f"{base}_{r['name']}.pfd"):
                fail(f"no archive {base}_{r['name']}.pfd")
        for b32, b_7 in ((dats, b7), (stream, s7)):
            with open(f"{b32}_{r['name']}.pfd", "rb") as a, \
                    open(f"{b_7}_{r['name']}.pfd", "rb") as c:
                if a.read() != c.read():
                    fail(f"{r['name']}: archive bytes differ between "
                         f"--batch 32 and --batch 7 ({os.path.basename(b32)})")
    with open(dats + "_snr.json") as f:
        snr = {row["name"]: row["snr"] for row in json.load(f)}
    psr = info["period_samples"] * dt
    T_sec = FOLD_NPART * (info["nsamp"] // FOLD_NPART) * dt
    hits = []
    for r in results:
        h = harmonic_of(r["period"], psr)
        if h is None or abs(r["dm"] - 70.0) > 2.0 or not snr[r["name"]]:
            continue
        step = 4.0 / 32 * r["period"] ** 2 / T_sec  # one grid step in P
        if snr[r["name"]] > 10 and abs(r["best_period"] - h[1]) <= step:
            hits.append(dict(name=r["name"], dm=r["dm"], period=r["period"],
                             harmonic=h[0], snr=snr[r["name"]],
                             best_period=r["best_period"], true_period=h[1],
                             grid_step=step))
    if not hits:
        fail("no sifted candidate within 2 DM of 70 at the pulsar's period "
             "or a harmonic (k <= 8) folds to SNR > 10 with a refined "
             "period within one grid step")
    row = max(hits, key=lambda h: h["snr"])
    row["snr_stream"] = float(profile_snr.pfd_snr(
        PfdFile(f"{stream}_{row['name']}.pfd"))["snr"])
    if not row["snr_stream"] > 10:
        fail(f"the stream source folds the pulsar to SNR "
             f"{row['snr_stream']:.2f}")
    groups = collections.Counter(r["dm"] for r in results)
    numbers = {
        "sifted": n_sifted, "dm_groups": len(groups),
        "cands_per_group": sorted(groups.values(), reverse=True),
        "sift_s": sift_s, "fold_dats_s": fold_dats_s,
        "fold_stream_s": fold_stream_s, "pfd_snr_s": pfd_snr_s,
        "cands_per_s": {"dats": n_sifted / fold_dats_s,
                        "stream": n_sifted / fold_stream_s},
        "peak_device_gb": {"dats": peak_dats, "stream": peak_stream},
        "launches": {"dats": l_dats, "stream": l_stream},
        "pulsar": row, "pulsar_rows_found": len(hits)}
    print("fold stage: " + json.dumps(numbers))
    profile_fold(fold_args + ["-o", os.path.join(tmp, "fold_prof"),
                              "--datbase", stage])
    return l_dats, l_stream


# the fold kernels' names in the profiler (demangled, parameters cut);
# matched whole: a substring would also match a kernel whose name holds
# another's
FOLD_KERNEL_NAMES = ("fold_poly_kernel", "fold_array_kernel")


def kernel_name(key: str) -> str:
    """The bare function name of a profiler kernel key: without its
    return type, namespaces, template arguments and parameter list
    (``void (anonymous namespace)::fold_poly_kernel(float const*, ...)``
    -> ``fold_poly_kernel``)."""
    key = key.replace("(anonymous namespace)::", "")
    key = key.split("(", 1)[0].split("<", 1)[0].strip()
    return key.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def profile_fold(argv):
    """One more ``--datbase`` fold under torch.profiler: device time of the
    fold kernel, of ``refine_chi2``'s ops and of copies, the host prep's
    wall time (on the prefetch worker) and the device's idle share. The
    fold kernel's launches are counted twice, by the profiler (kernels
    whose name is one of ``FOLD_KERNEL_NAMES``) and by the wrappers'
    counters over the same run, beside the candidates of each wrapper
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pypulsar_tpu_torch.cli import foldbatch
    from pypulsar_tpu_torch.fold import engine
    from pypulsar_tpu_torch.ops import fold as ops_fold
    from pypulsar_tpu_torch.parallel import foldpipe

    real_prep, real_refine = foldpipe._prep_group, engine.refine_chi2
    real_poly = ops_fold.fold_parts_poly
    prep_s = [0.0]
    calls = []

    def prep(*a, **kw):
        t0 = time.perf_counter()
        out = real_prep(*a, **kw)
        prep_s[0] += time.perf_counter() - t0
        return out

    def refine(*a, **kw):
        with record_function("refine_chi2"):
            return real_refine(*a, **kw)

    def poly(series, coeffs, *a, **kw):
        calls.append(int(len(coeffs)))
        return real_poly(series, coeffs, *a, **kw)

    foldpipe._prep_group, engine.refine_chi2 = prep, refine
    engine_poly = getattr(engine, "fold_parts_poly", None)
    if engine_poly is not None:
        engine.fold_parts_poly = poly
    reset_launch_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if foldbatch.main(argv) != 0:
                fail("profiled fold failed")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        foldpipe._prep_group, engine.refine_chi2 = real_prep, real_refine
        if engine_poly is not None:
            engine.fold_parts_poly = engine_poly
    counted = launch_counts()
    counter_launches = counted["fold_parts_poly"] + counted[
        "fold_parts_batch"]
    kernel_ms = copy_ms = fold_ms = refine_ms = 0.0
    h2d_ms, fold_n = 0.0, 0
    top, by_op = [], collections.Counter()
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key == "refine_chi2":
                continue  # the annotation's span on the device timeline
            if "Memcpy" in ev.key or "Memset" in ev.key:
                copy_ms += ms
                h2d_ms += ms if "HtoD" in ev.key else 0.0
            else:
                kernel_ms += ms
                top.append((ev.key[:70], round(ms, 3), ev.count))
            if kernel_name(ev.key) in FOLD_KERNEL_NAMES:
                fold_ms += ms
                fold_n += ev.count
        elif ev.key == "refine_chi2":
            refine_ms += ev.device_time_total / 1e3
        elif ms > 0:
            by_op[ev.key] += ms
    top.sort(key=lambda r: -r[1])
    print("fold profile: " + json.dumps({
        "wall_ms": wall_ms, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
        "h2d_ms": h2d_ms, "fold_kernel_ms": fold_ms,
        "fold_launches_profiled": fold_n,
        "fold_launches_counted": counter_launches,
        "fold_calls_candidates": calls,
        "refine_chi2_ms": refine_ms,
        "host_prep_s": prep_s[0],
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "by_op_ms": dict(by_op.most_common(8)), "top_kernels": top[:8]}))


MASK_TIME, TONE_CHANS, RFI_INTERVAL = 1.0, range(500, 516), 20


def write_rfi_copy(tmp, fn, info):
    """A copy of the phase-4 file with RFI in its data bytes: file
    channels ``TONE_CHANS`` hold a square wave of period 16 samples at 0
    and 255, and every other channel gains 25 counts over the 1-s
    interval ``RFI_INTERVAL`` (noise and pulse stay <= 229, so <= 254).
    Returns its path and the mask channels and interval that must be
    zapped (mask channels run low-frequency-first; the file descends)."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    out = os.path.join(tmp, "rfi.fil")
    t0 = time.perf_counter()
    shutil.copyfile(fn, out)
    with FilterbankFile(out) as r:
        hdr_bytes, C, T = r.header_size, r.nchans, r.nspec
    pts = int(round(MASK_TIME / info["tsamp"]))
    data = np.memmap(out, dtype=np.uint8, mode="r+", offset=hdr_bytes,
                     shape=(T, C))
    data[RFI_INTERVAL * pts:(RFI_INTERVAL + 1) * pts] += np.uint8(25)
    c0, c1 = TONE_CHANS[0], TONE_CHANS[-1] + 1
    step = 1 << 16
    tone = np.where((np.arange(step) // 8) % 2 == 0, 0, 255).astype(np.uint8)
    for a in range(0, T, step):  # step is a whole number of periods
        n = min(step, T - a)
        data[a:a + n, c0:c1] = tone[:n, None]
    data.flush()
    del data
    print(f"wrote the RFI copy in {time.perf_counter() - t0:.1f} s: tone "
          f"on file channels {c0}..{c1 - 1}, +25 over interval "
          f"{RFI_INTERVAL} ({pts} samples)")
    return out, sorted(C - 1 - c for c in TONE_CHANS), RFI_INTERVAL


def write_head(tmp, fn, n, name="rfi_head.fil"):
    """A file ``name`` of the first ``n`` samples of ``fn`` (all, if
    fewer)."""
    from pypulsar_tpu_torch.io import sigproc
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    out = os.path.join(tmp, name)
    with FilterbankFile(fn) as r:
        n = min(n, r.nspec)
        hdr = dict(r.header, nsamples=n)
        raw = r._read_raw_block(0, n)
    with open(out, "wb") as f:
        f.write(sigproc.pack_header(hdr))
        raw.tofile(f)
    return out


def check_mask_stage(tmp, fn, device):
    """The mask stage's gates on the card before the chain: block stats
    of the first read against the float64 twin, and the ``.mask`` of the
    first 2^18 samples against the port's on the CPU."""
    import numpy as np

    from pypulsar_tpu_torch.cli import rfifind as cli
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.ops import rfifind

    with FilterbankFile(fn) as r:
        pts = max(int(round(MASK_TIME / r.tsamp)), 2)
        nchan = r.nchans
        blocks = rfifind._iter_file_blocks(r, pts * 16, device)
        first = next(blocks)
        blocks.close()
    got = [x.cpu().numpy() for x in rfifind.block_stats(first, pts)]
    want = rfifind.block_stats_numpy(first.cpu().numpy(), pts)
    stats_ms = cuda_time_ms(lambda: rfifind.block_stats(first, pts))
    del first
    errs = {"mean": float(np.abs(got[0] - want[0]).max()),
            "std": float(np.abs(got[1] - want[1]).max()),
            "maxpow_rel": float(np.abs(got[2] / want[2] - 1).max())}
    if got[0].shape != (16, nchan) or not all(
            np.isfinite(g).all() for g in got):
        fail(f"block stats misshapen or non-finite: {got[0].shape}")
    if not (errs["mean"] <= 1e-5 and errs["std"] <= 1e-5
            and errs["maxpow_rel"] <= 2e-3):
        fail(f"the card's block stats of the first read miss the float64 "
             f"twin's bounds: {errs}")
    head = write_head(tmp, fn, 1 << 18)
    masks = {}
    for dev in (device.type, "cpu"):
        base = os.path.join(tmp, f"head_{dev}")
        if cli.main([head, "-o", base, "-t", str(MASK_TIME),
                     "--device", dev]) != 0:
            fail(f"rfifind --device {dev} failed on the head file")
        with open(base + "_rfifind.mask", "rb") as f:
            masks[dev] = f.read()
    n_diff = 0
    if masks[device.type] != masks["cpu"]:
        flags = [rfifind.clip_stats(rfifind.RfiStats.load(
            os.path.join(tmp, f"head_{d}_rfifind.stats.npz")))
            for d in masks]
        with FilterbankFile(head) as r:
            x = r.get_samples(0, r.nspec).T[::-1]
            dt = r.tsamp
        tail = x.shape[1] % pts
        if tail >= pts // 2:
            x = np.concatenate([x, np.repeat(x[:, -1:], pts - tail, 1)], 1)
        twin = rfifind.RfiStats(*rfifind.block_stats_numpy(x, pts), pts,
                                pts * dt, 0.0, 0.0)
        diff = flags[0] != flags[1]
        n_diff = int(diff.sum())
        if not (rfifind.decision_margins(twin)[diff] <= 1.0).all():
            fail(f"the card's head mask differs from the CPU's in {n_diff} "
                 f"flags, not all within the stats' bounds of a threshold")
    print(f"mask stage: first-read block stats ({stats_ms:.3f} ms on the "
          f"card) vs the float64 twin {json.dumps(errs)}; head mask (2^18 "
          f"samples) card vs CPU: "
          + ("equal bytes" if not n_diff else
             f"{n_diff} flags differ, each at its threshold"))
    return errs


def sha256s(paths):
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def survey_chain(tmp, fn, info, device, unmasked_stage_s):
    """Phase 8: the survey's whole chain on the RFI copy of the file;
    returns the chain's launches."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.parallel import accelpipe, staged
    from pypulsar_tpu_torch.survey import dag
    from pypulsar_tpu_torch.survey.state import Observation

    rfi, tone_mask_chans, rfi_int = write_rfi_copy(tmp, fn, info)
    stats_err = check_mask_stage(tmp, rfi, device)
    os.makedirs(os.path.join(tmp, "chain"))
    obs = Observation("rfi", rfi, os.path.join(tmp, "chain", "rfi"))
    cfg = dag.SurveyConfig(**CHAIN_CFG)
    fill = collections.Counter()
    real_fill = staged.masked_block

    def counted_fill(data, *a):  # counts the fill's blocks, no sync
        fill[tuple(data.shape)] += 1
        return real_fill(data, *a)

    staged.masked_block = counted_fill
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        walls = dag.run_observation(obs, cfg, device=device)
        torch.cuda.synchronize()
    finally:
        staged.masked_block = real_fill
    chain_s = time.perf_counter() - t0
    launches = launch_counts()
    need = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats",
            "fold_parts_poly")
    if min(launches[k] for k in need) < 1:
        fail(f"the survey chain did not launch every kernel: {launches}")
    mask = RfifindMask(obs.outbase + "_rfifind.mask")
    table = mask._zap_table
    if not (set(tone_mask_chans) <= set(mask.mask_zap_chans.tolist())
            and rfi_int in mask.mask_zap_ints.tolist()):
        fail(f"the mask zaps channels {mask.mask_zap_chans.tolist()} and "
             f"intervals {mask.mask_zap_ints.tolist()}, not the tone's "
             f"{tone_mask_chans} and interval {rfi_int}")
    rest = np.delete(np.delete(table, tone_mask_chans, axis=1), [rfi_int],
                     axis=0)
    if rest.mean() >= 0.01:
        fail(f"the mask flags {rest.mean():.2%} of the cells without RFI")
    with open(obs.outbase + "_foldbatch.json") as f:
        results = json.load(f)["results"]
    with open(obs.outbase + "_snr.json") as f:
        snr = {row["name"]: row["snr"] for row in json.load(f)}
    psr = info["period_samples"] * info["tsamp"]
    hits = [dict(name=r["name"], dm=r["dm"], period=r["period"],
                 snr=snr.get(r["name"])) for r in results
            if harmonic_of(r["period"], psr) is not None
            and abs(r["dm"] - 70.0) <= 2.0 and (snr.get(r["name"]) or 0) > 10]
    if not hits:
        fail("no chain candidate within 2 DM of 70 at the pulsar's period "
             "or a harmonic folds to SNR > 10")
    # the sweep stage once more with the same journal: nothing to redo
    sweep = next(s for s in dag.build_dag(cfg) if s.name == "sweep")
    arts = [p for s in dag.build_dag(cfg) for p in s.outputs(obs, cfg)]
    before = sha256s(arts)
    with open(obs.outbase + ".chain.jsonl") as f:
        done_before = sum('"type": "done"' in ln for ln in f)
    with Timed(staged, "sweep_flat") as sp, \
            Timed(accelpipe, "accel_search_batch") as srch:
        t0 = time.perf_counter()
        sweep.execute(obs, cfg, device=device)
        rerun_s = time.perf_counter() - t0
    with open(obs.outbase + ".chain.jsonl") as f:
        done_after = sum('"type": "done"' in ln for ln in f)
    if sp.calls or srch.calls or done_after != done_before:
        fail(f"the journalled rerun redid work: {sp.calls} sweeps, "
             f"{srch.calls} searches, {done_after - done_before} new units")
    if sha256s(arts) != before:
        fail("the journalled rerun changed an artifact's bytes")
    # the fill of one block of each shape the chain filled, on the card
    fill_ms = {}
    table = torch.from_numpy(np.ascontiguousarray(table[:, ::-1])).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    for shape in fill:
        block = torch.randint(0, 256, shape, generator=gen, device=device,
                              dtype=torch.uint8).float()
        fill_ms["x".join(map(str, shape))] = cuda_time_ms(
            lambda: real_fill(block, table, rfi_int, 0, mask.ptsperint))
        del block
    size_gb = os.path.getsize(rfi) / 1e9
    best = max(hits, key=lambda h: h["snr"])
    print("survey chain: " + json.dumps({
        "stage_wall_s": walls, "chain_wall_s": chain_s,
        "mask_gb_per_s": size_gb / walls["mask"],
        "masked_sweep_stage_s": walls["sweep"],
        "unmasked_sweep_stage_s": unmasked_stage_s,
        "mask_zap_chans": len(mask.mask_zap_chans),
        "mask_zap_ints": mask.mask_zap_ints.tolist(),
        "mask_coverage": float(mask._zap_table.mean()),
        "other_cells_flagged": float(rest.mean()),
        "fill_blocks": {"x".join(map(str, k)): v for k, v in fill.items()},
        "fill_ms_per_block": fill_ms,
        "first_read_stats_err": stats_err,
        "pulsar": best, "pulsar_rows_found": len(hits),
        "rerun_sweep_s": rerun_s, "units_done": done_before,
        "artifacts": len(arts), "launches": launches}))
    return dict(launches=launches, rfi=rfi, walls=walls,
                outbase=obs.outbase)


# ---------------------------------------------------------------------------
# phase 9: the sweep's other dedispersion paths
# ---------------------------------------------------------------------------

def check_tree_kernels(device, report):
    """The tree engine's widest merge level and its snap at the 1024-trial
    sweep's shape (random state rows), on the card against the plain
    version (exact: both add in k order from zero), each timed beside its
    bound. Returns the plan's structural numbers."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import gather_sum as gs
    from pypulsar_tpu_torch.ops import tree_dedisperse as tdd

    plan, _, out_len, L1, _ = path_geometry(device)
    need = L1 + plan.max_shift1
    t0 = time.perf_counter()
    tp = tdd._build_plan(plan.stage1_bins, plan.stage2_bins)
    build_s = time.perf_counter() - t0
    levels, snap = tp.device_tables(device)
    state = tdd.TreeState(tp, need, device)
    src, dst = state.bufs
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    src[:tp.rows, :need].normal_(generator=gen)  # row R, pad columns: 0
    li = int(np.argmax(tp.rows_per_level))
    n = tp.rows_per_level[li]
    cases = (("tree_level", levels[li], need, dst[:n, :need],
              tp.tabs[0:2, li, :n], f"level {li} of {tp.n_levels}: "
              f"{n} rows, K 2"),
             ("tree_snap", snap, out_len, None, tp.trial_row,
              f"snap: {tp.n_trials} trials, K 1"))
    for stage, tables, m, out, srcs, what in cases:
        got = gs.shifted_gather_sum(src, tables, m, out=out)
        want = gs._torch_gather_sum(src, tables, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"gather_sum {stage} disagrees with its plain version "
                 f"(max abs err {float((got - want).abs().max())})")
        B, J, K = tables.shifts.shape
        library_ms = None
        if stage == "tree_snap":
            # the library yardstick of a K = 1 shifted gather: one
            # torch.gather of the flat state at index row * L + shift + t,
            # in output-row order; it must give the kernel's output exactly
            dest = tables.out_rows.reshape(-1).long()
            start = torch.empty_like(dest)
            start[dest] = (tables.src_rows[:, 0].long().repeat_interleave(J)
                           * src.shape[1]
                           + tables.shifts.reshape(-1).long())
            idx = (start[:, None] + torch.arange(m, device=device)
                   ).reshape(-1)
            flat_state = src.reshape(-1)
            lib = torch.gather(flat_state, 0, idx).view(B * J, m)
            if not torch.equal(lib, got):
                fail("torch.gather of the snap's index differs from the "
                     "kernel's output")
            library_ms = cuda_time_ms(lambda: torch.gather(flat_state, 0,
                                                           idx), reps=3)
            del lib, idx, start
        del want, got
        ms = cuda_time_ms(lambda: gs.shifted_gather_sum(src, tables, m,
                                                        out=out))
        single_ms = single_call_ms(lambda: gs.shifted_gather_sum(
            src, tables, m, out=out))
        plain_ms = cuda_time_ms(lambda: gs._torch_gather_sum(
            src, tables, m, out=out), reps=3)
        # each source row read once over the output's window, each output
        # row written once, the tables read once
        n_src = len(np.unique(srcs))
        nbytes = 4.0 * (n_src + B * J) * m + 4.0 * B * (2 * K + 1)
        bms, by = bound(nbytes, float(B) * J * K * m)
        jb, e, threads, win, _ = gs.launch_config(J, K, tables.bounds.spreads)
        report.append(dict(
            name=f"gather_sum/{stage}", route="cuda",
            source="pypulsar_tpu_torch/ops/csrc/gather_sum.cu",
            replaces="pypulsar_tpu/ops/pallas_dedisperse.py:107",
            shape=f"state [{tp.rows + 1}, {need + tp.pad}], {what}, "
                  f"{n_src} distinct source rows, out_len {m}; {jb} row x "
                  f"{e} samples per thread, {threads} threads",
            max_abs_err=0.0, ms=ms, single_call_ms=single_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=library_ms))
        lib_txt = ("" if library_ms is None else
                   f", torch.gather {library_ms:.3f} ms (exact)")
        print(f"gather_sum {stage}: {what} -> [{B * J}x{m}]: kernel "
              f"{ms:.3f} ms (single calls {single_ms:.3f} ms), plain "
              f"{plain_ms:.3f} ms{lib_txt}, bound {bms:.3f} ms ({by}: "
              f"{nbytes / 1e9:.3f} GB; 2 reads + 1 write per output "
              f"sample would be {12.0 * B * m / 1e9:.3f} GB), exact")
    info = dict(plan_build_s=build_s, merge_levels=tp.n_levels,
                rows=tp.rows, adds_per_sample=tp.adds_per_sample,
                rows_per_level=list(tp.rows_per_level), pad=tp.pad,
                state_gb=state.nbytes / 1e9)
    del state, src, dst
    torch.cuda.empty_cache()
    return info


def prove_ties(fn, plan, got, ref, widths):
    """Where two sweeps' peak starts differ, the window sums of the raw
    8-bit samples at both starts (integer sums, exact) must be equal: an
    exact tie, which either start may report. The baseline is the same
    constant for both windows of a width. Returns the number of ties."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    with FilterbankFile(fn) as r:
        hdr, C, T = r.header_size, r.nchans, r.nspec
        if r.frequencies[0] < r.frequencies[-1]:
            fail("tie proof: the file's band ascends")
    raw = np.memmap(fn, dtype=np.uint8, mode="r", offset=hdr, shape=(T, C))
    per = C // plan.nsub
    diff = np.argwhere(got != ref)
    for d, wi in diff:
        g, ti = divmod(int(d), plan.group_size)
        tot = plan.stage1_bins[g] + np.repeat(plan.stage2_bins[g, ti], per)
        w = widths[wi]
        sums = []
        for a in (int(got[d, wi]), int(ref[d, wi])):
            if a + int(tot.max()) + w > T:
                fail(f"tie proof: trial {d} width {w} peak at {a} reads "
                     f"past the end of data")
            sums.append(sum(int(raw[a + tot[c]:a + tot[c] + w, c].sum(
                dtype=np.int64)) for c in range(C)))
        if sums[0] != sums[1]:
            fail(f"trial {d} width {w}: peaks {got[d, wi]} and "
                 f"{ref[d, wi]} differ and hold window sums {sums}")
    return len(diff)


def engine_paths(tmp, fn, info, device, report, gather_res):
    """Phase 9 (a): ``cli.sweep --engine tree`` and ``--engine fourier``
    over phase 4's 1024 trials, each held to phase 4's gather run on the
    card; returns each engine's launches."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel import staged

    tree_info = check_tree_kernels(device, report)
    plan = path_geometry(device)[0]
    out_by_engine = {}
    for engine in ("tree", "fourier"):
        out = os.path.join(tmp, f"engine_{engine}")
        argv = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
                "--nsub", "64", "-o", out, "--device", "cuda", "--engine",
                engine]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        with Timed(staged, "sweep_flat") as sp:
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if rc != 0:
            fail(f"sweep --engine {engine} exited {rc}")
        need = ["boxcar_stats"] + (["gather_sum/tree_level",
                                    "gather_sum/tree_snap"]
                                   if engine == "tree" else [])
        if min(launches[k] for k in need) < 1:
            fail(f"sweep --engine {engine} did not launch {need}: "
                 f"{launches}")
        res = sp.result.steps[0].result
        g = gather_res
        if not (np.isfinite(res.snr).all() and res.snr.shape == g.snr.shape):
            fail(f"--engine {engine}: non-finite or misshapen SNR")
        rel = np.abs(res.snr - g.snr) / np.maximum(np.abs(g.snr), 1.0)
        if rel.max() > 2e-6:
            d, w = np.unravel_index(np.argmax(rel), rel.shape)
            fail(f"--engine {engine}: SNR off gather's by {rel.max():.3g} "
                 f"relative at trial {d}, width {res.widths[w]}")
        ties = prove_ties(fn, plan, res.peak_sample, g.peak_sample,
                          res.widths)
        best = res.best(1)[0]
        if abs(best["dm"] - 70.0) > 1.0:
            fail(f"--engine {engine}: best DM {best['dm']}, not 70")
        numbers = dict(
            engine=engine, wall_s=wall, dm_trials_per_s=1024 / wall,
            peak_device_gb=peak_gb, max_rel_snr_vs_gather=float(rel.max()),
            peaks_differing_proven_ties=ties, best=best, launches=launches,
            engine_info=res.engine_info)
        if engine == "tree":
            numbers["tree"] = tree_info
        print(f"engine {engine}: " + json.dumps(numbers, default=float))
        out_by_engine[engine] = launches
    torch.cuda.empty_cache()
    return out_by_engine


def accel_hits(candfn, info, min_sigma=10.0):
    """Rows of a ``.cand`` file at a harmonic of the pulsar's frequency
    with |z| <= 2 and sigma above ``min_sigma``, among its first 10."""
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands

    T = info["nsamp"] * info["tsamp"]
    f0 = 1.0 / (info["period_samples"] * info["tsamp"])
    out = []
    for c in read_rzwcands(candfn)[:10]:
        k = (c.r / T) / f0
        if k > 0.5 and abs(k - round(k)) < 0.02 and abs(c.z) <= 2.0 \
                and c.sig > min_sigma:
            out.append({"r": c.r, "z": c.z, "sigma": c.sig,
                        "harmonic": round(k)})
    return out


def same_bytes(paths_a, prefix_a, prefix_b):
    """Fail unless each file of ``paths_a`` has the bytes of its twin
    under ``prefix_b``; returns the count."""
    for pa in paths_a:
        pb = prefix_b + pa[len(prefix_a):]
        with open(pa, "rb") as a, open(pb, "rb") as b:
            if a.read() != b.read():
                fail(f"{pb} differs from {pa}")
    return len(paths_a)


def spectral_stage(tmp, fn, info, stage_s, stage_numbers):
    """Phase 9 (b): the sweep stage with ``--spectral`` over phase 6's 32
    trials; every ``.cand`` must have phase 6's bytes."""
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel import accelpipe, staged

    out = os.path.join(tmp, "spectral")
    argv = stage_argv(fn, out, STAGE_LODM, STAGE_DMS, ["--spectral"])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with Timed(staged, "sweep_flat") as sp, \
            Timed(accelpipe, "sweep_accel_stream") as ho, \
            Timed(accelpipe, "fused_spectra_slice") as fu:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0:
        fail(f"the spectral sweep stage exited {rc}")
    summary = ho.result
    if summary["series_host_bytes"] != 0 or summary["regime"] != "stitched":
        fail(f"the spectral stage copied series to the host: {summary}")
    if glob.glob(out + "_DM*.dat"):
        fail("the spectral stage wrote .dat files")
    stage = os.path.join(tmp, "stage")
    n = same_bytes(sorted(glob.glob(stage + "_DM*_ACCEL_200.*cand")), stage,
                   out)
    if n != 2 * STAGE_DMS:
        fail(f"phase 6 left {n} candidate files, not {2 * STAGE_DMS}")
    hits = accel_hits(f"{out}_DM70.00_ACCEL_200.cand", info)
    if not hits:
        fail("the spectral stage's DM-70 table holds no harmonic with "
             "|z| <= 2 and sigma > 10")
    accel_s = ho.seconds - fu.seconds
    numbers = dict(
        wall_s=wall, phase6_wall_s=stage_s, single_pulse_s=sp.seconds,
        fused_slice_s=fu.seconds, accel_s=accel_s,
        spectra_per_s=STAGE_DMS / accel_s,
        phase6_spectra_per_s=stage_numbers["spectra_per_s"],
        phase6_series_s=stage_numbers["series_s"],
        series_host_bytes=summary["series_host_bytes"],
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
        cand_files_equal=n, dm70_best=hits[:3], launches=launches,
        launches_fused_slice=dict(fu.launches))
    print("spectral stage: " + json.dumps(numbers))
    return launches


def decimated_regime(tmp, fn, info):
    """Phase 9 (c): the decimated regime (Fourier engine, one chunk) over
    the same 16 trials; the pulsar must be found, and the candidates that
    the stitched run does not match are counted (the boundary semantics
    differ by design)."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fourier.accelsearch import AccelSearchConfig
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands
    from pypulsar_tpu_torch.parallel import accelpipe

    out = os.path.join(tmp, "decimated")
    dms = STAGE_LODM + 1.0 * np.arange(STAGE_DMS)
    cfg = AccelSearchConfig(zmax=200.0, dz=2.0, numharm=8, sigma_min=2.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    with FilterbankFile(fn) as r, \
            Timed(accelpipe, "fused_spectra_slice") as fu:
        t0 = time.perf_counter()
        summary = accelpipe.sweep_accel_stream(
            r, dms, cfg, out, batch=32, nsub=64, group_size=0,
            engine="fourier", chunk_payload=info["nsamp"], spectral=True,
            specfuse_mode="decimate", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    if summary["regime"] != "decimated" or summary["n_searched"] != STAGE_DMS:
        fail(f"the decimated regime did not run: {summary}")
    hits = accel_hits(f"{out}_DM70.00_ACCEL_200.cand", info)
    if not hits:
        fail("the decimated regime's DM-70 table holds no harmonic with "
             "|z| <= 2 and sigma > 10")
    floor = cfg.sigma_min + 0.5
    n_unmatched = n_cands = 0
    stitched = os.path.join(tmp, "spectral")
    for dm in dms:
        a = read_rzwcands(f"{out}_DM{dm:.2f}_ACCEL_200.cand")
        b = read_rzwcands(f"{stitched}_DM{dm:.2f}_ACCEL_200.cand")
        n_cands += len(a)
        for x, pool in ((a, b), (b, a)):
            n_unmatched += sum(
                1 for c in x if c.sig > floor and not any(
                    abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
                    and abs(c.sig - o.sig) < 0.5 for o in pool))
    numbers = dict(wall_s=wall, fused_slice_s=fu.seconds,
                   accel_s=wall - fu.seconds,
                   spectra_per_s=STAGE_DMS / (wall - fu.seconds),
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                   candidates=n_cands, unmatched_vs_stitched=n_unmatched,
                   dm70_best=hits[:3], launches=launches)
    print("decimated regime: " + json.dumps(numbers))
    torch.cuda.empty_cache()
    return launches


def spectral_chain(tmp, info, device, chain):
    """Phase 9 (d): the survey chain with ``accel_spectral=True`` on phase
    8's RFI copy: each ``.cand`` must have phase 8's bytes, the pulsar
    must fold to SNR > 10 from the raw-file stream, and a journalled rerun
    of the sweep stage must redo nothing."""
    import torch

    from pypulsar_tpu_torch.parallel import accelpipe, staged
    from pypulsar_tpu_torch.survey import dag
    from pypulsar_tpu_torch.survey.state import Observation

    os.makedirs(os.path.join(tmp, "chain_spectral"))
    obs = Observation("rfi", chain["rfi"],
                      os.path.join(tmp, "chain_spectral", "rfi"))
    cfg = dag.SurveyConfig(**CHAIN_CFG, accel_spectral=True)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walls = dag.run_observation(obs, cfg, device=device)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    launches = launch_counts()
    need = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats",
            "fold_parts_poly")
    if min(launches[k] for k in need) < 1:
        fail(f"the spectral chain did not launch every kernel: {launches}")
    if glob.glob(obs.outbase + "_DM*.dat"):
        fail("the spectral chain wrote .dat files")
    n = same_bytes(sorted(glob.glob(chain["outbase"]
                                    + "_DM*_ACCEL_200.*cand")),
                   chain["outbase"], obs.outbase)
    with open(obs.outbase + "_foldbatch.json") as f:
        results = json.load(f)["results"]
    with open(obs.outbase + "_snr.json") as f:
        snr = {row["name"]: row["snr"] for row in json.load(f)}
    psr = info["period_samples"] * info["tsamp"]
    hits = [dict(name=r["name"], dm=r["dm"], period=r["period"],
                 snr=snr.get(r["name"])) for r in results
            if harmonic_of(r["period"], psr) is not None
            and abs(r["dm"] - 70.0) <= 2.0 and (snr.get(r["name"]) or 0) > 10]
    if not hits:
        fail("no spectral-chain candidate within 2 DM of 70 at the pulsar's "
             "period or a harmonic folds to SNR > 10")
    sweep = next(s for s in dag.build_dag(cfg) if s.name == "sweep")
    arts = [p for s in dag.build_dag(cfg) for p in s.outputs(obs, cfg)]
    before = sha256s(arts)
    with Timed(staged, "sweep_flat") as sp, \
            Timed(accelpipe, "fused_spectra_slice") as fu, \
            Timed(accelpipe, "accel_search_batch") as srch:
        t0 = time.perf_counter()
        sweep.execute(obs, cfg, device=device)
        rerun_s = time.perf_counter() - t0
    if sp.calls or fu.calls or srch.calls:
        fail(f"the spectral chain's journalled rerun redid work: "
             f"{sp.calls} sweeps, {fu.calls} fused slices, {srch.calls} "
             f"searches")
    if sha256s(arts) != before:
        fail("the spectral chain's rerun changed an artifact's bytes")
    best = max(hits, key=lambda h: h["snr"])
    print("spectral chain: " + json.dumps({
        "stage_wall_s": walls, "chain_wall_s": chain_s,
        "phase8_stage_wall_s": chain["walls"],
        "cand_files_equal_phase8": n, "pulsar": best,
        "pulsar_rows_found": len(hits), "rerun_sweep_s": rerun_s,
        "artifacts": len(arts), "launches": launches}))
    return launches


def ddplan_path(tmp, fn):
    """Phase 9 (e): ``cli.sweep --ddplan --lodm 0 --hidm 512`` on the
    phase-4 file: the pulsar within one step's dDM of DM 70, and every
    step through both gather-sum stages and boxcar."""
    import argparse

    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged

    out = os.path.join(tmp, "ddplan")
    argv = [fn, "--ddplan", "--lodm", "0", "--hidm", "512", "--nsub", "64",
            "-o", out, "--device", "cuda"]
    with FilterbankFile(fn) as r:
        plan = cli.make_ddplan(r, argparse.Namespace(
            lodm=0.0, hidm=512.0, plan_numsub=0, resolution=0.0))
    per_step = []
    real = staged.run_step

    def counted(*a, **kw):  # each step's launches and wall
        before = collections.Counter(launch_counts())
        t0 = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        per_step.append(dict(wall_s=time.perf_counter() - t0, launches=dict(
            collections.Counter(launch_counts()) - before)))
        return res

    reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    staged.run_step = counted
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        staged.run_step = real
    launches = launch_counts()
    if rc != 0:
        fail(f"sweep --ddplan exited {rc}")
    if len(per_step) != len(plan.DDsteps):
        fail(f"{len(per_step)} steps swept, the plan has "
             f"{len(plan.DDsteps)}")
    for i, st in enumerate(per_step):
        if min(st["launches"].get(k, 0) for k in SWEEP_KERNELS) < 1:
            fail(f"DDplan step {i} did not launch {SWEEP_KERNELS}: "
                 f"{st['launches']}")
    with open(out + ".cands") as f:
        rows = [ln.split() for ln in f.read().splitlines()[1:]]
    if not rows:
        fail("the DDplan sweep wrote no candidates")
    best = max(rows, key=lambda r: float(r[1]))
    dm = float(best[0])
    step = next(s for s in plan.DDsteps if s.loDM <= dm < s.hiDM)
    if abs(dm - 70.0) > step.dDM:
        fail(f"the DDplan's best candidate is at DM {dm}, more than one "
             f"step ({step.dDM}) from 70")
    print("ddplan: " + json.dumps({
        "steps": [dict(lo_dm=float(s.loDM), hi_dm=float(s.hiDM),
                       ddm=float(s.dDM), downsamp=int(s.downsamp),
                       numdms=int(s.numDMs)) for s in plan.DDsteps],
        "trials": int(sum(s.numDMs for s in plan.DDsteps)), "wall_s": wall,
        "per_step": per_step, "best": {"dm": dm, "snr": float(best[1]),
                                        "downsamp": int(best[5])},
        "launches": launches}))
    return launches


# ---------------------------------------------------------------------------
# phase 10: prepfold and the archive folds (the channel fold kernel)
# ---------------------------------------------------------------------------

# the JAX package's fold benchmark (bench.py:1540-1640): fold_parts over a
# [1024, 2^20] float32 block, 128 bins, 64 partitions
CHAN_C, CHAN_T, CHAN_NBINS, CHAN_NPART = 1024, 1 << 20, 128, 64
# tests/test_timing.py's injected pulsar, at the benchmark's size
CHAN_DT, CHAN_P_TRUE = 1e-3, 0.512
CHAN_P_FOLD = CHAN_P_TRUE * (1 + 2.0e-5)


def compare_chan(what, d, b, nbins, npart):
    """The channel kernel against its plain version on the card: counts
    exact, profiles rtol 1e-5 / atol 1e-3, and a second call the same bits;
    returns (profiles, counts, max abs err)."""
    import torch

    from pypulsar_tpu_torch.ops import fold

    got_p, got_c = fold.fold_chan(d, b, nbins, npart)
    again_p, again_c = fold.fold_chan(d, b, nbins, npart)
    want_p, want_c = fold._torch_fold_chan(d, b, nbins, npart)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, again_p) and torch.equal(got_c, again_c)):
        fail(f"fold_chan {what}: two calls gave different bits")
    if not torch.equal(got_c, want_c):
        fail(f"fold_chan {what}: counts differ from the plain version")
    err = float((got_p - want_p).abs().max()) if got_p.numel() else 0.0
    if not torch.allclose(got_p, want_p, rtol=1e-5, atol=1e-3):
        fail(f"fold_chan {what}: profiles differ from the plain version "
             f"(max abs err {err:.3g})")
    return got_p, got_c, err


def alone_in_block(what, d, b, nbins, npart, got, chans):
    """Each channel of ``chans`` folded alone (C = 1) must have the bits of
    the same channel inside the block's fold ``got``."""
    import torch

    from pypulsar_tpu_torch.ops import fold

    for c in chans:
        alone, _ = fold.fold_chan(d[c:c + 1], b, nbins, npart)
        if not torch.equal(alone[:, 0], got[:, c]):
            fail(f"fold_chan {what}: channel {c} alone differs from the same "
                 f"channel inside the block")


def chan_block(device):
    """The resident [1024, 2^20] block (seeded on the card) with the
    injected pulsar of tests/test_timing.py, and its bins at the off fold
    period, on the card."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fold.engine import phase_to_bins

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    data = torch.randn((CHAN_C, CHAN_T), generator=gen, device=device)
    t = np.arange(CHAN_T) * CHAN_DT
    pulse = (np.abs(((t / CHAN_P_TRUE) % 1.0) - 0.5) < 0.02)
    data += 0.6 * torch.from_numpy(pulse.astype(np.float32)).to(device)
    bins = torch.from_numpy(phase_to_bins(t / CHAN_P_FOLD, CHAN_NBINS)).to(
        device)
    return data, bins


def check_fold_chan(device, report, data, bins):
    """Phase 10 (a): the channel kernel against its plain version at the
    benchmark's size (resident), prepfold's default block and the widest
    archive, then the edge cases; each channel alone against the same
    channel in the block; timed beside its bound, its plain version and
    the faster library call (one index_add_ over the flattened cube, or
    one torch.bmm with the one-hot)."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fold import engine
    from pypulsar_tpu_torch.ops import fold

    C, T, nbins, npart = CHAN_C, CHAN_T, CHAN_NBINS, CHAN_NPART
    P = T // npart
    profs, counts, err = compare_chan("benchmark block", data, bins, nbins,
                                      npart)
    alone_in_block("benchmark block", data, bins, nbins, npart, profs,
                   (0, 1, 31, 32, 33, C // 2, C - 2, C - 1))
    rng = np.random.default_rng(SEED + 10)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    shapes = {}
    for label, (sc, st, snb) in (("prepfold default [32, 32768], 64 bins",
                                  (32, 32768, 64)),
                                 ("widest archive [1024, 16384], 128 bins",
                                  (1024, 16384, 128))):
        sd = torch.randint(0, 256, (sc, st), generator=gen, device=device
                           ).to(torch.float32)
        sb = torch.from_numpy(rng.integers(0, snb, st, dtype=np.int32)).to(
            device)
        sp, _, serr = compare_chan(label, sd, sb, snb, 1)
        alone_in_block(label, sd, sb, snb, 1, sp, range(sc) if sc <= 32
                       else (0, 1, 7, 8, 9, 31, 32, sc // 2, sc - 2, sc - 1))
        nbytes = 4.0 * sc * st + 4.0 * st + 4.0 * sc * snb + 4.0 * snb
        bms, by = bound(nbytes, float(sc) * st)
        # the library yardstick at this block: one torch.bmm with the
        # one-hot (built beforehand, as at the benchmark's size; one
        # partition, so a batch of one)
        s_onehot = (sb[:, None] == torch.arange(
            snb, device=device, dtype=torch.int32)).to(torch.float32)[None]
        s_lib_err = float((torch.bmm(sd[None], s_onehot) - sp).abs().max())
        shapes[label] = dict(
            ms=cuda_time_ms(lambda: fold.fold_chan(sd, sb, snb, 1)),
            single_call_ms=single_call_ms(lambda: fold.fold_chan(sd, sb, snb,
                                                                 1)),
            graph_ms=graph_ms(lambda: fold.fold_chan(sd, sb, snb, 1)),
            layout=fold.chan_plan(st, snb, sc, 1)._asdict(),
            plain_ms=cuda_time_ms(lambda: fold._torch_fold_chan(
                sd, sb, snb, 1), reps=3),
            bound_ms=bms, bound_by=by, max_abs_err=serr,
            library_ms=cuda_time_ms(lambda: torch.bmm(sd[None], s_onehot)),
            library_graph_ms=graph_ms(lambda: torch.bmm(sd[None],
                                                        s_onehot)),
            library_call="torch.bmm with the one-hot",
            library_max_abs_diff=s_lib_err)
        del sd, sb, sp, s_onehot
    done = []
    # (what, data, bins, nbins, npart): padding and negative indices; one
    # bin; the largest nbins; T not a multiple of npart; partitions past
    # the reference's 2^17-sample block seam; a channel count off the
    # tile; views whose rows start 4 bytes past a 16-byte boundary
    base = torch.randn((37, 3 * (1 << 17) + 7), generator=gen, device=device)
    nT = base.shape[1]
    wild = torch.from_numpy(rng.integers(-3, 70, nT, dtype=np.int32)).to(
        device)
    cases = [
        ("padding and negative indices", base[:, :40000], wild[:40000], 64,
         8),
        ("nbins 1", base[:, :40000], torch.zeros(40000, dtype=torch.int32,
                                                 device=device), 1, 4),
        (f"nbins {fold.MAX_CHAN_NBINS}", base[:5, :30000], torch.from_numpy(
            rng.integers(0, fold.MAX_CHAN_NBINS, 30000,
                         dtype=np.int32)).to(device), fold.MAX_CHAN_NBINS, 2),
        ("T 100003 over 7 partitions", base[:, :100003], wild[:100003], 64,
         7),
        ("partitions of 196611 samples (past 2^17)", base, wild.remainder(
            64).to(torch.int32), 64, 2),
        ("37 channels (off the 32-channel tile)", base[:, :65536],
         wild[:65536], 50, 4),
        ("views at +1 float", base[:, 1:50001], wild[1:50001], 64, 5),
        # a partition shorter than one segment; a partition off a multiple
        # of the segment; one channel at prepfold's partition
        ("partitions of 100 samples (under one segment)", base[:, :300],
         wild[:300], 64, 3),
        ("a partition of 5003 samples (off the segment)", base[:, :5003],
         wild[:5003], 64, 1),
        ("C = 1 at prepfold's partition of 32768", base[:1, :32768],
         wild[:32768].remainder(64).to(torch.int32), 64, 1),
    ]
    for what, ed, eb, enb, enp in cases:
        ep, _, e_err = compare_chan(what, ed, eb, enb, enp)
        alone_in_block(what, ed, eb, enb, enp, ep, range(ed.shape[0]))
        plan = fold.chan_plan(ed.shape[1] // enp, enb, ed.shape[0], enp)
        done.append(f"{what}: {plan.nseg} segments of {plan.seg_len} x "
                    f"{plan.nsub} sub-stretches, {plan.ct} channels a block, "
                    f"max abs err {e_err:.3g}")
    try:
        fold.fold_chan(base[:2, :1000], wild[:1000], fold.MAX_CHAN_NBINS + 1,
                       1)
    except ValueError as e:
        done.append(f"nbins {fold.MAX_CHAN_NBINS + 1} refused ({e})")
    else:
        fail("fold_chan launched past its largest nbins")
    # C = 1 against the 1-D fold_bins, and the 1-D fold_bins against row c
    # of the 2-D fold_bins: bit for bit
    two_p, two_c = engine.fold_bins(base[:, :70001], wild[:70001], 64)
    for c in (0, 17, 36):
        one_p, one_c = engine.fold_bins(base[c, :70001], wild[:70001], 64)
        c1_p, _ = fold.fold_chan(base[c:c + 1, :70001], wild[:70001], 64, 1)
        if not (torch.equal(one_p, c1_p[0, 0]) and torch.equal(one_p, two_p[c])
                and torch.equal(one_c, two_c)):
            fail(f"fold_bins: the 1-D fold of channel {c} is not the bits of "
                 f"the C = 1 fold and of row {c} of the 2-D fold")
    done.append("1-D fold_bins == C = 1 == row of the 2-D fold, bit for bit")
    del base, wild, two_p
    # one fold_bins chunk of a few channels: thousands of segments merged
    n8 = engine._BINS_CHUNK
    d8 = torch.randn((3, n8), generator=gen, device=device)
    b8 = torch.from_numpy(rng.integers(-1, 65, n8, dtype=np.int32)).to(device)
    p8, c8, e8 = compare_chan(f"one fold_bins chunk [3, {n8}]", d8, b8, 64, 1)
    alone_in_block("one fold_bins chunk", d8, b8, 64, 1, p8, range(3))
    f8_p, f8_c = engine.fold_bins(d8, b8, 64)
    if not (torch.equal(f8_p, p8[0]) and torch.equal(f8_c, c8[0])):
        fail("fold_bins at one chunk is not the bits of the channel fold")
    plan = fold.chan_plan(n8, 64, 3, 1)
    done.append(f"one fold_bins chunk [3, {n8}]: {plan.nseg} segments merged, "
                f"max abs err {e8:.3g}, fold_bins the same bits")
    del d8, b8, p8
    # the kernel timed on the resident block, beside its plain version and
    # the library calls
    ms = cuda_time_ms(lambda: fold.fold_chan(data, bins, nbins, npart))
    single_ms = single_call_ms(lambda: fold.fold_chan(data, bins, nbins,
                                                      npart))
    replay_ms = graph_ms(lambda: fold.fold_chan(data, bins, nbins, npart))
    plain_ms = cuda_time_ms(lambda: fold._torch_fold_chan(
        data, bins, nbins, npart), reps=3)
    cols = torch.arange(nbins, device=device, dtype=torch.int32)
    onehot = (bins.view(npart, P)[:, :, None] == cols).to(torch.float32)
    parts = data.view(C, npart, P).permute(1, 0, 2)  # [npart, C, P] view
    bmm_ms = cuda_time_ms(lambda: torch.bmm(parts, onehot), reps=3)
    bmm_err = float((torch.bmm(parts, onehot) - profs).abs().max())
    del onehot
    flat = ((torch.arange(T, device=device) // P * C)[None, :]
            + torch.arange(C, device=device)[:, None])
    flat.mul_(nbins).add_(bins.long()[None, :])  # [C, T]: 8.6 GB of int64
    buf = torch.zeros(npart * C * nbins, device=device)
    src = data.reshape(-1)
    index_add_ms = cuda_time_ms(lambda: buf.index_add_(
        0, flat.view(-1), src), reps=3)
    buf.zero_().index_add_(0, flat.view(-1), src)
    ia_err = float((buf.view(npart, C, nbins) - profs).abs().max())
    del flat, buf
    torch.cuda.empty_cache()
    library = min((bmm_ms, "torch.bmm with the one-hot"),
                  (index_add_ms, "index_add_ over the flattened cube"))
    nbytes = 4.0 * C * T + 4.0 * T + 4.0 * npart * C * nbins \
        + 4.0 * npart * nbins
    bms, by = bound(nbytes, float(C) * npart * P)
    plan = fold.chan_plan(P, nbins, C, npart)
    report.append(dict(
        name="fold_chan", route="cuda",
        source="pypulsar_tpu_torch/ops/csrc/fold_chan.cu",
        replaces="pypulsar_tpu/fold/engine.py:76",
        shape=f"data [{C}, {T}] float32 (resident), bin_idx [{T}] int32, "
              f"nbins {nbins}, npart {npart} -> [{npart}, {C}, {nbins}]; "
              f"{plan.nseg} segments of {plan.seg_len} x {plan.nsub} "
              f"sub-stretches, {plan.ct} channels a block",
        layout=plan._asdict(),
        max_abs_err=err, ms=ms, single_call_ms=single_ms, graph_ms=replay_ms,
        plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=library[0],
        library_call=library[1], library_ms_by_call={
            "torch.bmm": bmm_ms, "index_add_": index_add_ms},
        ms_by_shape=shapes))
    print(f"fold_chan: [{C}x{T}] -> [{npart}x{C}x{nbins}]: kernel {ms:.4f} "
          f"ms (single calls {single_ms:.4f} ms, graph replays {replay_ms:.4f} "
          f"ms), "
          f"plain {plain_ms:.3f} ms, "
          f"bound {bms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB), share "
          f"{bms / ms:.3f}; library {library[1]} {library[0]:.4f} ms "
          f"(bmm {bmm_ms:.4f} ms, max abs diff {bmm_err:.3g}; index_add_ "
          f"{index_add_ms:.4f} ms, max abs diff {ia_err:.3g}); max abs err "
          f"{err:.3g}, counts exact, two calls the same bits; 8 channels "
          f"alone == in the block; layout {json.dumps(plan._asdict())}; "
          + json.dumps(shapes) + "; " + "; ".join(done))
    return profs, counts


def archive_fold(device, data, bins):
    """Phase 10 (b): fold_stats and fold_snr_stats at the benchmark's size
    on the card: SNR > 10, the refined period within tests/test_timing.py's
    bound, and fold_stats within that test's tolerances of the same
    statistics over the plain version's cube. Returns the launches."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.fold import engine
    from pypulsar_tpu_torch.ops import fold

    C, T, nbins, npart = CHAN_C, CHAN_T, CHAN_NBINS, CHAN_NPART
    T_sec = npart * (T // npart) * CHAN_DT
    dps, off = engine.bestprof_offsets(npart, T_sec, CHAN_P_FOLD)
    off_dev = torch.from_numpy(off).to(device)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = engine.fold_stats(data, bins, nbins, npart, off_dev)
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = engine.fold_snr_stats(data, bins, nbins, npart, CHAN_DT,
                                CHAN_P_FOLD)
    snr_s = time.perf_counter() - t0
    launches = launch_counts()
    want = engine.archive_stats(*fold._torch_fold_chan(data, bins, nbins,
                                                       npart),
                                data, npart, off_dev)
    names = ("part_profs", "chan_profs", "counts", "dsum", "dsumsq",
             "dp_profs")
    errs = {}
    for name, g, w, tol in zip(names, got, want, (1e-4,) * 3 + (2e-4,) * 3):
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        errs[name] = float(np.abs(g - w).max())
        # the rotated profiles mix every bin through an rfft: float32
        # rounding of the largest (on-pulse) bins, ~1e-7 of 5e6 here,
        # lands in every bin, so their rtol is taken of the largest
        # magnitude, as tests/test_torch_fold.py takes refine_chi2's
        scale = np.abs(w).max() if name == "dp_profs" else np.abs(w)
        if not (np.abs(g - w) <= 1e-2 + tol * scale).all():
            fail(f"fold_stats {name} differs from the plain version's "
                 f"(max abs err {errs[name]:.3g})")
    if not res["snr"] > 10:
        fail(f"fold_snr_stats: SNR {res['snr']:.2f} at the benchmark's size")
    dgrid = dps[1] - dps[0]
    if abs(res["best_period"] - CHAN_P_TRUE) > \
            (CHAN_P_FOLD - CHAN_P_TRUE) * 0.3 + dgrid:
        fail(f"fold_snr_stats: refined period {res['best_period']!r}, true "
             f"{CHAN_P_TRUE}")
    print("archive fold: " + json.dumps({
        "shape": [C, T, nbins, npart], "fold_stats_s": stats_s,
        "fold_snr_stats_s": snr_s, "snr": res["snr"],
        "best_period": res["best_period"], "true_period": CHAN_P_TRUE,
        "fold_period": CHAN_P_FOLD, "grid_step": dgrid,
        "max_abs_err_vs_plain": errs, "launches": launches}))
    return launches


PFD_PROFILES = ("profs", "sumprof")


def pfd_mismatch(a_fn, b_fn):
    """Where two .pfd files break the prepfold contract of the CPU tests:
    every header field equal, profiles rtol 1e-5 / atol 1e-3, stats means
    and variances rtol 1e-5 and their counts exact. [] when they keep it."""
    import numpy as np

    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    a, b = vars(PfdFile(a_fn)), vars(PfdFile(b_fn))
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        if k == "pfd_filename":
            continue
        if k in PFD_PROFILES:
            ok = np.allclose(a[k], b[k], rtol=1e-5, atol=1e-3)
        elif k == "stats":
            ok = (np.array_equal(a[k][..., (0, 3, 6)], b[k][..., (0, 3, 6)])
                  and np.allclose(a[k][..., (1, 2, 4, 5)],
                                  b[k][..., (1, 2, 4, 5)], rtol=1e-5))
        elif k == "varprof":
            ok = abs(a[k] - b[k]) <= 1e-5 * abs(b[k])
        elif isinstance(a[k], np.ndarray):
            ok = np.array_equal(a[k], b[k])
        else:
            ok = a[k] == b[k]
        if not ok:
            bad.append(k)
    return bad


def snr_of(pfd_fn):
    """SNR of one archive through ``cli.pfd_snr --json`` (dedispersed at
    its bestdm)."""
    from pypulsar_tpu_torch.cli import pfd_snr

    out = pfd_fn + "_snr.json"
    if pfd_snr.main([pfd_fn, "--json", out]) != 0:
        fail(f"pfd_snr exited non-zero on {pfd_fn}")
    with open(out) as f:
        return json.load(f)[0]["snr"] or 0.0


def prepfold_path(tmp, fn, info):
    """Phase 10 (c): ``cli.prepfold -p 0.262144 --dm 70`` on phase 4's file
    at prepfold's defaults and at ``--nsub 1024 -n 128 --npart 64``; each
    writes its .pfd, folds the pulsar to SNR > 10, and the default run
    keeps the prepfold contract against ``--device cpu``; the wide
    archive summed over subbands (and its bins and partitions paired) is
    the default's, at rtol 1e-5. Returns the default run's launches."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import prepfold
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    period = info["period_samples"] * info["tsamp"]
    base = [fn, "-p", repr(period), "--dm", "70"]
    runs = {}
    for label, extra in (("default", []),
                         ("nsub1024", ["--nsub", "1024", "-n", "128",
                                       "--npart", "64"])):
        out = os.path.join(tmp, f"prepfold_{label}.pfd")
        reset_launch_counts()
        torch.cuda.synchronize()
        with Timed(prepfold, "_fil_block") as blk, \
                Timed(FilterbankFile, "_read_raw_block") as rd:
            t0 = time.perf_counter()
            rc = prepfold.main(base + extra + ["-o", out, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
        if rc != 0 or not os.path.exists(out):
            fail(f"prepfold {label} exited {rc}")
        snr = snr_of(out)
        if not snr > 10:
            fail(f"prepfold {label}: the pulsar folds to SNR {snr}")
        runs[label] = dict(
            wall_s=wall, samples_per_s=1024 * info["nsamp"] / wall,
            read_s=rd.seconds, read_h2d_convert_s=blk.seconds,
            host_share=blk.seconds / wall, blocks=blk.calls, snr=snr,
            launches=launches, pfd=out)
    if runs["default"]["launches"]["fold_chan"] != 32 or \
            runs["nsub1024"]["launches"]["fold_chan"] != 64:
        fail(f"prepfold did not launch fold_chan once a partition: "
             f"{ {k: v['launches'] for k, v in runs.items()} }")
    cpu_out = os.path.join(tmp, "prepfold_cpu.pfd")
    t0 = time.perf_counter()
    if prepfold.main(base + ["-o", cpu_out, "--device", "cpu"]) != 0:
        fail("prepfold --device cpu exited non-zero")
    cpu_s = time.perf_counter() - t0
    bad = pfd_mismatch(runs["default"]["pfd"], cpu_out)
    if bad:
        fail(f"prepfold on the card breaks the contract against --device "
             f"cpu in {bad}")
    wide = PfdFile(runs["nsub1024"]["pfd"]).profs.sum(axis=1)  # [64, 128]
    wide = wide.reshape(32, 2, 64, 2).sum(axis=(1, 3))
    narrow = PfdFile(runs["default"]["pfd"]).profs.sum(axis=1)  # [32, 64]
    if not np.allclose(wide, narrow, rtol=1e-5):
        fail(f"prepfold --nsub 1024: the archive summed over subbands is not "
             f"the default's (max rel diff "
             f"{float(np.abs(wide / narrow - 1).max()):.3g})")
    print("prepfold: " + json.dumps({
        **{k: {kk: vv for kk, vv in v.items() if kk != "pfd"}
           for k, v in runs.items()},
        "cpu_s": cpu_s, "wide_vs_default_max_abs": float(
            np.abs(wide - narrow).max())}))
    return runs["default"]["launches"]


def write_spindown_dat(tmp, n, dt, f0, f1, width, seed):
    """A barycentred ``.dat`` (and its ``.inf``) of n samples: unit noise
    plus a unit pulse of Gaussian ``width`` turns whose phase follows the
    spin-down ``f0 t + f1 t^2 / 2``."""
    import numpy as np

    from pypulsar_tpu_torch.io.infodata import InfoData

    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    phase = f0 * t + 0.5 * f1 * t * t
    ts = rng.standard_normal(n).astype(np.float32)
    ts += np.exp(-0.5 * (((phase % 1.0) - 0.5) / width) ** 2).astype(
        np.float32)
    base = os.path.join(tmp, "spindown")
    inf = InfoData()
    inf.basenm, inf.telescope, inf.object = "spindown", "Fake", "PARFOLD"
    inf.epoch, inf.bary, inf.N, inf.dt = 55000.0, 1, n, dt
    inf.lofreq, inf.BW, inf.numchan, inf.chan_width = 1400.0, 100.0, 1, 100.0
    inf.to_file(base + ".inf")
    ts.tofile(base + ".dat")
    return base + ".dat"


def prepfold_par(tmp):
    """Phase 10 (d): ``prepfold --par`` on a barycentred 2^20-sample .dat
    of 64 us samples with a strong spin-down: the ephemeris fold's
    profile contrast above 1.5 x the constant-period fold's, and
    ``curr_p2`` within 10% of ``-f1 / f0^2``. Returns the --par run's
    launches.

    tests/test_cli_prepfold.py's construction at this size, with two
    changes that keep the contrast test decisive rather than left to the
    noise: the constant-period fold drifts 112 turns (f1 = -0.05 Hz/s,
    not 13), so it smears into the noise instead of keeping a peak where
    the drift is slow, and the pulse is 0.01 turns wide (not 0.03), so
    the ephemeris fold's peak stands well out of its own profile."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.cli import prepfold
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    n, dt, f0, f1 = 1 << 20, 64e-6, 19.37, -0.05
    dat = write_spindown_dat(tmp, n, dt, f0, f1, 0.01, SEED + 12)
    par = os.path.join(tmp, "spindown.par")
    with open(par, "w") as f:
        f.write(f"PSR J0000+0000\nF0 {f0}\nF1 {f1}\nPEPOCH 55000.0\n"
                f"DM 12.5\n")
    par_pfd = os.path.join(tmp, "spindown_par.pfd")
    const_pfd = os.path.join(tmp, "spindown_const.pfd")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = prepfold.main([dat, "--par", par, "-o", par_pfd, "--device",
                        "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0 or prepfold.main([dat, "-p", repr(1.0 / f0), "-o", const_pfd,
                                 "--device", "cuda"]) != 0:
        fail("prepfold --par or -p exited non-zero on the spin-down .dat")

    def contrast(fn):
        prof = PfdFile(fn).sumprof
        return float((prof.max() - np.median(prof)) / max(prof.std(), 1e-9))

    c_par, c_const = contrast(par_pfd), contrast(const_pfd)
    pd = PfdFile(par_pfd).curr_p2
    want_pd = -f1 / f0 ** 2
    if not c_par > 1.5 * c_const:
        fail(f"prepfold --par: contrast {c_par:.3f} against the constant "
             f"period's {c_const:.3f}")
    if not abs(pd - want_pd) < 0.1 * abs(want_pd):
        fail(f"prepfold --par: curr_p2 {pd!r}, want {want_pd!r}")
    if launches["fold_chan"] < 1:
        fail(f"prepfold --par launched no fold_chan: {launches}")
    print("prepfold --par: " + json.dumps({
        "samples": n, "dt": dt, "wall_s": wall, "contrast_par": c_par,
        "contrast_const": c_const, "curr_p2": pd, "want_p2": want_pd,
        "launches": launches}))
    return launches


def prepfold_cands(tmp, fn):
    """Phase 10 (e): ``prepfold --cands`` on phase 7's sifted list with
    phase 7's fold flags: each archive the bytes of ``cli.foldbatch`` run
    with the argv prepfold builds. Returns the --cands run's launches."""
    import torch

    from pypulsar_tpu_torch.cli import foldbatch, prepfold

    sifted = os.path.join(tmp, "fold.accelcands")
    argv = [fn, "--cands", sifted, "-n", str(FOLD_NBINS), "--npart",
            str(FOLD_NPART), "--device", "cuda"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = prepfold.main(argv + ["-o", os.path.join(tmp, "pcands.pfd")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0:
        fail(f"prepfold --cands exited {rc}")
    fargv = prepfold.batch_argv(prepfold.build_parser().parse_args(
        argv + ["-o", os.path.join(tmp, "fcands.pfd")]))
    if foldbatch.main(fargv) != 0:
        fail("foldbatch with prepfold's argv exited non-zero")
    made = sorted(glob.glob(os.path.join(tmp, "pcands_*.pfd")))
    if not made:
        fail("prepfold --cands wrote no archive")
    for p in made:
        twin = os.path.join(tmp, "fcands_" + os.path.basename(p)[
            len("pcands_"):])
        with open(p, "rb") as a, open(twin, "rb") as b:
            if a.read() != b.read():
                fail(f"prepfold --cands: {os.path.basename(p)} differs from "
                     f"foldbatch's archive")
    print("prepfold --cands: " + json.dumps({
        "archives": len(made), "wall_s": wall, "foldbatch_argv": fargv[1:],
        "launches": launches}))
    return launches


def prepfold_phase(tmp, fn, info, device, report):
    """Phase 10: (a) the channel kernel, (b) the archive folds at the
    benchmark's size, (c) prepfold on phase 4's file, (d) --par, (e)
    --cands. Returns the launches of each driven path."""
    import torch

    data, bins = chan_block(device)
    check_fold_chan(device, report, data, bins)
    archive = archive_fold(device, data, bins)
    del data, bins
    torch.cuda.empty_cache()
    return {"archive_fold": archive,
            "prepfold": prepfold_path(tmp, fn, info),
            "prepfold_par": prepfold_par(tmp),
            "prepfold_cands": prepfold_cands(tmp, fn)}


# ---------------------------------------------------------------------------
# phase 11: the batch broker's lane and the multi-series fold kernel
# ---------------------------------------------------------------------------

# a lane of 4 observations' series (phase 6's DM 70, 62, 66 and 77 .dat
# files), 32 candidates each, each series at its own sample time
MULTI_DMS, MULTI_DT_SCALE = (70.0, 62.0, 66.0, 77.0), (1.0, 2.0, 1.0, 0.5)
MULTI_ODD_T = 100003  # an odd series length: rows off a 16-byte boundary
# observation B of the lane: its own pulsar, the geometry of the phase-4
# file (a period that divides 2^20, so both files keep 2^20 samples)
LANE_B_DM, LANE_B_PERIOD, LANE_B_SEED = 62.0, 2048, SEED + 13
# the lane's broker window: the streamed sweep stage has ONE accel batch an
# observation (its 8 trials), so the first leader waits for its mate's; a
# leader closes at once when its mate is aboard or gone
LANE_WAIT_MS = 5000.0


def compare_multi(what, stack, sidx, coeffs, dts, bins, nbins, npart):
    """Both series-index forms at once: (a) the polynomial form bit for bit
    the array form fed numpy's bins; (b) each against its plain version
    (counts exact, profiles rtol 1e-5 / atol 1e-3); (c) row k the bits of
    the single-series form (``fold_parts_poly`` / ``fold_parts_batch``) of
    its own series alone. Returns (poly profiles, max abs err of the
    polynomial form, of the array form)."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import fold

    dev = stack.device
    got_p, got_c = fold.fold_parts_multi_poly(stack, sidx, coeffs, dts,
                                              nbins, npart)
    arr_p, arr_c = fold.fold_parts_multi(stack, sidx, bins, nbins, npart)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, arr_p) and torch.equal(got_c, arr_c)):
        fail(f"fold_parts_multi_poly {what}: not the bits of the array form "
             f"fed numpy's bins")
    errs = []
    for name, (gp, gc), (wp, wc) in (
            ("fold_parts_multi_poly", (got_p, got_c),
             fold._torch_fold_parts_multi_poly(
                 stack, sidx, torch.from_numpy(coeffs).to(dev), dts, nbins,
                 npart)),
            ("fold_parts_multi", (arr_p, arr_c),
             fold._torch_fold_parts_multi(stack, sidx, bins, nbins, npart))):
        if not torch.equal(gc, wc):
            fail(f"{name} {what}: counts differ from the plain version")
        err = float((gp - wp).abs().max())
        if not torch.allclose(gp, wp, rtol=1e-5, atol=1e-3):
            fail(f"{name} {what}: profiles differ from the plain version "
                 f"(max abs err {err:.3g})")
        errs.append(err)
    for g in range(stack.shape[0]):
        rows = np.nonzero(sidx == g)[0]
        rt = torch.from_numpy(rows).to(dev)
        sp, sc = fold.fold_parts_poly(stack[g], coeffs[rows], dts[g], nbins,
                                      npart)
        ap, ac = fold.fold_parts_batch(stack[g], bins[rt], nbins, npart)
        if not (torch.equal(got_p[rt], sp) and torch.equal(got_c[rt], sc)
                and torch.equal(arr_p[rt], ap) and torch.equal(arr_c[rt], ac)):
            fail(f"fold_parts_multi {what}: a row of series {g} is not the "
                 f"bits of the single-series form of that series alone")
    return got_p, errs[0], errs[1]


def check_fold_multi(device, report, stage, dt):
    """Phase 11 (a): both series-index forms of the fold kernel at a lane's
    size (G = 4 series of 2^20, K = 128, 32 a series, interleaved, 64
    bins, 32 partitions; f2 = 0 on two series, pdot and f2 != 0 on the
    others; a sample time per series) and at an odd T, against their plain
    versions and row by row against the single-series forms; the fused
    batch split in halves and each row alone the same bits; an index
    outside [0, G) refused; each form timed beside its bound, its plain
    version and one index_add_ after a gather of the rows."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.ops import fold

    stack_np = np.stack([np.fromfile(f"{stage}_DM{dm:.2f}.dat",
                                     dtype=np.float32) for dm in MULTI_DMS])
    G, T = stack_np.shape
    nbins, npart = FOLD_NBINS, FOLD_NPART
    dts = dt * np.asarray(MULTI_DT_SCALE)
    rng = np.random.default_rng(SEED + 12)
    periods = np.sort(np.append(np.geomspace(1.5e-3, 2.0, 31),
                                4096 * 64e-6))
    per = len(periods)
    table = []
    for g in range(G):
        p = rng.permutation(periods)
        if g % 2 == 0:
            table.append(fold_coeffs(p))
        else:
            table.append(fold_coeffs(
                p, rng.choice([-1.0, 1.0], per) * 10.0
                ** rng.uniform(-12, -9, per),
                rng.choice([-1.0, 1.0], per) * 10.0
                ** rng.uniform(-20, -16, per)))
    order = rng.permutation(G * per)  # a series' candidates apart
    sidx = np.repeat(np.arange(G), per)[order].astype(np.int32)
    coeffs = np.ascontiguousarray(np.concatenate(table)[order])
    K = len(sidx)
    bins_np = np.empty((K, T), np.int32)
    for g in range(G):
        rows = np.nonzero(sidx == g)[0]
        bins_np[rows] = fold_bins(T, dts[g], coeffs[rows], nbins)
    stack = torch.from_numpy(stack_np).to(device)
    bins = torch.from_numpy(bins_np).to(device)
    del bins_np
    profs, perr, aerr = compare_multi("lane size", stack, sidx, coeffs, dts,
                                      bins, nbins, npart)
    if not batch_invariant(lambda lo, hi: fold.fold_parts_multi_poly(
            stack, sidx[lo:hi], coeffs[lo:hi], dts, nbins, npart)[0], K):
        fail("fold_parts_multi_poly: a row changes with its split")
    odd = stack[:, :MULTI_ODD_T].contiguous()
    _, operr, oaerr = compare_multi(
        f"T {MULTI_ODD_T}", odd, sidx, coeffs, dts,
        bins[:, :MULTI_ODD_T].contiguous(), nbins, npart)
    try:
        fold.fold_parts_multi_poly(stack, np.array([G], np.int32),
                                   coeffs[:1], dts, nbins, npart)
    except ValueError:
        pass
    else:
        fail(f"fold_parts_multi_poly took a series index of {G} for a "
             f"{G}-series stack")
    P = T // npart
    # the library yardstick: one index_add_ of the same sums into a flat
    # [K * npart * nbins] buffer from precomputed flat indices, after a
    # gather of each candidate's row (profiles only, float atomics)
    sidx_dev = torch.from_numpy(sidx).to(device)
    rows_l = sidx_dev.long()
    t = torch.arange(npart * P, device=device)
    flat = ((torch.arange(K, device=device)[:, None] * npart + t // P)
            * nbins + bins[:, :npart * P].long()).reshape(-1)
    buf = torch.zeros(K * npart * nbins, device=device)

    def library():
        buf.index_add_(0, flat, stack[rows_l, :npart * P].reshape(-1))

    library_ms = cuda_time_ms(library)
    buf.zero_()
    library()
    lib_err = float((buf.reshape(K, npart, nbins) - profs).abs().max())
    del flat, buf, t
    c_dev = torch.from_numpy(coeffs).to(device)
    d_dev = torch.from_numpy(dts).to(device)
    out_bytes = 8.0 * K * npart * nbins
    forms = {}
    for name, call, wrapper, plain, nbytes, nops, rate, lib in (
            ("fold_parts_multi",
             lambda: fold._cuda_fold_parts_multi(stack, sidx_dev, bins,
                                                 nbins, npart),
             lambda: fold.fold_parts_multi(stack, sidx, bins, nbins, npart),
             lambda: fold._torch_fold_parts_multi(stack, sidx, bins, nbins,
                                                  npart),
             4.0 * K * T + 4.0 * G * T + 4.0 * K + out_bytes,
             float(K) * npart * P, FP32_OPS_PER_S, library_ms),
            ("fold_parts_multi_poly",
             lambda: fold._cuda_fold_parts_multi_poly(
                 stack, sidx_dev, c_dev, d_dev, nbins, npart),
             lambda: fold.fold_parts_multi_poly(stack, sidx, coeffs, dts,
                                                nbins, npart),
             lambda: fold._torch_fold_parts_multi_poly(
                 stack, sidx, c_dev, dts, nbins, npart),
             4.0 * G * T + 4.0 * K + 24.0 * K + 8.0 * G + out_bytes,
             fold_flops(coeffs, npart * P), FP64_OPS_PER_S, None)):
        bms, by = bound(nbytes, nops, rate)
        forms[name] = dict(
            ms=cuda_time_ms(call), single_call_ms=single_call_ms(call),
            wrapper_ms=cuda_time_ms(wrapper),
            plain_ms=cuda_time_ms(plain, reps=3), bound_ms=bms, bound_by=by,
            nbytes=nbytes, nops=nops, library_ms=lib)
    shape = (f"stack [{G}, {T}] (dts {MULTI_DT_SCALE} x {dt:g} s), K {K} "
             f"({per} a series, interleaved), nbins {nbins}, npart {npart}")
    for name, e, extra in (
            ("fold_parts_multi", aerr, f"bin_idx [{K}, {T}] int32"),
            ("fold_parts_multi_poly", perr,
             f"coeffs [{K}, 3] float64, f2 != 0 on 2 series")):
        f = forms[name]
        report.append(dict(
            name=name, route="cuda",
            source="pypulsar_tpu_torch/ops/csrc/fold_parts.cu",
            replaces="pypulsar_tpu/fold/engine.py:410",
            shape=f"{shape}, {extra}", max_abs_err=e, ms=f["ms"],
            single_call_ms=f["single_call_ms"], wrapper_ms=f["wrapper_ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=f["library_ms"],
            library_call=("index_add_ after a gather of the rows"
                          if f["library_ms"] is not None else None)))
        print(f"{name}: {shape}, {extra}: kernel {f['ms']:.4f} ms (single "
              f"calls {f['single_call_ms']:.4f} ms), wrapper "
              f"{f['wrapper_ms']:.4f} ms, plain {f['plain_ms']:.3f} ms, "
              f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}: "
              f"{f['nbytes'] / 1e9:.4f} GB, {f['nops'] / 1e9:.4f} G ops), "
              f"share {f['bound_ms'] / f['ms']:.3f}, max abs err {e:.3g}, "
              f"counts exact")
    print(f"fold multi forms: polynomial == array fed numpy's bins, each row "
          f"== its series' single-series fold (max abs diff 0), whole == "
          f"halves == alone; T {MULTI_ODD_T}: max abs err vs plain "
          f"{operr:.3g} / {oaerr:.3g}; index_add_ after a gather "
          f"{library_ms:.4f} ms (max abs diff {lib_err:.3g}); series index "
          f"{G} refused")
    del stack, bins, odd, profs, c_dev, d_dev, sidx_dev, rows_l
    torch.cuda.empty_cache()


def lane_hits(outbase, psr, dm):
    """Rows of an observation's fold summary within 2 DM of ``dm`` at the
    period ``psr`` or a harmonic that fold to SNR > 10 in its
    ``_snr.json``."""
    with open(outbase + "_foldbatch.json") as f:
        results = json.load(f)["results"]
    with open(outbase + "_snr.json") as f:
        snr = {row["name"]: row["snr"] for row in json.load(f)}
    return [dict(name=r["name"], dm=r["dm"], period=r["period"],
                 snr=snr.get(r["name"])) for r in results
            if harmonic_of(r["period"], psr) is not None
            and abs(r["dm"] - dm) <= 2.0 and (snr.get(r["name"]) or 0) > 10]


def snr_rows(path):
    """An ``_snr.json``'s rows with each archive path cut to its name."""
    with open(path) as f:
        rows = json.load(f)
    for r in rows:
        r["pfd"] = os.path.basename(r["pfd"])
    return rows


LANE_PATTERNS = ("_rfifind.mask", ".cands", "_DM*.dat", "_DM*.inf",
                 "_DM*_ACCEL_200.cand", "_DM*_ACCEL_200.txtcand",
                 ".accelcands", "_cand*.pfd")


def lane_phase(tmp, info, device, chain):
    """Phase 11 (b): a lane of 2 observations (``survey.lane.run_lane``)
    at the chain's size, phase 8's streamed configuration: A the RFI copy
    (held to phase 8's chain), B a second synthetic file with its own
    pulsar (held to its own serial ``run_observation``, whose outputs and
    wall phase 18 reuses: ``chain["serial_b"]``); then the same lane at
    the broker's default window (100 ms), held to the same bytes, its
    walls and fusions printed beside the checked lane's. Returns the
    checked lane's launches."""
    import torch

    from pypulsar_tpu_torch.io.synth import write_synthetic_fil
    from pypulsar_tpu_torch.parallel import accelpipe, broker, foldpipe
    from pypulsar_tpu_torch.survey import dag, lane
    from pypulsar_tpu_torch.survey.state import Observation

    fn_b = os.path.join(tmp, "psrb.fil")
    info_b = write_synthetic_fil(
        fn_b, nchan=info["nchan"], tsamp=info["tsamp"], nsamp=info["nsamp"],
        fch1=1500.0, bw=300.0, dm=LANE_B_DM, period_samples=LANE_B_PERIOD,
        width=8, nbits=8, seed=LANE_B_SEED)
    if info_b["nsamp"] != info["nsamp"]:
        fail(f"observation B has {info_b['nsamp']} samples, not "
             f"{info['nsamp']}: not the lane's geometry")
    cfg = dag.SurveyConfig(**CHAIN_CFG)
    os.makedirs(os.path.join(tmp, "chain_b"))
    serial_b = Observation("psrb", fn_b, os.path.join(tmp, "chain_b", "psrb"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walls_b = dag.run_observation(serial_b, cfg, device=device)
    torch.cuda.synchronize()
    serial_b_s = time.perf_counter() - t0
    serial_s = sum(chain["walls"].values()) + serial_b_s
    chain["serial_b"] = dict(fn=fn_b, outbase=serial_b.outbase,
                             wall_s=serial_b_s, walls=walls_b)
    psr = {"rfi": (info["period_samples"] * info["tsamp"], 70.0),
           "psrb": (LANE_B_PERIOD * info["tsamp"], LANE_B_DM)}
    runs = {}
    # the checked lane at LANE_WAIT_MS, then the reference's default
    # window (held to the same bytes; its fusions printed, not required)
    for label, wait_ms in (("lane", LANE_WAIT_MS),
                           ("lane_default_window", broker.WAIT_MS)):
        os.makedirs(os.path.join(tmp, label))
        pairs = [(Observation("rfi", chain["rfi"],
                              os.path.join(tmp, label, "rfi")),
                  chain["outbase"]),
                 (Observation("psrb", fn_b, os.path.join(tmp, label, "psrb")),
                  serial_b.outbase)]
        fused = collections.Counter()
        real = {}
        for mod, attr in ((accelpipe, "_broker_concat_rows"),
                          (foldpipe, "_broker_concat_fold")):
            real[attr] = getattr(mod, attr)

            def counted(units, device, attr=attr):  # counts fused dispatches
                fused[attr] += 1
                return real[attr](units, device)

            setattr(mod, attr, counted)
        broker.reset()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = lane.run_lane([o for o, _ in pairs], cfg, device=device,
                                wait_ms=wait_ms)
            torch.cuda.synchronize()
        finally:
            accelpipe._broker_concat_rows = real["_broker_concat_rows"]
            foldpipe._broker_concat_fold = real["_broker_concat_fold"]
        lane_s = time.perf_counter() - t0
        launches = launch_counts()
        stats = broker.get_broker().stats()
        broker.reset()
        equal = collections.Counter()
        hits = {}
        for obs, serial in pairs:
            for pattern in LANE_PATTERNS:
                paths = sorted(glob.glob(serial + pattern))
                got = len(glob.glob(obs.outbase + pattern))
                if not paths or got != len(paths):
                    fail(f"{label} {obs.name}: {len(paths)} serial files of "
                         f"{pattern}, {got} from the lane")
                equal[pattern] += same_bytes(paths, serial, obs.outbase)
            if snr_rows(serial + "_snr.json") != snr_rows(
                    obs.outbase + "_snr.json"):
                fail(f"{label} {obs.name}: _snr.json differs from the "
                     f"serial run's")
            hits[obs.name] = lane_hits(obs.outbase, *psr[obs.name])
            if not hits[obs.name]:
                fail(f"{label} {obs.name}: no candidate at its pulsar's DM "
                     f"and period or a harmonic folds to SNR > 10")
        if stats["unit_retries"] or stats["fused_faults"]:
            fail(f"a fused dispatch of the {label} failed: {stats}")
        runs[label] = dict(
            wait_ms=wait_ms, lane_wall_s=lane_s,
            lane_over_serial=lane_s / serial_s,
            lane_stage_wall_s=res["walls"],
            peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
            broker=stats, fused_dispatches_by_stage={
                "accel": fused["_broker_concat_rows"],
                "fold": fused["_broker_concat_fold"]},
            files_equal_serial=dict(equal),
            pulsars={k: max(h, key=lambda r: r["snr"])
                     for k, h in hits.items()},
            launches=launches)
    checked = runs["lane"]
    stats, launches = checked["broker"], checked["launches"]
    if not (stats["dispatches"] < stats["submissions"]
            and stats["coalesced_units"] >= 2):
        fail(f"the lane's broker fused nothing: {stats}")
    need = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats",
            "fold_parts_multi_poly")
    if min(launches[k] for k in need) < 1:
        fail(f"the lane did not launch every kernel of its path (the sweep's "
             f"and the multi-series fold): {launches}")
    if min(checked["fused_dispatches_by_stage"].values()) < 1:
        fail(f"the lane did not fuse both stages' dispatches: "
             f"{checked['fused_dispatches_by_stage']}")
    print("lane: " + json.dumps({
        "observations": 2,
        "serial_wall_s": {"rfi (phase 8)": sum(chain["walls"].values()),
                          "psrb": serial_b_s},
        "serial_sum_s": serial_s,
        "serial_stage_wall_s": {"rfi (phase 8)": chain["walls"],
                                "psrb": walls_b}, **runs}))
    return launches


def lane_and_multi_phase(tmp, info, device, report, chain):
    """Phase 11: (a) the multi-series fold kernel, (b) the lane."""
    check_fold_multi(device, report, os.path.join(tmp, "stage"),
                     info["tsamp"])
    return lane_phase(tmp, info, device, chain)


# ---------------------------------------------------------------------------
# phase 12: PSRFITS, float32 .fil and multi-file input
# ---------------------------------------------------------------------------

FITS_NSBLK = 2048  # spectra a subint
FITS_ZERO_WEIGHT = (3, 400, 777)  # stored (ascending) channels of weight 0
FITS_HIDM = 500.0  # BASELINE.json configs[2]: a DDplan of DM 0-500
NAN_CELLS = 12  # non-finite cells in the float32 file


def write_fits_copy(fn, out, nbits, seed, weights=True):
    """A PSRFITS copy of the SIGPROC file ``fn`` (8-bit samples; at 4 bits
    their top nibble) in subints of ``FITS_NSBLK`` spectra, with seeded
    per-channel scales (0.5-2) and offsets (-20..20) drifting by up to 1%
    from subint to subint, and (``weights``) channels ``FITS_ZERO_WEIGHT``
    of weight 0. Returns its path and the write's seconds."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.psrfits import write_psrfits

    t0 = time.perf_counter()
    with FilterbankFile(fn) as r:
        hdr, C, T = r.header_size, r.nchans, r.nspec
        freqs = np.asarray(r.frequencies)
        tsamp, tstart = float(r.tsamp), float(r.tstart)
    tc = np.memmap(fn, dtype=np.uint8, mode="r", offset=hdr, shape=(T, C))
    data = tc.T if nbits == 8 else (tc >> 4).T
    rng = np.random.default_rng(seed)
    nsub = -(-T // FITS_NSBLK)
    drift = rng.uniform(0.99, 1.01, (nsub, C))
    scales = (rng.uniform(0.5, 2.0, C)[None, :] * drift).astype(np.float32)
    offsets = rng.uniform(-20.0, 20.0, C).astype(np.float32)
    wts = np.ones(C, np.float32)
    if weights:
        wts[list(FITS_ZERO_WEIGHT)] = 0.0
    write_psrfits(out, data, freqs, tsamp, nsamp_per_subint=FITS_NSBLK,
                  nbits=nbits, start_mjd=tstart, scales=scales,
                  offsets=offsets, weights=wts)
    del data, tc
    return out, time.perf_counter() - t0


def check_card_ingest(fits, geometries, device):
    """Every block the sweeps read of ``fits`` (``(payload, overlap)`` raw
    geometries), decoded on the card and by the plain version on the
    CPU: each must have the same bits. Returns the blocks compared."""
    import torch

    from pypulsar_tpu_torch.io.psrfits import PsrfitsFile
    from pypulsar_tpu_torch.parallel import staged

    n = 0
    with PsrfitsFile(fits) as pf:
        src = staged.ReaderSource(pf)
        for payload, overlap in geometries:
            for (p1, card), (p2, cpu) in zip(
                    src.chan_major_blocks(payload, overlap, device),
                    src.chan_major_blocks(payload, overlap, "cpu")):
                if p1 != p2 or card.shape != cpu.shape or not torch.equal(
                        card.cpu().view(torch.int32), cpu.view(torch.int32)):
                    fail(f"{fits}: the card's block at {p1} is not the CPU "
                         f"ingest's bits")
                n += 1
                del card, cpu
    return n


def sweep_geometries(fits, steps, nsub=64):
    """The raw (payload, overlap) of each pass a sweep makes over the
    file: ``steps`` is a list of (dms, downsamp), the CLI's automatic
    group size and default chunk."""
    import numpy as np

    from pypulsar_tpu_torch.io.psrfits import PsrfitsFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    out = []
    with PsrfitsFile(fits) as pf:
        src = staged.ReaderSource(pf)
        for dms, factor in steps:
            plan, payload, _ = staged.step_geometry(
                src, np.asarray(dms, np.float64), factor, nsub, 0,
                sweep.DEFAULT_WIDTHS, None)
            out.append((payload * factor, plan.min_overlap * factor))
    return out


class PathMeter:
    """Wall, bytes shipped to the card and peak device memory of one
    driven path, and its kernel launches (counts set to 0 on entry)."""

    def __init__(self, name, card):
        self.name, self.card = name, card

    def __enter__(self):
        import torch

        from pypulsar_tpu_torch.parallel.prefetch import ship_ahead

        reset_launch_counts()
        ship_ahead.bytes = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        from pypulsar_tpu_torch.parallel.prefetch import ship_ahead

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.launches = launch_counts()
        self.shipped = ship_ahead.bytes
        self.peak_gb = torch.cuda.max_memory_allocated() / 1e9
        return False

    def line(self, **extra):
        print(f"path {self.name}: " + json.dumps({
            "wall_s": self.wall_s, "bytes_shipped": self.shipped,
            "peak_device_gb": self.peak_gb, "card": self.card,
            **extra, "launches": self.launches}))


def best_cand(out):
    with open(out + ".cands") as f:
        rows = [ln.split() for ln in f.read().splitlines()[1:]]
    if not rows:
        fail(f"{out}.cands holds no candidate")
    best = max(rows, key=lambda r: float(r[1]))
    return float(best[0]), float(best[1]), len(rows)


def psrfits_sweeps(tmp, card, setup):
    """Phase 12 (a-c): PSRFITS copies of the phase-4 file at 8 and 4 bits
    (written in the background, :func:`start_setup`), their card ingest
    held to the CPU's on every block of the DDplan's first step (every
    byte of the file once; its later steps read the same bytes in other
    blocks, cut for the script's time) and of the flat sweep, the DDplan
    sweep of DM 0-500 (configs[2]) on the 8-bit copy and the flat
    1024-trial sweep on the 4-bit copy. Returns their launches and (path,
    write s) of (d)'s copy of phase 8's RFI file."""
    import argparse
    import numpy as np

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.psrfits import PsrfitsFile

    t0 = time.perf_counter()
    (fits8, w8), (fits4, w4) = setup["fits8"].result(), \
        setup["fits4"].result()
    rfi_copy = setup["rfi_fits"].result()
    waited_s = time.perf_counter() - t0
    with PsrfitsFile(fits8) as pf:
        plan = cli.make_ddplan(pf, argparse.Namespace(
            lodm=0.0, hidm=FITS_HIDM, plan_numsub=0, resolution=0.0))
    flat_dms = 0.5 * np.arange(1024)
    t0 = time.perf_counter()
    first = plan.DDsteps[0]
    n8 = check_card_ingest(fits8, sweep_geometries(
        fits8, [(first.DMs, int(first.downsamp))]), "cuda")
    n4 = check_card_ingest(fits4, sweep_geometries(fits4, [(flat_dms, 1)]),
                           "cuda")
    ingest_s = time.perf_counter() - t0
    print(f"psrfits ingest: wrote the 8-bit copy in {w8:.1f} s "
          f"({os.path.getsize(fits8) / 1e9:.3f} GB) and the 4-bit copy in "
          f"{w4:.1f} s ({os.path.getsize(fits4) / 1e9:.3f} GB) in the "
          f"background (waited {waited_s:.1f} s here); the card's "
          f"blocks the CPU ingest's bits: {n8} blocks of the DDplan's "
          f"first step (8-bit), {n4} of the flat sweep (4-bit), in "
          f"{ingest_s:.1f} s")
    out8 = os.path.join(tmp, "fits_ddplan")
    with PathMeter("psrfits_ddplan", card) as m8:
        rc = cli.main([fits8, "--ddplan", "--lodm", "0", "--hidm",
                       str(FITS_HIDM), "--nsub", "64", "-o", out8,
                       "--device", "cuda"])
    if rc != 0:
        fail(f"sweep --ddplan on the 8-bit PSRFITS copy exited {rc}")
    dm, snr, rows = best_cand(out8)
    step = next(s for s in plan.DDsteps if s.loDM <= dm < s.hiDM)
    if abs(dm - 70.0) > step.dDM:
        fail(f"the PSRFITS DDplan's best candidate is at DM {dm}")
    if min(m8.launches[k] for k in SWEEP_KERNELS) < 1:
        fail(f"the PSRFITS DDplan missed a kernel: {m8.launches}")
    m8.line(input="8-bit PSRFITS", trials=int(sum(
        s.numDMs for s in plan.DDsteps)), steps=len(plan.DDsteps),
        best={"dm": dm, "snr": snr}, cands=rows,
        file_bytes=os.path.getsize(fits8))
    out4 = os.path.join(tmp, "fits_flat4")
    with PathMeter("psrfits_flat4", card) as m4:
        rc = cli.main([fits4, "--lodm", "0", "--dmstep", "0.5", "--numdms",
                       "1024", "--nsub", "64", "-o", out4, "--device",
                       "cuda"])
    if rc != 0:
        fail(f"the flat sweep of the 4-bit PSRFITS copy exited {rc}")
    dm, snr, rows = best_cand(out4)
    if abs(dm - 70.0) > 1.0:
        fail(f"the 4-bit PSRFITS sweep's best candidate is at DM {dm}")
    if min(m4.launches[k] for k in SWEEP_KERNELS) < 1:
        fail(f"the 4-bit PSRFITS sweep missed a kernel: {m4.launches}")
    m4.line(input="4-bit PSRFITS", trials=1024, best={"dm": dm, "snr": snr},
            cands=rows, file_bytes=os.path.getsize(fits4),
            dm_trials_per_s=1024 / m4.wall_s)
    for p in (fits8, fits4):
        os.remove(p)
    return m8.launches, m4.launches, rfi_copy


def psrfits_chain(tmp, chain, info, card, rfi_copy):
    """Phase 12 (d): ``run_observation`` on ``rfi_copy`` (path, write s),
    the PSRFITS copy of phase 8's RFI file, with phase 8's gates."""
    import numpy as np

    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.survey import dag
    from pypulsar_tpu_torch.survey.state import Observation

    fits, write_s = rfi_copy
    os.makedirs(os.path.join(tmp, "fitschain"))
    obs = Observation("rfi_fits", fits, os.path.join(tmp, "fitschain",
                                                     "rfi"))
    cfg = dag.SurveyConfig(**CHAIN_CFG)
    with PathMeter("psrfits_chain", card) as m:
        walls = dag.run_observation(obs, cfg, device="cuda")
    need = SWEEP_KERNELS + ("fold_parts_poly",)
    if min(m.launches[k] for k in need) < 1:
        fail(f"the PSRFITS chain did not launch every kernel: {m.launches}")
    C = info["nchan"]
    tone = sorted(C - 1 - c for c in TONE_CHANS)
    mask = RfifindMask(obs.outbase + "_rfifind.mask")
    if not (set(tone) <= set(mask.mask_zap_chans.tolist())
            and RFI_INTERVAL in mask.mask_zap_ints.tolist()):
        fail(f"the PSRFITS chain's mask zaps channels "
             f"{mask.mask_zap_chans.tolist()} and intervals "
             f"{mask.mask_zap_ints.tolist()}")
    rest = np.delete(np.delete(mask._zap_table, tone, axis=1),
                     [RFI_INTERVAL], axis=0)
    if rest.mean() >= 0.01:
        fail(f"the PSRFITS chain's mask flags {rest.mean():.2%} of the "
             f"cells without RFI")
    accel = accel_hits(obs.outbase + "_DM70.00_ACCEL_200.cand", info)
    if not accel:
        fail("the PSRFITS chain's DM-70 search holds no harmonic of the "
             "pulsar with |z| <= 2 and sigma > 10")
    with open(obs.outbase + "_foldbatch.json") as f:
        results = json.load(f)["results"]
    with open(obs.outbase + "_snr.json") as f:
        snr = {row["name"]: row["snr"] for row in json.load(f)}
    psr = info["period_samples"] * info["tsamp"]
    hits = [dict(name=r["name"], dm=r["dm"], period=r["period"],
                 snr=snr.get(r["name"])) for r in results
            if harmonic_of(r["period"], psr) is not None
            and abs(r["dm"] - 70.0) <= 2.0 and (snr.get(r["name"]) or 0) > 10]
    if not hits:
        fail("no PSRFITS chain candidate within 2 DM of 70 at the pulsar's "
             "period or a harmonic folds to SNR > 10")
    m.line(input="8-bit PSRFITS copy of the RFI file", write_s=write_s,
           stage_wall_s=walls, mask_coverage=float(mask._zap_table.mean()),
           other_cells_flagged=float(rest.mean()), accel=accel[0],
           pulsar=max(hits, key=lambda h: h["snr"]),
           streamed_chain_stage_wall_s=chain["walls"])
    os.remove(fits)
    return m.launches


def float32_fil_sweep(tmp, fn, card):
    """Phase 12 (e): a float32 ``.fil`` of the phase-4 file's first 2^18
    samples with ``NAN_CELLS`` non-finite cells, swept over 1024 trials:
    the scrub counts exactly the cells its blocks hold, and the pulsar is
    found. The counts are the ones the sweep returns
    (``StagedSweepResult.quality``)."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import (
        FilterbankFile,
        write_filterbank,
    )
    from pypulsar_tpu_torch.parallel import staged, sweep

    T = 1 << 18
    with FilterbankFile(fn) as r:
        hdr = dict(r.header, nbits=32, nsamples=T)
        data = r.get_samples(0, T)
    rng = np.random.default_rng(SEED + 15)
    ts = rng.integers(0, T, NAN_CELLS)
    cs = rng.integers(0, data.shape[1], NAN_CELLS)
    data[ts, cs] = np.where(np.arange(NAN_CELLS) % 3 == 2, np.inf, np.nan)
    f32 = os.path.join(tmp, "obs32.fil")
    write_filterbank(f32, hdr, data)
    del data
    dms = 0.5 * np.arange(1024)
    # the blocks the sweep reads: each cell counts once a block holding it
    with FilterbankFile(f32) as r:
        plan, payload, _ = staged.step_geometry(
            staged.ReaderSource(r), dms, 1, 64, 0, sweep.DEFAULT_WIDTHS,
            None)
    starts = np.arange(0, T, payload)
    expect = int(sum(((ts >= p) & (ts < p + payload + plan.min_overlap)).sum()
                     for p in starts))
    with PathMeter("float32_fil", card) as m:
        with FilterbankFile(f32) as r:
            res = staged.sweep_flat(r, dms, nsub=64, group_size=0,
                                    device="cuda")
    seen = res.quality
    if seen is None:
        fail("the float32 .fil sweep was not scrubbed")
    if seen.nonfinite_cells != expect:
        fail(f"the scrub counted {seen.nonfinite_cells} non-finite cells, "
             f"the blocks hold {expect}")
    top = res.best(1)[0]
    dm, snr, rows = top["dm"], top["snr"], len(res.above_threshold(6.0))
    if abs(dm - 70.0) > 1.0:
        fail(f"the float32 .fil sweep's best candidate is at DM {dm}")
    if min(m.launches[k] for k in SWEEP_KERNELS) < 1:
        fail(f"the float32 .fil sweep missed a kernel: {m.launches}")
    m.line(input="float32 .fil, 2^18 samples", scrub=seen.to_dict(),
           nonfinite_expected=expect, blocks=len(starts),
           best={"dm": dm, "snr": snr}, cands=rows)
    os.remove(f32)
    return m.launches


def split_mask(tmp, fn, info, card):
    """Phase 12 (f): the mask of the phase-4 file split into two ``.fil``
    files on an interval boundary (one ``FilterbankObs``) must have the
    bytes of the whole file's mask."""
    from pypulsar_tpu_torch.cli import rfifind as cli
    from pypulsar_tpu_torch.io import sigproc
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    pts = int(round(MASK_TIME / info["tsamp"]))
    cut = 32 * pts
    parts = []
    with FilterbankFile(fn) as r:
        for i, (a, b) in enumerate(((0, cut), (cut, r.nspec))):
            p = os.path.join(tmp, f"split{i}.fil")
            hdr = dict(r.header, nsamples=b - a,
                       tstart=r.tstart + a * r.tsamp / 86400.0)
            with open(p, "wb") as f:
                f.write(sigproc.pack_header(hdr))
                r._read_raw_block(a, b - a).tofile(f)
            parts.append(p)
    whole = os.path.join(tmp, "whole")
    t0 = time.perf_counter()
    if cli.main([fn, "-o", whole, "-t", str(MASK_TIME), "--device",
                 "cuda"]) != 0:
        fail("the whole file's mask failed")
    whole_s = time.perf_counter() - t0
    split = os.path.join(tmp, "split")
    with PathMeter("mask_split", card) as m:
        rc = cli.main([parts[1], parts[0], "-o", split, "-t",
                       str(MASK_TIME), "--device", "cuda"])
    if rc != 0:
        fail("the two-file mask failed")
    with open(whole + "_rfifind.mask", "rb") as a, \
            open(split + "_rfifind.mask", "rb") as b:
        if a.read() != b.read():
            fail("the two-file mask differs from the whole file's")
    m.line(input=f"2 .fil files split at sample {cut}", whole_file_s=whole_s,
           mask="the whole file's bytes")
    for p in parts:
        os.remove(p)
    return m.launches


def psrfits_phase(tmp, fn, info, chain, card, setup):
    """Phase 12: returns the launches of each new driven path."""
    ddplan8, flat4, rfi_copy = psrfits_sweeps(tmp, card, setup)
    return {"psrfits_ddplan": ddplan8, "psrfits_flat4": flat4,
            "psrfits_chain": psrfits_chain(tmp, chain, info, card,
                                           rfi_copy),
            "float32_fil": float32_fil_sweep(tmp, fn, card),
            "mask_split": split_mask(tmp, fn, info, card)}

# ---------------------------------------------------------------------------
# phase 13: the Spectra surface (BASELINE.json configs[0] and [1])
# ---------------------------------------------------------------------------

# configs[0]: 10 s at 64 us of 256 channels, 50 pulses
WF_NCHAN, WF_NSAMP, WF_PERIOD = 256, 156250, 3125
ZDM_SECONDS = 60.0  # configs[1]: a 60-s file
ZDM_CHECK = 1 << 18  # samples whose bytes are held to the CPU port's
PSR_HZ = 1.0 / (4096 * 64e-6)  # the main file's pulsar: 3.8147 Hz
SPEC_HARMONICS, SPEC_MIN_RATIO = 32, 4.0


def close_enough(what, got, want, rtol, atol):
    """Max abs difference of two tensors, failing outside
    ``|got - want| <= atol + rtol * |want|``."""
    import torch

    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        fail(f"{what}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{what}: card and CPU differ by up to "
             f"{(got - want).abs().max().item()} (rtol {rtol}, atol {atol})")
    return (got - want).abs().max().item()


def same_bits(what, got, want):
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        fail(f"{what}: card and CPU bits differ")
    return 0.0


def compare_waterfall(fn, nsub, mask, device):
    """``get_data`` + ``prepare_data`` of the waterfaller on the card
    against the CPU: the read and masked chunk bit for bit, then each op
    of the fixed order on the card's input on both devices (subband,
    downsample rtol 1e-5 / atol 1e-5; the dedispersed, trimmed cells are
    gathers, bit for bit; scale and smooth rtol 1e-4 / atol 1e-5), and
    the whole chain within rtol 1e-4 / atol 1e-4. Returns the max abs
    errors, the pulse's sample and the card's image."""
    from pypulsar_tpu_torch.cli import waterfaller
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    with FilterbankFile(fn) as f:
        dur = waterfaller.read_duration(f, 10.0, 70.0)
        card = waterfaller.get_data(f, 0.0, duration=dur, mask=mask,
                                    device=device)
        host = waterfaller.get_data(f, 0.0, duration=dur, mask=mask,
                                    device="cpu")
    errs = {"get_data": same_bits("waterfaller get_data", card.data,
                                  host.data)}
    full_card = waterfaller.prepare_data(card, 4, 4, 70.0, nsub, 70.0)
    full_host = waterfaller.prepare_data(host, 4, 4, 70.0, nsub, 70.0)
    steps = [("subband", lambda d: d.subband(nsub or d.numchans, 70.0,
                                             padval="mean"), 1e-5, 1e-5),
             ("dedisperse", lambda d: d.dedisperse(70.0, padval="mean",
                                                   trim=True), None, None),
             ("downsample", lambda d: d.downsample(4), 1e-5, 1e-5),
             ("scaled", lambda d: d.scaled(False), 1e-4, 1e-5),
             ("smooth", lambda d: d.smooth(4, padval="mean"), 1e-4, 1e-5)]
    x = card
    for name, op, rtol, atol in steps:
        c, h = op(x), op(x.to("cpu"))
        errs[name] = (same_bits(f"waterfaller {name}", c.data, h.data)
                      if rtol is None else
                      close_enough(f"waterfaller {name}", c.data, h.data,
                                   rtol, atol))
        x = c
    errs["chain"] = close_enough("waterfaller chain", full_card.data,
                                 full_host.data, 1e-4, 1e-4)
    ts = full_card.data.sum(dim=0).cpu()
    peak = int(ts.argmax()) * 4
    off = min(peak % WF_PERIOD, WF_PERIOD - peak % WF_PERIOD)
    if off > 24:  # pulse of 8 samples, bins of 4, a 4-bin smooth
        fail(f"the waterfall's summed series peaks at sample {peak}, "
             f"{off} from the pulse")
    return {"max_abs_err": errs, "peak_sample": peak,
            "shape": list(full_card.data.shape),
            "image": full_card.to_numpy()}


def waterfaller_phase(tmp, card, device):
    """Phase 13 (a), configs[0]: ``cli.waterfaller`` on a 10-s
    256-channel 8-bit file with ``-s 32 --mask`` and without."""
    import numpy as np

    from pypulsar_tpu_torch.cli import rfifind, waterfaller
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.io.rfimask import RfifindMask
    from pypulsar_tpu_torch.io.synth import write_synthetic_fil

    fn = os.path.join(tmp, "wf.fil")
    info = write_synthetic_fil(fn, nchan=WF_NCHAN, tsamp=64e-6, nsamp=WF_NSAMP,
                               dm=70.0, period_samples=WF_PERIOD,
                               seed=SEED + 20)
    if info["nsamp"] != WF_NSAMP:
        fail(f"the configs[0] file holds {info['nsamp']} samples")
    # RFI for the mask to find: a square wave (period 16 samples, 0 and
    # 255) on 4 file channels mid-band
    tone = slice(WF_NCHAN // 2, WF_NCHAN // 2 + 4)
    with FilterbankFile(fn) as r:
        hdr_bytes = r.header_size
    data = np.memmap(fn, dtype=np.uint8, mode="r+", offset=hdr_bytes,
                     shape=(WF_NSAMP, WF_NCHAN))
    data[:, tone] = np.where((np.arange(WF_NSAMP) // 8) % 2 == 0, 0,
                             255).astype(np.uint8)[:, None]
    data.flush()
    del data
    base = os.path.join(tmp, "wf")
    if rfifind.main([fn, "-o", base, "-t", "1.0", "--device", device]) != 0:
        fail("the configs[0] mask failed")
    mask = base + "_rfifind.mask"
    zapped = RfifindMask(mask).get_chan_mask(0, WF_NSAMP)  # file order
    if not zapped[tone].all():
        fail("the configs[0] mask left the tone's channels unzapped")
    launches = {}
    for name, extra, nsub, mfile in (
            ("waterfaller_nsub_mask", ["-s", "32", "--mask", mask], 32, mask),
            ("waterfaller_plain", [], None, None)):
        npz = os.path.join(tmp, name + ".npz")
        opts = ["-T", "0", "-t", "10", "--dm", "70", "--downsamp", "4",
                "--width-bins", "4", *extra]
        argv = [fn, *opts, "-o", npz, "--device", device]
        with PathMeter(name, card) as m:
            rc = waterfaller.main(argv)
        if rc != 0:
            fail(f"{name}: the waterfaller exited {rc}")
        checks = compare_waterfall(fn, nsub, mfile, device)
        with np.load(npz) as z:
            if not np.array_equal(z["data"], checks.pop("image")):
                fail(f"{name}: the CLI's image is not the bits of "
                     f"get_data + prepare_data on the card")
        m.line(config="BASELINE.json configs[0]",
               input=f"{WF_NCHAN} chans x {WF_NSAMP} samples, 8-bit, DM 70",
               mask_zapped_fraction=float(zapped.mean()),
               argv=" ".join(opts).replace(mask, "MASK"), **checks)
        launches[name] = m.launches
    os.remove(fn)
    return launches


def spectral_line_ratio(spectra, freqs):
    """Per block: the power of the bins nearest the first
    ``SPEC_HARMONICS`` harmonics of the pulsar, over what as many noise
    bins hold (the block's median power without DC, over ln 2)."""
    import numpy as np

    df = freqs[1]
    bins = np.rint(PSR_HZ * np.arange(1, SPEC_HARMONICS + 1) / df).astype(
        int)
    noise = np.median(spectra[:, 1:], axis=1) / np.log(2.0)
    return spectra[:, bins].sum(axis=1) / (SPEC_HARMONICS * noise)


def zero_dm_phase(tmp, fn, card, device):
    """Phase 13 (b), configs[1]: ``cli.zero_dm_filter`` on a 60-s head of
    the main file, then ``cli.sweep --write-dats`` at DM 70 on its output,
    ``cli.spectrogram -t 1`` and ``detrend_blocks`` of the ``.dat``, each
    on the card against the CPU."""
    import numpy as np

    from pypulsar_tpu_torch.cli import spectrogram, zero_dm_filter
    from pypulsar_tpu_torch.cli import sweep as sweep_cli
    from pypulsar_tpu_torch.io.datfile import Datfile
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.utils.detrend import detrend_blocks

    with FilterbankFile(fn) as r:
        tsamp = float(r.tsamp)
    head = write_head(tmp, fn, int(round(ZDM_SECONDS / tsamp)),
                      "zdm_head.fil")
    out = os.path.join(tmp, "zdm.fil")
    launches = {}
    with FilterbankFile(head) as r:
        nsamp, nchan, hdr = r.nspec, r.nchans, r.header_size
    nbytes = os.path.getsize(head)
    with PathMeter("zero_dm_filter", card) as m:
        rc = zero_dm_filter.main([head, "-o", out, "--device", device])
    if rc != 0:
        fail(f"zero_dm_filter exited {rc}")
    # the first ZDM_CHECK samples against the CPU port
    check = min(ZDM_CHECK, nsamp)
    small = write_head(tmp, head, check, "zdm_small.fil")
    small_out = os.path.join(tmp, "zdm_small_cpu.fil")
    zero_dm_filter.zero_dm_file(small, small_out, device="cpu")
    with open(head, "rb") as a:
        in_hdr = a.read(hdr)
    with open(small_out, "rb") as b:
        b.seek(hdr)
        want = np.frombuffer(b.read(), np.uint8)
    with open(out, "rb") as a:
        out_hdr = a.read(hdr)
        got = np.frombuffer(a.read(check * nchan), np.uint8)
    if out_hdr != in_hdr or os.path.getsize(out) != nbytes:
        fail("zero_dm_filter: the output's header or length is not the "
             "input's")
    if got.size != want.size:
        fail("zero_dm_filter: the CPU's output has another length")
    with FilterbankFile(small) as r:
        block = r._read_raw_block(0, check).reshape(check, nchan)
    got, want = got.reshape(block.shape), want.reshape(block.shape)
    bad = zero_dm_filter.unproven_differences(block, got, want)
    if bad.size:
        fail(f"zero_dm_filter: {len(bad)} bytes differ from the CPU's "
             f"without a float64 tie, first at (t, c) = {bad[0].tolist()}")
    m.line(config="BASELINE.json configs[1]",
           input=f"{nchan} chans x {nsamp} samples, 8-bit "
                 f"({nbytes / 1e9:.3f} GB)",
           gb_per_s=2 * nbytes / m.wall_s / 1e9,
           gb_per_s_counts="bytes read + bytes written",
           cpu_check_samples=check,
           differing_bytes=int((got != want).sum()),
           unproven_bytes=0)
    launches["zero_dm_filter"] = m.launches
    for p in (head, small, small_out):
        os.remove(p)

    base = os.path.join(tmp, "zdm")
    with PathMeter("zero_dm_sweep", card) as m:
        rc = sweep_cli.main([out, "--lodm", "70", "--numdms", "1", "--nsub",
                             "64", "--write-dats", "-o", base, "--device",
                             device])
    if rc != 0:
        fail(f"the sweep of the filtered file exited {rc}")
    dm, snr, _ = best_cand(base)
    if abs(dm - 70.0) > 1e-6:
        fail(f"the filtered file's sweep reports DM {dm}")
    m.line(config="BASELINE.json configs[1]", best={"dm": dm, "snr": snr})
    launches["zero_dm_sweep"] = m.launches
    os.remove(out)

    dat = base + "_DM70.00.dat"
    npz = base + "_spectrogram.npz"
    with PathMeter("spectrogram", card) as m:
        rc = spectrogram.main([dat, "-t", "1", "-o", npz, "--device",
                               device])
    if rc != 0:
        fail(f"spectrogram exited {rc}")
    with Datfile(dat) as d:
        spec_card, _, freqs = spectrogram.get_spectra(d, 1.0, device=device)
        spec_cpu, _, _ = spectrogram.get_spectra(d, 1.0, device="cpu")
        series = d.read_all()
    with np.load(npz) as z:
        if not np.array_equal(z["spectra"], spec_card):
            fail("spectrogram: the CLI's spectra are not get_spectra's")
    # rtol 2e-4 of each bin plus 2e-4 of its block's mean power: an FFT's
    # rounding scales with the block's norm, not with one bin's power
    tol = 2e-4 * (np.abs(spec_cpu)
                  + spec_cpu.mean(axis=1, keepdims=True))
    if not (np.abs(spec_card - spec_cpu) <= tol).all():
        fail("spectrogram: the card's spectra differ from the CPU's by up "
             f"to {np.abs(spec_card - spec_cpu).max()}")
    ratio = spectral_line_ratio(spec_card, freqs)
    if ratio.min() < SPEC_MIN_RATIO:
        fail(f"spectrogram: the {PSR_HZ:.4f} Hz line stands only "
             f"{ratio.min():.2f}x over the noise in block "
             f"{int(ratio.argmin())}")
    m.line(config="BASELINE.json configs[1]", blocks=int(spec_card.shape[0]),
           bins=int(spec_card.shape[1]),
           max_rel_err=float((np.abs(spec_card - spec_cpu)
                              / (spec_cpu + spec_cpu.mean(
                                  axis=1, keepdims=True))).max()),
           line_hz=PSR_HZ, line_ratio_min=float(ratio.min()),
           line_ratio_median=float(np.median(ratio)))
    launches["spectrogram"] = m.launches

    L = int(round(1.0 / tsamp))
    nblk = series.size // L
    y = series[:nblk * L].reshape(nblk, L)
    x = np.tile(np.arange(L, dtype=np.float32), (nblk, 1))
    med = np.median(y, axis=1, keepdims=True)
    omit = np.abs(y - med) > 6 * y.std(axis=1, keepdims=True)
    with PathMeter("detrend_blocks", card) as m:
        got = detrend_blocks(y, x, omit, order=1, device=device)
    want = detrend_blocks(y, x, omit, order=1, device="cpu")
    scale = np.abs(y).max(axis=1, keepdims=True)
    err = np.abs(got - want) / scale
    if not np.isfinite(got).all() or err.max() > 1e-4:
        fail(f"detrend_blocks: card and CPU differ by {err.max()} of a "
             f"block's largest |y|")
    kept_mean = np.abs(np.where(omit, 0.0, got).sum(axis=1)
                       / (~omit).sum(axis=1))
    if (kept_mean > 1e-3 * y.std(axis=1)).any():
        fail("detrend_blocks: a block's kept cells do not average to 0")
    m.line(config="BASELINE.json configs[1]", blocks=nblk, block_len=L,
           omitted=int(omit.sum()), max_err_of_block_max=float(err.max()))
    launches["detrend_blocks"] = m.launches
    return launches


def spectra_phase(tmp, fn, card, device="cuda"):
    """Phase 13: returns the launches of each new driven path."""
    return {**waterfaller_phase(tmp, card, device),
            **zero_dm_phase(tmp, fn, card, device)}


# ---------------------------------------------------------------------------
# phase 14: the standalone accel search at BASELINE.json configs[4]'s 1 h
# ---------------------------------------------------------------------------

HOUR_N, HOUR_DT = 56_250_000, 64e-6  # 1 h of 64-us samples
HOUR_F0, HOUR_Z = 11.1, 20.0  # fundamental (Hz) at t = 0, its drift in bins
HOUR_NHARM = 8
# per-harmonic amplitude (noise sigma 1) of each file; the last is noise
HOUR_AMPS = (0.004, 0.002, 0.0014, 0.0)
HOUR_CHUNK = 1 << 22
ACCEL_FLAGS = ["-z", "200", "--dz", "2", "-n", "8"]
ACCEL_SUFFIX = "_ACCEL_200.cand"  # of zmax 200, here and in the stage
ACCEL_SIGMA_MIN = 2.0  # the CLI's default -s


def write_hour_dat(base, amp, seed, n=None, dt=HOUR_DT, z0=None):
    """One ``.dat``/``.inf`` pair of ``n`` samples (default ``HOUR_N``):
    unit float32 noise plus ``amp`` times the first 8 harmonics of a
    signal whose frequency starts at ``HOUR_F0`` and drifts ``z0`` bins
    (default ``HOUR_Z``) over the series, written in chunks (host memory
    stays at one chunk)."""
    import numpy as np

    from pypulsar_tpu_torch.io.infodata import InfoData

    n = HOUR_N if n is None else n
    z0 = HOUR_Z if z0 is None else z0
    T = n * dt
    fdot = z0 / T ** 2
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        for i0 in range(0, n, HOUR_CHUNK):
            m = min(HOUR_CHUNK, n - i0)
            block = rng.standard_normal(m, dtype=np.float32)
            if amp:
                t = (i0 + np.arange(m)) * dt
                c1 = np.cos(2 * np.pi * np.mod(HOUR_F0 * t
                                               + 0.5 * fdot * t * t, 1.0))
                prev, cur, total = np.ones_like(c1), c1, c1.copy()
                for _ in range(2, HOUR_NHARM + 1):  # cos(h x) by recurrence
                    prev, cur = cur, 2.0 * c1 * cur - prev
                    total += cur
                block += (amp * total).astype(np.float32)
            block.tofile(f)
    inf = InfoData()
    inf.basenm = os.path.basename(base)
    inf.telescope = "Fake"
    inf.object = "HOUR"
    inf.epoch = 60000.0
    inf.N = n
    inf.dt = dt
    inf.DM = 0.0
    inf.numchan = 1
    inf.lofreq = 1400.0
    inf.BW = 100.0
    inf.chan_width = 100.0
    inf.bary = 1
    inf.to_file(base + ".inf")


def write_hour(base, amp, seed):
    write_hour_dat(base, amp, seed)
    return base


def start_setup(tmp, fn, rfi_fn):
    """Start the input files of phases 12 and 14 in the background, in
    processes of their own beside phases 9-11: the PSRFITS copies of
    ``fn`` at 8 and 4 bits and of phase 8's RFI file ``rfi_fn`` (each
    future's result: path, write s), then the 1-h ``.dat`` files (each:
    its base). Returns the futures and the pool, which the caller shuts
    down."""
    # spawn: a child of a process holding the card must not fork it
    pool = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    hdir = os.path.join(tmp, "hour")
    os.makedirs(hdir)
    setup = {"pool": pool,
             "fits8": pool.submit(write_fits_copy, fn, os.path.join(
                 tmp, "obs8.fits"), 8, SEED + 12),
             "fits4": pool.submit(write_fits_copy, fn, os.path.join(
                 tmp, "obs4.fits"), 4, SEED + 13),
             "rfi_fits": pool.submit(write_fits_copy, rfi_fn, os.path.join(
                 tmp, "rfi.fits"), 8, SEED + 14, weights=False)}
    # the 1-h files are independent (a seed each)
    setup["hour"] = [pool.submit(write_hour, os.path.join(hdir, f"hour{i}"),
                                 amp, SEED + 40 + i)
                     for i, amp in enumerate(HOUR_AMPS)]
    return setup


def link_inputs(dirname, bases, exts=(".dat", ".inf")):
    """Symlinks of the inputs in a directory of their own (a multi-file
    run writes each output beside its input)."""
    os.makedirs(dirname, exist_ok=True)
    out = []
    for b in bases:
        for ext in exts:
            os.symlink(b + ext, os.path.join(dirname,
                                              os.path.basename(b) + ext))
        out.append(os.path.join(dirname, os.path.basename(b)))
    return out


def signal_hit(cands, T, z0=None, min_sigma=10.0):
    """The best candidate at harmonic k of the drifting signal: within 1
    bin of k times its mean-frequency bin, the drift divided by k within
    2 bins of the fundamental's (``z0``, default ``HOUR_Z``), sigma above
    ``min_sigma``."""
    z0 = HOUR_Z if z0 is None else z0
    r0 = HOUR_F0 * T + 0.5 * z0
    for c in cands:
        k = round(c.r / r0)
        if k >= 1 and abs(c.r - k * r0) < 1.0 and abs(c.z / k - z0) <= 2.0 \
                and c.sig > min_sigma:
            return {"r": c.r, "z": c.z, "sigma": c.sig, "harmonic": k}
    return None


def contract_misses(a, b, max_cands=200, margin=0.5):
    """Candidates of either table above the contract's floor with no
    partner in the other within (dr, dz, dsig) = (0.5, 1.0, 0.5). The
    floor is sigma_min + margin, raised to a full table's last sigma +
    margin (a capped table's tail is not a detection)."""
    floor = ACCEL_SIGMA_MIN
    for t in (a, b):
        if len(t) >= max_cands:
            floor = max(floor, min(c.sig for c in t))
    floor += margin

    def miss(x, pool):
        return [c for c in x if c.sig > floor and not any(
            abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
            and abs(c.sig - o.sig) < 0.5 for o in pool)]

    return miss(a, b) + miss(b, a)


def hour_runs(tmp, card, device, setup):
    """Phase 14 (a)-(d): the 1-hour files (written in the background,
    :func:`start_setup`) through the card's search."""
    import numpy as np

    from pypulsar_tpu_torch.cli import accelsearch as acli
    from pypulsar_tpu_torch.cli import plot_accelcands
    from pypulsar_tpu_torch.fourier import accelsearch, kernels
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands

    print("cut: 4096 DM trials -> 6 spectra of 1 h (BASELINE.json "
          "configs[4]: 4 searched with device prep, 1 with host prep, 1 "
          "serially)")
    t0 = time.perf_counter()
    bases = [f.result() for f in setup["hour"]]
    print(f"wrote {len(bases)} x {HOUR_N} samples "
          f"({4 * HOUR_N / 1e6:.0f} MB each) in the background (waited "
          f"{time.perf_counter() - t0:.1f} s here)")
    T = HOUR_N * HOUR_DT
    # F2: one 1-hour series' card prep against float64 and the CPU's
    series = np.fromfile(bases[0] + ".dat", dtype=np.float32)[None]
    said = check_prep_against_float64(series, device, "1-h prep")[2]
    print(f"1-h prep (one series, card vs CPU vs float64): {said}")
    del series

    launches = {}
    runs = {
        "accel_hour_batch4": ("a", bases, ["--batch", "4"]),
        "accel_hour_hostprep": ("b", bases[:1], ["--batch", "1",
                                                 "--no-device-prep"]),
        "accel_hour_serial": ("c", bases[:1], ["--batch", "1"]),
    }
    tables = {}
    for name, (tag, src, flags) in runs.items():
        ins = link_inputs(os.path.join(tmp, "hour_" + tag), src)
        argv = [b + ".dat" for b in ins] + ACCEL_FLAGS + flags
        argv += ["--device", str(device)]
        clear_accel_counters(name)
        with PathMeter(name, card) as m, \
                Timed(kernels, "prep_spectra_batch") as prep, \
                Timed(accelsearch, "accel_search_batch") as srch:
            rc = acli.main(argv)
        if rc != 0:
            fail(f"{name}: cli.accelsearch exited {rc}")
        counters = dict(accelsearch.COUNTERS)
        if counters.get("accel.serial_fallbacks", 0):
            fail(f"{name}: {counters['accel.serial_fallbacks']} batches fell "
                 f"back to the serial path")
        tables[tag] = {os.path.basename(b): read_rzwcands(b + ACCEL_SUFFIX)
                       for b in ins}
        hits = {}
        for i, b in enumerate(ins):
            key = os.path.basename(b)
            cands = tables[tag][key]
            if HOUR_AMPS[int(key[4:])]:
                hits[key] = signal_hit(cands, T)
                if hits[key] is None:
                    fail(f"{name}: no harmonic of the signal with its drift "
                         f"and sigma > 10 in {key}: {cands[:3]}")
            else:
                best = max((c.sig for c in cands), default=0.0)
                hits[key] = {"noise_best_sigma": best}
                if best >= 8.0:
                    fail(f"{name}: the noise file's best candidate has "
                         f"sigma {best}")
        m.line(config="BASELINE.json configs[4]", argv=" ".join(
            ACCEL_FLAGS + flags), files=len(ins), samples=HOUR_N,
               spectra_per_s=len(ins) / m.wall_s,
               prep_s=prep.seconds, prep_calls=prep.calls,
               search_s=srch.seconds, search_calls=srch.calls,
               prep_chunk=counters.get("accel.prep_cap", 0),
               bytes_read=counters.get("accel.bytes_read", 0),
               serial_fallbacks=counters.get("accel.serial_fallbacks", 0),
               hits=hits)
        launches[name] = m.launches
    # (b) under the contract against (a); (c) the bytes of (b)
    for key, cands in tables["b"].items():
        bad = contract_misses(tables["a"][key], cands)
        if bad:
            fail(f"1-h host prep vs device prep of {key} breaks the "
                 f"matched-candidate contract: {bad[:3]}")
    hb, hc = os.path.join(tmp, "hour_b"), os.path.join(tmp, "hour_c")
    same_bytes(glob.glob(os.path.join(hc, "hour0_ACCEL_*")), hc, hb)
    # (d) the clustering of the four tables, without matplotlib
    npz = os.path.join(tmp, "hour_a", "accelcands.npz")
    infs = [os.path.join(tmp, "hour_a", f"hour{i}.inf")
            for i in range(len(HOUR_AMPS))]
    t0 = time.perf_counter()
    if plot_accelcands.main(infs + ["--accel-suffix", ACCEL_SUFFIX,
                                    "--no-plot", "-o", npz]) != 0:
        fail("plot_accelcands failed")
    wall = time.perf_counter() - t0
    with np.load(npz) as z:
        freqs, filenums = z["freqs"], z["filenums"]
        nzap = len(z["zap_fcent"])
    f_mid = HOUR_F0 + 0.5 * HOUR_Z / T
    near = [int(n) for f, n in zip(freqs, filenums)
            if abs(f / f_mid - round(f / f_mid)) * T < 1.0
            and round(f / f_mid) >= 1]
    if set(near) < {1, 2, 3}:
        fail(f"plot_accelcands: the signal's harmonics are not in files "
             f"1-3: {sorted(set(near))}")
    print("path plot_accelcands: " + json.dumps({
        "wall_s": wall, "candidates": int(len(freqs)),
        "files_with_signal": sorted(set(near)), "zap_rows": nzap,
        "card": card}))
    return launches


def fft_and_options(tmp, card, device):
    """Phase 14 (e): ``.fft`` input, --zapfile, --coarse-dz and the jerk
    search at 2^20 samples, the card held to the CPU port."""
    import numpy as np

    from pypulsar_tpu_torch.cli import accelsearch as acli
    from pypulsar_tpu_torch.fourier.prestofft import write_fft
    from pypulsar_tpu_torch.io.infodata import InfoData
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands

    n, z0 = 1 << 20, 4.0  # 4 bins of drift: 16 at the 4th harmonic
    d = os.path.join(tmp, "opts")
    os.makedirs(d)
    base = os.path.join(d, "short")
    write_hour_dat(base, 0.02, SEED + 50, n=n, z0=z0)
    inf = InfoData(base + ".inf")
    ts = np.fromfile(base + ".dat", dtype=np.float32)
    write_fft(base + ".fft", np.fft.rfft(ts).astype(np.complex64), inf)
    T = n * HOUR_DT
    f_mid = HOUR_F0 + 0.5 * z0 / T
    zap = os.path.join(d, "zap.txt")
    with open(zap, "w") as f:
        f.write(f"{3 * f_mid:.6f} 0.5\n")
    small = ["-z", "20", "--dz", "2", "-n", "4"]
    cases = {
        "fft_input": (base + ".fft", small, ""),
        "zapfile": (base + ".dat", small + ["--zapfile", zap], ""),
        "coarse": (base + ".dat", small + ["--coarse-dz", "4"], ""),
        "jerk": (base + ".dat", ["-z", "10", "--dz", "2", "-n", "2", "-w",
                                 "40", "--dw", "20"], "_JERK_40"),
    }
    launches, numbers = {}, {}
    for name, (inp, flags, jerk) in cases.items():
        zmax = flags[flags.index("-z") + 1]
        out = {}
        for dev in (str(device), "cpu"):
            ob = os.path.join(d, f"{name}_{dev}")
            clear_accel_counters(f"accel {name} on {dev}")
            with PathMeter("accel_" + name, card) as m:
                rc = acli.main([inp, *flags, "-o", ob, "--device", dev])
            fallbacks = accel_counters()["accel.serial_fallbacks"]
            if rc != 0 or fallbacks:
                fail(f"accel {name} on {dev}: exit {rc}, {fallbacks} "
                     f"fallbacks")
            out[dev] = read_rzwcands(f"{ob}_ACCEL_{zmax}{jerk}.cand")
            numbers[f"{name}_{dev}_s"] = m.wall_s
            if dev != "cpu":
                launches["accel_" + name] = m.launches
        bad = contract_misses(out[str(device)], out["cpu"])
        if bad:
            fail(f"accel {name}: card vs CPU breaks the matched-candidate "
                 f"contract: {bad[:3]}")
        hit = signal_hit(out[str(device)], T, z0=z0, min_sigma=6.0)
        if hit is None:
            fail(f"accel {name}: the signal was not found: "
                 f"{out[str(device)][:3]}")
        # the best sigma at the third harmonic's bin: the zaplist blanks it
        third = max((c.sig for c in out[str(device)]
                     if abs(c.r - 3 * f_mid * T) < 2.0), default=0.0)
        numbers[name] = {"card": len(out[str(device)]),
                         "cpu": len(out["cpu"]), "hit": hit,
                         "third_harmonic_best_sigma": third}
    if not numbers["zapfile"]["third_harmonic_best_sigma"] < \
            numbers["fft_input"]["third_harmonic_best_sigma"]:
        fail(f"accel zapfile: the blanked third harmonic is as strong as "
             f"unblanked: {numbers['zapfile']} / {numbers['fft_input']}")
    print("path accel_options_2^20: " + json.dumps({**numbers,
                                                     "card": card}))
    return launches


def hostprep_stage(tmp, fn, info, card):
    """Phase 14 (f): phase 6's sweep stage with the host prep."""
    import numpy as np

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands

    out = os.path.join(tmp, "hoststage")
    argv = stage_argv(fn, out, STAGE_LODM, STAGE_DMS,
                      ["--no-accel-device-prep"])
    with PathMeter("accel_hostprep_stage", card) as m:
        rc = cli.main(argv)
    if rc != 0:
        fail(f"the host-prep sweep stage exited {rc}")
    for k in SWEEP_KERNELS:
        if m.launches[k] < 1:
            fail(f"the host-prep sweep stage launched no {k}: "
                 f"{m.launches}")
    stage = os.path.join(tmp, "stage")
    for dm in STAGE_LODM + np.arange(STAGE_DMS):
        suffix = f"_DM{dm:.2f}{ACCEL_SUFFIX}"
        bad = contract_misses(read_rzwcands(stage + suffix),
                              read_rzwcands(out + suffix))
        if bad:
            fail(f"host-prep stage DM {dm}: breaks the matched-candidate "
                 f"contract against phase 6: {bad[:3]}")
    hits = accel_hits(f"{out}_DM70.00{ACCEL_SUFFIX}", info)
    if not hits:
        fail("the host-prep stage's DM-70 table holds no harmonic with "
             "|z| <= 2 and sigma > 10")
    m.line(trials=STAGE_DMS, trials_per_s=STAGE_DMS / m.wall_s,
           dm70_best=hits[:3])
    return {"accel_hostprep_stage": m.launches}


def run_quiet(main, argv):
    """(exit code, stdout) of an in-process CLI."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def toa_phases(text, epoch, period):
    """Rotational phases, from ``epoch``, of the Princeton TOAs in
    ``text``."""
    import numpy as np

    day = f"{int(epoch)}."
    mjds = [float(p) for ln in text.splitlines() for p in ln.split()
            if p.startswith(day) and len(p.split(".")[1]) >= 10]
    return ((np.array(mjds) - epoch) * 86400.0 / period) % 1.0


def check_toas(what, text, epoch, period, want_phase=None, min_toas=4):
    """The JAX package's TOA bound (tests/test_cli_pulses.py:123): the
    phases spread under 0.05 and, given ``want_phase``, their median
    within 0.05 of it (circular distances)."""
    import numpy as np

    ph = toa_phases(text, epoch, period)
    if len(ph) < min_toas:
        fail(f"{what}: {len(ph)} TOAs, not >= {min_toas}")
    off = (ph - (ph[0] if want_phase is None else want_phase) + 0.5) \
        % 1.0 - 0.5
    spread = float(np.ptp(off))
    med = float(np.median(off))
    if not (spread < 0.05 and (want_phase is None or abs(med) < 0.05)):
        fail(f"{what}: TOA phases {ph[:6]} spread {spread:.4f}, median "
             f"{med:.4f} from the pulse's {want_phase:.4f}")
    return {"toas": int(len(ph)), "phase_spread": spread,
            "median_offset": med}


def pulse_tools(tmp, info, card):
    """Phase 14 (g): dissect, sum_profs and pulses_to_toa on phase 6's
    DM-70 ``.dat`` (its ``.inf`` marked barycentred: synthetic data)."""
    import numpy as np

    from pypulsar_tpu_torch.cli import dissect, pulses_to_toa, sum_profs
    from pypulsar_tpu_torch.fold.pulse import read_pulse_from_file
    from pypulsar_tpu_torch.fold.toa import presto_freq_offsets
    from pypulsar_tpu_torch.io.infodata import InfoData
    from pypulsar_tpu_torch.io.parfile import write_par

    d = os.path.join(tmp, "pulses")
    os.makedirs(d)
    dat = os.path.join(d, "psr.dat")
    shutil.copy(os.path.join(tmp, "stage_DM70.00.dat"), dat)
    inf = InfoData(os.path.join(tmp, "stage_DM70.00.inf"))
    inf.bary = 1
    inf.basenm = "psr"
    inf.to_file(os.path.join(d, "psr.inf"))
    P = info["period_samples"] * info["tsamp"]
    par = os.path.join(d, "psr.par")
    write_par(par, dict(PSR="J0000+0070", F0=1.0 / P, F1=0.0,
                        PEPOCH=inf.epoch, DM=70.0))
    nb = 256
    ph = np.arange(nb) / nb
    template = os.path.join(d, "template.txt")
    np.savetxt(template, np.column_stack(
        [np.arange(nb), np.exp(-0.5 * ((ph - 0.5) / 0.004) ** 2)]))
    # the pulse's phase from the epoch: its 8 samples start each period,
    # and the TOAs are referenced to mid-band (PRESTO's get_TOAs)
    _, dmdelay = presto_freq_offsets(inf.lofreq, inf.BW, inf.chan_width,
                                     inf.DM)
    want = ((info["width"] / 2.0) * info["tsamp"] + dmdelay) / P % 1.0
    cwd = os.getcwd()
    os.chdir(d)
    numbers = {}
    try:
        t0 = time.perf_counter()
        rc, text = run_quiet(dissect.main, [
            dat, "-p", repr(P), "-s", "0.5", "-r", "0.45:0.55", "-t", "5",
            "-o", "constant.npz"])
        numbers["dissect_constant_s"] = time.perf_counter() - t0
        if rc != 0:
            fail(f"dissect (constant period) exited {rc}")
        searched = int(text.split("pulses searched:")[1].split()[0])
        good = int(text.split("good pulses found:")[1].split()[0])
        if searched < info["nsamp"] // info["period_samples"] - 2 \
                or good < 0.9 * searched:
            fail(f"dissect: {good} good pulses of {searched}")
        profs = sorted(glob.glob("psr.prof*"),
                       key=lambda f: int(f.rsplit("prof", 1)[1]))
        with np.load("constant.npz") as z:
            if len(z["joydiv_numbers"]) != good:
                fail("dissect: the .npz lacks the joy-division profiles")
        numbers.update(pulses_searched=searched, good_pulses=good)
        t0 = time.perf_counter()
        rc, text = run_quiet(dissect.main, [
            dat, "--use-parfile", par, "-t", "5", "--toas", "--template",
            template, "--min-pulses", "8", "--no-text-files",
            "--no-pulse-plots", "--no-joydiv-plot"])
        numbers["dissect_par_s"] = time.perf_counter() - t0
        if rc != 0:
            fail(f"dissect --use-parfile exited {rc}")
        numbers["dissect_par"] = check_toas("dissect --use-parfile", text,
                                            inf.epoch, P, want)
        t0 = time.perf_counter()
        rc, _ = run_quiet(sum_profs.main, profs[:16] + ["--scale", "-o",
                                                        "summed"])
        numbers["sum_profs_s"] = time.perf_counter() - t0
        if rc != 0:
            fail(f"sum_profs exited {rc}")
        summed = read_pulse_from_file("summed.summedprof")
        peak = int(np.argmax(summed.profile)) / summed.N
        if not 0.45 < peak < 0.55 or summed.profile.max() < 10:
            fail(f"sum_profs: the summed profile peaks at phase {peak} "
                 f"at {summed.profile.max()} sigma")
        numbers["summed_peak_sigma"] = float(summed.profile.max())
        t0 = time.perf_counter()
        rc, text = run_quiet(pulses_to_toa.main, profs[:64] + [
            "--template", template, "--min-pulses", "8"])
        numbers["pulses_to_toa_s"] = time.perf_counter() - t0
        if rc != 0:
            fail(f"pulses_to_toa exited {rc}")
        # without an ephemeris the reference's TOA is referenced to the
        # template's peak, not the pulse's phase: only their spread is held
        numbers["pulses_to_toa"] = check_toas("pulses_to_toa", text,
                                              inf.epoch, P)
    finally:
        os.chdir(cwd)
    print("path pulse_tools: " + json.dumps({**numbers,
                                             "pulse_phase": want,
                                             "card": card}))


def accel_counters():
    """The accel search's process-wide counters, which the accel CLI and
    the sweep's handoff both bump."""
    from pypulsar_tpu_torch.fourier import accelsearch

    return accelsearch.COUNTERS


def clear_accel_counters(what):
    """Clear the accel counters, failing first if a batch fell back to
    serial searches since they were last cleared: every path run before
    ``what`` is unfaulted."""
    n = accel_counters()["accel.serial_fallbacks"]
    if n:
        fail(f"{n} accel batches fell back to serial searches on the "
             f"unfaulted paths run before {what}")
    accel_counters().clear()


def accel_hour_phase(tmp, fn, info, card, setup, device="cuda"):
    """Phase 14: returns the launches of each new driven path."""
    launches = hour_runs(tmp, card, device, setup)
    launches.update(fft_and_options(tmp, card, device))
    launches.update(hostprep_stage(tmp, fn, info, card))
    pulse_tools(tmp, info, card)
    return launches


# ---------------------------------------------------------------------------
# phase 15: kill and resume (the sweep, a DDplan, the fold) and the
# per-chunk single-pulse events
# ---------------------------------------------------------------------------

EVENTS_CHUNK = 16384  # --all-events' default --chunk
EVENTS_THRESHOLD = 6.0  # the sweep's default --threshold
EVENTS_EVERY = 4  # --checkpoint-every of the killed sweep
EVENTS_KILL_AT = 3  # the killed sweep dies right after this save
EVENTS_WINDOW = (136, 144)  # the trial group of DM 70 (group size 8)
DDPLAN_CHUNK = 1 << 16  # several chunks in every DDplan step
FOLD_KILL_AFTER = 2  # fold groups the killed foldbatch completes
# A child run of a CLI that SIGKILLs itself at a set point, so that each
# kill is deterministic; nothing in the package changes for it. Modes:
# "save N:PATH" dies right after the N-th checkpoint save to PATH, "marker
# SUFFIX" right after a DDplan step's done marker ending in SUFFIX is
# written, "fold N" at the fold dispatch after N groups.
KILL_RUNNER = r"""
import os, signal, sys
from pypulsar_tpu_torch.cli import foldbatch, sweep as sweep_cli
from pypulsar_tpu_torch.parallel import foldpipe, staged, sweep

mode, arg, tool, argv = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]


def die():
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)


if mode == "save":
    n, path = arg.split(":", 1)
    real_save, saves = sweep.SweepCheckpoint.save, [0]

    def save(self, *a, **kw):
        real_save(self, *a, **kw)
        if self.path == path:
            saves[0] += 1
            if saves[0] >= int(n):
                die()

    sweep.SweepCheckpoint.save = save
elif mode == "marker":
    real_marker = staged._save_step_result

    def marker(path, *a):
        real_marker(path, *a)
        if path.endswith(arg):
            die()

    staged._save_step_result = marker
elif mode == "fold":
    real_dispatch, groups = foldpipe._fold_dispatch, [0]

    def dispatch(*a, **kw):
        groups[0] += 1
        if groups[0] > int(arg):
            die()
        return real_dispatch(*a, **kw)

    foldpipe._fold_dispatch = dispatch
if tool == "sweep_host_ds":  # the sweep with host-summed blocks
    import functools

    staged.sweep_ddplan = functools.partial(staged.sweep_ddplan,
                                            host_downsample=True)
    tool = "sweep"
main = {"sweep": sweep_cli.main, "foldbatch": foldbatch.main}[tool]
sys.exit(main(argv))
"""


def killed_run(mode, arg, tool, argv, timeout=600):
    """``tool`` in a child that kills itself at the set point; fails unless
    it died by that kill. Returns its wall seconds."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", KILL_RUNNER, mode, arg,
                           tool, *argv, *UNTUNED], cwd=HERE,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != -signal.SIGKILL:
        fail(f"the killed {tool} run ({mode} {arg}) exited "
             f"{proc.returncode}, not by its kill: {proc.stderr[-3000:]}")
    return time.perf_counter() - t0


def same_files(a_base, b_base, exts):
    for ext in exts:
        with open(a_base + ext, "rb") as a, open(b_base + ext, "rb") as b:
            if a.read() != b.read():
                fail(f"{b_base}{ext}: not the bytes of {a_base}{ext}")


def ckpt_state(path):
    """(cursor, chunks of peaks held, bytes) of a checkpoint file."""
    import numpy as np

    with np.load(path) as z:
        peaks = int(z["chunk_mb"].shape[0]) if "chunk_mb" in z else 0
        return int(z["cursor"]), peaks, os.path.getsize(path)


def post_cursor_launches(full, resumed, n_chunks, k):
    """Every sweep kernel of the resumed run launched exactly for the
    ``n_chunks - k`` chunks after the cursor, at the uninterrupted run's
    launches a chunk."""
    for name in SWEEP_KERNELS:
        if full[name] % n_chunks or full[name] == 0:
            fail(f"{name}: {full[name]} launches over {n_chunks} chunks")
        want = full[name] // n_chunks * (n_chunks - k)
        if resumed[name] != want:
            fail(f"{name}: the resumed run launched {resumed[name]}, the "
                 f"{n_chunks - k} chunks after the cursor need {want}")


def event_rows(path, lo_dm, hi_dm):
    """{(dm, width, chunk): (snr, sample)} of an ``.events`` file's rows in
    [lo_dm, hi_dm]."""
    rows = {}
    with open(path) as f:
        for ln in f.read().splitlines()[1:]:
            p = ln.split()
            dm = float(p[0])
            if lo_dm <= dm <= hi_dm:
                key = (round(dm, 4), int(p[4]), int(p[3]) // EVENTS_CHUNK)
                rows[key] = (float(p[1]), int(p[3]))
    return rows


def hold_events_to_cpu(fn, path, full_plan, overlap):
    """The card's ``.events`` rows of DM 70's trial group against the CPU
    port's per-chunk peaks of that group (its plan's group is the card
    plan's, so the shifts are the same; the CPU stream has the card's
    blocks, so the baseline is the same): matched by (DM, width, chunk),
    SNR within 2e-6 relative plus half the print's last digit, the same
    sample or one holding the same integer window sum (a tie); a row
    only one side holds lies within that bound of the threshold."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    lo, hi = EVENTS_WINDOW
    g = lo // full_plan.group_size
    dms = full_plan.dms[lo:hi]
    with FilterbankFile(fn) as r:
        src = staged.ReaderSource(r)
        plan = sweep.make_sweep_plan(dms, src.frequencies, src.tsamp,
                                     nsub=full_plan.nsub,
                                     group_size=full_plan.group_size)
        if not (np.array_equal(plan.stage1_bins[0], full_plan.stage1_bins[g])
                and np.array_equal(plan.stage2_bins[0],
                                   full_plan.stage2_bins[g])):
            fail("the CPU window's shifts are not the card plan's")
        t0 = time.perf_counter()
        cpu = sweep.sweep_stream(
            plan, src.chan_major_blocks(EVENTS_CHUNK, overlap,
                                        torch.device("cpu")),
            EVENTS_CHUNK, device="cpu", keep_chunk_peaks=True)
        cpu_s = time.perf_counter() - t0
        hdr, C, T = r.header_size, r.nchans, r.nspec
    want = {(round(e["dm"], 4), e["width"], e["sample"] // EVENTS_CHUNK):
            (e["snr"], e["sample"]) for e in cpu.events(EVENTS_THRESHOLD)}
    got = event_rows(path, float(dms[0]), float(dms[-1]))
    if not want:
        fail("the CPU port found no event in DM 70's trial group")
    raw = np.memmap(fn, dtype=np.uint8, mode="r", offset=hdr, shape=(T, C))
    per = C // plan.nsub
    bound = 2e-6 * EVENTS_THRESHOLD + 5e-4 + 1e-9
    for key in set(got) ^ set(want):
        snr = (got.get(key) or want.get(key))[0]
        if abs(snr - EVENTS_THRESHOLD) > bound:
            fail(f"event {key} (SNR {snr}) on one side only")
    ties = max_err = 0
    for key in set(got) & set(want):
        (a, sa), (b, sb) = got[key], want[key]
        max_err = max(max_err, abs(a - b))
        if abs(a - b) > 2e-6 * abs(b) + 5e-4 + 1e-9:
            fail(f"event {key}: card SNR {a}, CPU {b}")
        if sa != sb:
            ti = int(np.argmin(np.abs(dms - key[0])))
            tot = plan.stage1_bins[0] + np.repeat(plan.stage2_bins[0, ti],
                                                  per)
            sums = [sum(int(raw[s + tot[c]:s + tot[c] + key[1], c].sum(
                dtype=np.int64)) for c in range(C)) for s in (sa, sb)]
            if sums[0] != sums[1]:
                fail(f"event {key}: samples {sa} and {sb} hold window sums "
                     f"{sums}")
            ties += 1
    return dict(rows_card=len(got), rows_cpu=len(want),
                matched=len(set(got) & set(want)), proven_ties=ties,
                max_abs_snr_diff=max_err, cpu_sweep_s=cpu_s)


def resume_sweep(tmp, fn, info, card):
    """Phase 15 (a): ``cli.sweep --all-events`` over phase 4's 1024
    trials, uninterrupted (``--checkpoint``, its saves timed), killed right
    after its third save, then ``--resume``: the resumed ``.cands``,
    ``.events`` and ``.pulses`` the uninterrupted bytes, the sweep kernels
    launched for the chunks after the cursor only, the bytes shipped those
    chunks' blocks, the events of DM 70's group held to the CPU port's."""
    import numpy as np

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    flags = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
             "--nsub", "64", "--all-events", "--device", "cuda"]
    T = info["nsamp"]
    with FilterbankFile(fn) as r:
        plan, payload, _ = staged.step_geometry(
            staged.ReaderSource(r), 0.5 * np.arange(1024), 1, 64, 0,
            sweep.DEFAULT_WIDTHS, EVENTS_CHUNK)
    if payload != EVENTS_CHUNK:
        fail(f"the events sweep's payload is {payload}")
    n_chunks = -(-T // payload)
    full = os.path.join(tmp, "ev_full")
    saves = []
    real_save = sweep.SweepCheckpoint.save

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        real_save(self, *a, **kw)
        saves.append((time.perf_counter() - t0, os.path.getsize(self.path)))

    sweep.SweepCheckpoint.save = timed_save
    try:
        with PathMeter("events_uninterrupted", card) as pm_full:
            rc = cli.main(flags + ["-o", full, "--checkpoint",
                                   full + ".ckpt", "--checkpoint-every",
                                   str(EVENTS_EVERY)])
    finally:
        sweep.SweepCheckpoint.save = real_save
    if rc != 0 or os.path.exists(full + ".ckpt"):
        fail(f"the uninterrupted events sweep exited {rc} or left its "
             f"checkpoint")
    if len(saves) != n_chunks // EVENTS_EVERY:
        fail(f"{len(saves)} checkpoint saves over {n_chunks} chunks")
    pm_full.line(chunks=n_chunks, checkpoint_saves=len(saves),
                 save_s_mean=sum(s for s, _ in saves) / len(saves),
                 save_s_max=max(s for s, _ in saves),
                 checkpoint_bytes_last=saves[-1][1])
    ck, res = os.path.join(tmp, "ev.ckpt"), os.path.join(tmp, "ev_res")
    argv = flags + ["-o", res, "--checkpoint", ck, "--checkpoint-every",
                    str(EVENTS_EVERY)]
    kill_s = killed_run("save", f"{EVENTS_KILL_AT}:{ck}", "sweep", argv)
    cursor, peaks, ck_bytes = ckpt_state(ck)
    k = EVENTS_KILL_AT * EVENTS_EVERY
    if cursor != k * payload or peaks != k:
        fail(f"the killed sweep's checkpoint holds cursor {cursor} and "
             f"{peaks} chunks of peaks, not {k * payload} and {k}")
    if os.path.exists(res + ".cands"):
        fail("the killed sweep published its .cands")
    starts = []
    real_update = sweep._Accum.update

    def update(self, start, *a):
        starts.append(start)
        return real_update(self, start, *a)

    sweep._Accum.update = update
    try:
        with PathMeter("checkpoint_resume", card) as pm:
            rc = cli.main(argv + ["--resume"])
    finally:
        sweep._Accum.update = real_update
    if rc != 0 or os.path.exists(ck):
        fail(f"the resumed sweep exited {rc} or left its checkpoint")
    if min(starts) != cursor or len(starts) != n_chunks - k:
        fail(f"the resumed sweep accumulated {len(starts)} chunks from "
             f"{min(starts)}; the cursor is {cursor}")
    same_files(full, res, (".cands", ".events", ".pulses"))
    post_cursor_launches(pm_full.launches, pm.launches, n_chunks, k)
    C = info["nchan"]  # one byte a sample
    blocks = sum(min(payload + plan.min_overlap, T - pos) * C
                 for pos in range(cursor, T, payload))
    if not blocks <= pm.shipped <= blocks + plan.min_overlap * C:
        fail(f"the resumed sweep shipped {pm.shipped} bytes; the blocks "
             f"after the cursor hold {blocks}")
    held = hold_events_to_cpu(fn, res + ".events", plan, plan.min_overlap)
    pm.line(uninterrupted_wall_s=pm_full.wall_s, killed_run_wall_s=kill_s,
            cursor=cursor, chunks=n_chunks, chunks_resumed=n_chunks - k,
            checkpoint_bytes=ck_bytes, post_cursor_block_bytes=blocks,
            uninterrupted_bytes_shipped=pm_full.shipped,
            events_vs_cpu=held)
    return pm.launches


class StepCounter:
    """Each ``staged.run_step`` call of one run: its downsampling and the
    kernel launches inside it (``steps``), and in ``details`` also
    whether its blocks were summed on the host, its wall, the bytes it
    shipped and its result."""

    def __enter__(self):
        from pypulsar_tpu_torch.parallel import staged

        self.staged, self.real = staged, staged.run_step
        self.steps, self.details = [], []

        def counted(src, dms, factor, *a, **kw):
            import torch

            from pypulsar_tpu_torch.parallel.prefetch import ship_ahead

            before = collections.Counter(launch_counts())
            shipped = ship_ahead.bytes
            host = staged.host_downsample_wins(src, factor,
                                               kw.get("host_downsample"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(src, dms, factor, *a, **kw)
            torch.cuda.synchronize()
            launches = dict(collections.Counter(launch_counts()) - before)
            self.steps.append((int(factor), launches))
            self.details.append(dict(
                downsamp=int(factor), host_sums=host,
                wall_s=time.perf_counter() - t0,
                bytes_shipped=ship_ahead.bytes - shipped, launches=launches,
                result=None if out is None else out.result))
            return out

        staged.run_step = counted
        return self

    def __exit__(self, *exc):
        self.staged.run_step = self.real


def resume_ddplan(tmp, fn, card):
    """Phase 15 (b): ``cli.sweep --ddplan --lodm 0 --hidm 512 --chunk
    65536`` uninterrupted; with ``--checkpoint`` killed right after step
    0's done marker, then with ``--resume`` killed after step 1's first
    save, then resumed: the uninterrupted ``.cands`` bytes, no launch for
    step 0, step 1's launches only after its cursor, the markers gone."""
    import argparse

    import numpy as np

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    flags = [fn, "--ddplan", "--lodm", "0", "--hidm", "512", "--nsub", "64",
             "--chunk", str(DDPLAN_CHUNK), "--device", "cuda"]
    with FilterbankFile(fn) as r:
        ddplan = cli.make_ddplan(r, argparse.Namespace(
            lodm=0.0, hidm=512.0, plan_numsub=0, resolution=0.0))
        step1 = ddplan.DDsteps[1]
        _, payload1, n_ds1 = staged.step_geometry(
            staged.ReaderSource(r), np.asarray(step1.DMs, np.float64),
            int(step1.downsamp), 64, 0, sweep.DEFAULT_WIDTHS, DDPLAN_CHUNK)
    n1 = -(-n_ds1 // payload1)
    full = os.path.join(tmp, "dd_full")
    with StepCounter() as full_steps, PathMeter("ddplan_uninterrupted",
                                                card) as pm_full:
        rc = cli.main(flags + ["-o", full])
    if rc != 0 or len(full_steps.steps) != len(ddplan.DDsteps):
        fail(f"the uninterrupted DDplan exited {rc} over "
             f"{len(full_steps.steps)} steps")
    pm_full.line(steps=len(ddplan.DDsteps))
    ck, res = os.path.join(tmp, "dd.ckpt"), os.path.join(tmp, "dd_res")
    argv = flags + ["-o", res, "--checkpoint", ck, "--checkpoint-every", "1"]
    kill1_s = killed_run("marker", ".step0.done.npz", "sweep", argv)
    if not os.path.exists(ck + ".step0.done.npz"):
        fail("the killed DDplan left no step-0 marker")
    kill2_s = killed_run("save", f"1:{ck}.step1.npz", "sweep",
                         argv + ["--resume"])
    cursor, _, _ = ckpt_state(ck + ".step1.npz")
    k1 = cursor // payload1
    if cursor % payload1 or not 0 < k1 < n1:
        fail(f"step 1's checkpoint cursor {cursor} is not inside the step "
             f"({n1} chunks of {payload1})")
    with StepCounter() as steps, PathMeter("ddplan_resume", card) as pm:
        rc = cli.main(argv + ["--resume"])
    if rc != 0:
        fail(f"the resumed DDplan exited {rc}")
    same_files(full, res, (".cands",))
    if [d for d, _ in steps.steps] != [d for d, _ in full_steps.steps[1:]]:
        fail(f"the resumed DDplan swept steps {steps.steps}: step 0 comes "
             f"from its marker")
    post_cursor_launches(full_steps.steps[1][1], steps.steps[0][1], n1, k1)
    for (_, a), (_, b) in zip(steps.steps[1:], full_steps.steps[2:]):
        if a != b:
            fail(f"a resumed step launched {a}, uninterrupted {b}")
    if any(os.path.exists(f"{ck}.step{i}{ext}")
           for i in range(len(ddplan.DDsteps))
           for ext in (".npz", ".done.npz")):
        fail("the resumed DDplan left a checkpoint or marker")
    pm.line(uninterrupted_wall_s=pm_full.wall_s, killed_runs_wall_s=[
        kill1_s, kill2_s], step1_cursor=cursor, step1_chunks=n1,
        step1_chunks_resumed=n1 - k1,
        per_step_launches=[la for _, la in steps.steps])
    return pm.launches


def resume_fold(tmp, card):
    """Phase 15 (c): ``cli.foldbatch --journal`` on phase 7's sifted list
    (``--datbase``, batch 32) killed at its third fold group, then run
    again: the polynomial fold launched once for each group left, every
    archive the bytes of phase 7's, every summary row's refined values
    phase 7's (the first groups' taken from the journal's notes); a third
    run folds nothing."""
    from pypulsar_tpu_torch.cli import foldbatch

    stage, sifted = os.path.join(tmp, "stage"), os.path.join(
        tmp, "fold.accelcands")
    ref = os.path.join(tmp, "fold_dats")
    with open(ref + "_foldbatch.json") as f:
        ref_rows = {r["name"]: r for r in json.load(f)["results"]}
    counts = collections.Counter(r["dm"] for r in ref_rows.values())
    n_groups = sum(-(-n // 32) for n in counts.values())
    if n_groups <= FOLD_KILL_AFTER:
        fail(f"phase 7's list has {n_groups} fold groups")
    out, jnl = os.path.join(tmp, "fold_res"), os.path.join(tmp,
                                                           "fold_res.jsonl")
    argv = ["--cands", sifted, "-n", str(FOLD_NBINS), "--npart",
            str(FOLD_NPART), "--device", "cuda", "--datbase", stage,
            "--batch", "32", "-o", out, "--journal", jnl]
    kill_s = killed_run("fold", str(FOLD_KILL_AFTER), "foldbatch", argv)
    with PathMeter("fold_resume", card) as pm:
        rc = foldbatch.main(argv)
    if rc != 0:
        fail(f"the resumed foldbatch exited {rc}")
    with open(out + "_foldbatch.json") as f:
        summary = json.load(f)
    if pm.launches["fold_parts_poly"] != n_groups - FOLD_KILL_AFTER:
        fail(f"the resumed fold launched {pm.launches['fold_parts_poly']} "
             f"folds for {n_groups - FOLD_KILL_AFTER} groups left")
    if summary["n_folded"] + summary["n_skipped"] != len(ref_rows) or \
            not summary["n_skipped"]:
        fail(f"the resumed fold folded {summary['n_folded']} and skipped "
             f"{summary['n_skipped']} of {len(ref_rows)}")
    for r in summary["results"]:
        want = ref_rows[r["name"]]
        for key in ("best_period", "best_pdot", "chi2_best"):
            if r.get(key) != want[key]:
                fail(f"{r['name']}: {key} {r.get(key)}, phase 7 {want[key]}")
        with open(r["pfd"], "rb") as a, open(want["pfd"], "rb") as b:
            if a.read() != b.read():
                fail(f"{r['pfd']}: not the bytes of {want['pfd']}")
    with PathMeter("fold_rerun", card) as again:
        rc = foldbatch.main(argv)
    if rc != 0 or again.launches["fold_parts_poly"]:
        fail(f"a rerun of a complete journal exited {rc}, launching "
             f"{again.launches['fold_parts_poly']} folds")
    pm.line(killed_run_wall_s=kill_s, groups=n_groups,
            groups_refolded=n_groups - FOLD_KILL_AFTER,
            skipped=summary["n_skipped"], folded=summary["n_folded"],
            rerun_wall_s=again.wall_s)
    return pm.launches


def resume_phase(tmp, fn, info, card):
    """Phase 15: returns the launches of each resumed path."""
    return {"checkpoint_resume": resume_sweep(tmp, fn, info, card),
            "ddplan_resume": resume_ddplan(tmp, fn, card),
            "fold_resume": resume_fold(tmp, card)}


# ---------------------------------------------------------------------------
# phase 16: telemetry and fault injection
# ---------------------------------------------------------------------------

#: the stage's files whose bytes a traced, faulted or resumed run must keep
STAGE_OUTPUTS = ("_DM*.dat", "_DM*_ACCEL_200.cand",
                 "_DM*_ACCEL_200.txtcand")


def same_outputs(ref_base, base, patterns=STAGE_OUTPUTS, single=(".cands",)):
    """Fail unless every file of ``ref_base`` under ``patterns`` (and each
    ``single`` suffix) has its bytes under ``base``; returns the count."""
    n = 0
    for pat in patterns:
        refs = sorted(glob.glob(ref_base + pat))
        got = sorted(glob.glob(base + pat))
        if not refs or len(got) != len(refs):
            fail(f"{base}{pat}: {len(got)} files, {ref_base}{pat} has "
                 f"{len(refs)}")
        for r in refs:
            same_files(r, base + r[len(ref_base):], ("",))
            n += 1
    for ext in single:
        same_files(ref_base + ext, base + ext, ("",))
        n += 1
    return n


def read_trace(path):
    """(records, last counters record, span seconds by name summed over
    every span record, aggregated or sink-only)."""
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    counters = [r for r in recs if r["type"] == "counters"][-1]
    spans = collections.defaultdict(float)
    for r in recs:
        if r["type"] == "span":
            spans[r["name"]] += r["dur"]
    return recs, counters, dict(spans)


def tlmsum_text(paths):
    """``tlmsum``'s text of the traces at ``paths``."""
    import contextlib
    import io

    from pypulsar_tpu_torch.cli import tlmsum

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if tlmsum.main(list(paths)) != 0:
            fail(f"tlmsum of {paths} failed")
    return buf.getvalue()


def telemetry_record_cost(path, n=2000):
    """Host seconds a trace record costs: ``n`` spans, events and counter
    bumps into a sink at ``path``, over the records they wrote."""
    from pypulsar_tpu_torch.obs import telemetry

    with telemetry.session(path):
        t0 = time.perf_counter()
        for i in range(n):
            with telemetry.span("cost", i=i):
                telemetry.counter("cost.n")
            telemetry.event("cost.e", i=i)
        took = time.perf_counter() - t0
    return took / (2 * n)


def traced_stage(tmp, fn, card):
    """Phase 16 (a): phase 6's sweep stage run untraced and traced, back
    to back: the same launches and bytes (each the bytes of phase 6's),
    each wall, the trace's size and its account of the stage. Returns
    the traced run's launches."""
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli

    ref = os.path.join(tmp, "stage")
    runs = {}
    for label in ("untraced", "traced"):
        out = os.path.join(tmp, f"tlm_{label}")
        trace = out + ".jsonl"
        extra = ["--write-dats"] + (["--telemetry", trace]
                                    if label.startswith("traced") else [])
        with PathMeter("telemetry_stage" if label == "traced"
                       else "stage_" + label, card) as pm:
            rc = cli.main(stage_argv(fn, out, STAGE_LODM, STAGE_DMS, extra))
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            fail(f"the {label} sweep stage exited {rc}")
        runs[label] = dict(pm=pm, out=out, trace=trace, peak=peak,
                           files=same_outputs(ref, out))
        if pm.launches != runs["untraced"]["pm"].launches:
            fail(f"the {label} stage launched {pm.launches}, the untraced "
                 f"{runs['untraced']['pm'].launches}")
    u, t = runs["untraced"], runs["traced"]
    walls = {k: v["pm"].wall_s for k, v in runs.items()}
    traced_s, untraced_s = walls["traced"], walls["untraced"]
    recs, counters, spans = read_trace(t["trace"])
    c, g = counters["counters"], counters["gauges"]
    if recs[0]["type"] != "meta" or recs[0].get("version") != 1 or \
            recs[-1]["type"] != "end":
        fail("the trace does not open with a version-1 meta record and "
             "close with an end record")
    if c.get("h2d.bytes", 0) != t["pm"].shipped:
        fail(f"h2d.bytes {c.get('h2d.bytes')} is not the "
             f"{t['pm'].shipped} bytes the ship copied")
    if c.get("sweep.trials_completed") != STAGE_DMS or \
            c.get("accel.spectra_searched") != STAGE_DMS:
        fail(f"the trace's work counters are off: {c}")
    for name in ("dispatch_sweep_chunk", "dedisperse_chunk",
                 "accel_stage_batch", "accel_search", "accel_write",
                 "accel_prep_device"):
        if name not in spans:
            fail(f"the trace holds no {name} span")
    devices = [r for r in recs if r["type"] == "device"]
    end = next(r for r in devices if r["tag"] == "session_end")["devices"]
    if not end or end[0].get("peak_bytes_in_use") != t["peak"]:
        fail(f"the session_end device record {end} does not hold "
             f"max_memory_allocated() = {t['peak']}")
    text = tlmsum_text([t["trace"]])
    table = text.split("# stage breakdown:")[1].split("#\n")[0]
    record_s = telemetry_record_cost(os.path.join(tmp, "tlm_cost.jsonl"))
    print("tlmsum stage table of the traced stage:\n" + table.rstrip())
    t["pm"].line(
        walls_s=walls, overhead_fraction=traced_s / untraced_s - 1.0,
        record_cost_us=record_s * 1e6,
        records_cost_s=record_s * len(recs),
        trace_bytes=os.path.getsize(t["trace"]), trace_records=len(recs),
        span_seconds={k: spans[k] for k in sorted(spans)},
        h2d_bytes=c.get("h2d.bytes"), d2h_bytes=c.get("d2h.bytes"),
        d2h_pulls=c.get("d2h.pulls"),
        series_bytes=STAGE_DMS * 4 * (1 << 20),
        sweep_chunks=c.get("sweep.chunks"),
        pending_depth_max=g.get("sweep.pending_depth", {}).get("max"),
        ship_pending_depth_max=g.get("sweep.ship.pending_depth",
                                     {}).get("max"),
        peak_bytes_in_use=end[0]["peak_bytes_in_use"],
        max_memory_allocated=t["peak"], untraced_peak=u["peak"],
        files_equal=t["files"])
    return t["pm"].launches


def fault_accel_oom(tmp, fn, card):
    """Phase 16 (b): the stage with ``oom:accel.batch_dispatch:1``: the
    fault fired once, one OOM backoff, no serial fallback, and the bytes
    of phase 6's tables."""
    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.resilience import faultinject

    out = os.path.join(tmp, "fault_oom")
    faultinject.reset()
    with PathMeter("fault_accel_oom", card) as pm, \
            telemetry.session() as tlm:
        rc = cli.main(stage_argv(fn, out, STAGE_LODM, STAGE_DMS, [
            "--write-dats", "--fault-inject", "oom:accel.batch_dispatch:1"]))
        c = tlm.counter_totals()
    fired = faultinject.fired_counts()
    faultinject.reset()
    if rc != 0:
        fail(f"the OOM-faulted stage exited {rc}")
    if fired != {"oom": 1} or c.get("resilience.oom_backoffs") != 1:
        fail(f"oom:accel.batch_dispatch:1 fired {fired}, "
             f"{c.get('resilience.oom_backoffs')} backoffs")
    if c.get("accel.serial_fallbacks", 0):
        fail(f"the faulted stage fell back to serial searches: {c}")
    n = same_outputs(os.path.join(tmp, "stage"), out)
    pm.line(fired=fired, oom_backoffs=c["resilience.oom_backoffs"],
            serial_fallbacks=c.get("accel.serial_fallbacks", 0),
            files_equal=n)
    return pm.launches


def fault_fold_oom(tmp, card):
    """Phase 16 (c): ``foldbatch --telemetry --fault-inject
    oom:fold.batch_dispatch:N`` on phase 7's list, N the first DM group of
    more than one candidate (a batch of one cannot halve): the fault
    fired, one backoff, every archive the bytes of phase 7's."""
    from pypulsar_tpu_torch.cli import foldbatch
    from pypulsar_tpu_torch.parallel import foldpipe
    from pypulsar_tpu_torch.resilience import faultinject

    sifted = os.path.join(tmp, "fold.accelcands")
    cands = foldpipe.load_candidates(sifted)
    groups = foldpipe._group_by_dm(list(enumerate(cands)), 32)
    multi = [i for i, (_, m) in enumerate(groups) if len(m) > 1]
    if not multi:
        fail("phase 7's list has no DM group of more than one candidate")
    hit = multi[0] + 1
    out, trace = os.path.join(tmp, "fault_fold"), os.path.join(
        tmp, "fault_fold.jsonl")
    spec = f"oom:fold.batch_dispatch:{hit}"
    faultinject.reset()
    with PathMeter("fault_fold_oom", card) as pm:
        rc = foldbatch.main([
            "--cands", sifted, "-n", str(FOLD_NBINS), "--npart",
            str(FOLD_NPART), "--device", "cuda", "--datbase",
            os.path.join(tmp, "stage"), "--batch", "32", "-o", out,
            "--telemetry", trace, "--fault-inject", spec])
    fired = faultinject.fired_counts()
    faultinject.reset()
    if rc != 0:
        fail(f"the OOM-faulted fold exited {rc}")
    _, counters, spans = read_trace(trace)
    c = counters["counters"]
    if fired != {"oom": 1} or c.get("resilience.oom_backoffs") != 1:
        fail(f"{spec} fired {fired}, {c.get('resilience.oom_backoffs')} "
             f"backoffs")
    with open(os.path.join(tmp, "fold_dats_foldbatch.json")) as f:
        ref = {r["name"]: r["pfd"] for r in json.load(f)["results"]}
    with open(out + "_foldbatch.json") as f:
        rows = json.load(f)["results"]
    if len(rows) != len(ref) or c.get("fold.cands_folded") != len(ref):
        fail(f"the faulted fold folded {c.get('fold.cands_folded')} of "
             f"{len(ref)}")
    for r in rows:
        same_files(ref[r["name"]], r["pfd"], ("",))
    pm.line(spec=spec, fired=fired,
            oom_backoffs=c["resilience.oom_backoffs"], archives=len(rows),
            group_dispatches=c.get("fold.group_dispatches"),
            span_seconds={k: spans[k] for k in sorted(spans)})
    return pm.launches


def fault_exit_resume(tmp, fn, card, series_launches):
    """Phase 16 (d): ``sweep --journal --fault-inject
    exit:accel.after_cand_write:3`` in a child, which must die by the
    fault's ``os._exit(137)`` after its third table (its trace holds the
    fault's event), then the same command resumed here: the bytes of
    phase 6's, the single-pulse pass skipped (no boxcar launch) and the
    series pass launched as in phase 6."""
    from pypulsar_tpu_torch.cli import sweep as cli

    out, jnl = os.path.join(tmp, "fault_exit"), os.path.join(
        tmp, "fault_exit_journal.jsonl")
    trace = os.path.join(tmp, "fault_exit_child.jsonl")
    argv = stage_argv(fn, out, STAGE_LODM, STAGE_DMS,
                      ["--write-dats", "--accel-batch", "4",
                       "--journal", jnl])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli.sweep", *argv,
         *UNTUNED, "--telemetry", trace, "--fault-inject",
         "exit:accel.after_cand_write:3"], cwd=HERE, capture_output=True,
        text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 137:
        fail(f"the child sweep exited {proc.returncode}, not by the exit "
             f"fault: {proc.stderr[-3000:]}")
    events = [json.loads(ln) for ln in open(trace) if ln.strip()]
    fired = [e["attrs"] for e in events if e["type"] == "event"
             and e["name"] == "resilience.fault_injected"]
    if len(fired) != 1 or fired[0]["point"] != "accel.after_cand_write":
        fail(f"the child's trace holds the fault events {fired}")
    written = len(glob.glob(out + "_DM*_ACCEL_200.cand"))
    if written != 3:
        fail(f"the child wrote {written} tables before its exit, not 3")
    with PathMeter("fault_exit_resume", card) as pm:
        rc = cli.main(argv)
    if rc != 0:
        fail(f"the resumed stage exited {rc}")
    if pm.launches["boxcar_stats"] or any(
            pm.launches[k] != series_launches[k]
            for k in ("gather_sum/stage1", "gather_sum/stage2")):
        fail(f"the resume launched {pm.launches}; the series pass "
             f"launched {dict(series_launches)} in phase 6")
    n = same_outputs(os.path.join(tmp, "stage"), out)
    pm.line(child_wall_s=child_s, child_exit=proc.returncode,
            tables_before_exit=written, files_equal=n)
    return pm.launches


def traced_fold_and_mask(tmp, fn, info, card, chain, prepfold_launches):
    """Phase 16 (e): ``prepfold --telemetry`` at phase 10's defaults (the
    launches and ``.pfd`` bytes of phase 10's default run, one
    ``fold_bins`` span a partition) and ``rfifind --telemetry`` on phase
    8's RFI copy (the ``.mask`` bytes of the chain's, ``rfifind.intervals``
    and the block-statistics spans in the trace)."""
    from pypulsar_tpu_torch.cli import prepfold, rfifind

    period = info["period_samples"] * info["tsamp"]
    out, trace = os.path.join(tmp, "tlm_prepfold.pfd"), os.path.join(
        tmp, "tlm_prepfold.jsonl")
    with PathMeter("prepfold_traced", card) as pf:
        rc = prepfold.main([fn, "-p", repr(period), "--dm", "70", "-o", out,
                            "--device", "cuda", "--telemetry", trace])
    if rc != 0:
        fail(f"the traced prepfold exited {rc}")
    if pf.launches != prepfold_launches:
        fail(f"the traced prepfold launched {pf.launches}, phase 10's "
             f"{prepfold_launches}")
    same_files(os.path.join(tmp, "prepfold_default.pfd"), out, ("",))
    recs, counters, spans = read_trace(trace)
    n_bins = sum(1 for r in recs if r["type"] == "span"
                 and r["name"] == "fold_bins")
    if n_bins != prepfold_launches["fold_chan"]:
        fail(f"the prepfold trace holds {n_bins} fold_bins spans for "
             f"{prepfold_launches['fold_chan']} fold launches")
    pf.line(fold_bins_spans=n_bins,
            fold_samples=counters["counters"].get("fold.samples"),
            trace_bytes=os.path.getsize(trace),
            span_seconds={k: spans[k] for k in sorted(spans)})
    base, mtrace = os.path.join(tmp, "tlm_rfi"), os.path.join(
        tmp, "tlm_rfi.jsonl")
    with PathMeter("rfifind_traced", card) as pm:
        rc = rfifind.main([chain["rfi"], "-o", base, "-t", "1.0",
                           "--device", "cuda", "--telemetry", mtrace])
    if rc != 0:
        fail(f"the traced rfifind exited {rc}")
    same_files(chain["outbase"] + "_rfifind.mask", base + "_rfifind.mask",
               ("",))
    recs, counters, spans = read_trace(mtrace)
    nint = counters["counters"].get("rfifind.intervals", 0)
    if not nint or "rfifind_block_stats" not in spans:
        fail(f"the rfifind trace holds {nint} intervals, spans {spans}")
    pm.line(intervals=nint, d2h_bytes=counters["counters"].get("d2h.bytes"),
            span_seconds=spans)
    return pf.launches


def telemetry_phase(tmp, fn, info, card, series_launches, chain,
                    prepfold_launches):
    """Phase 16: returns the launches of each driven path."""
    return {"telemetry_stage": traced_stage(tmp, fn, card),
            "fault_accel_oom": fault_accel_oom(tmp, fn, card),
            "fault_fold_oom": fault_fold_oom(tmp, card),
            "fault_exit_resume": fault_exit_resume(tmp, fn, card,
                                                   series_launches),
            "prepfold_traced": traced_fold_and_mask(
                tmp, fn, info, card, chain, prepfold_launches)}


# ---------------------------------------------------------------------------
# phase 17: the resident sweep, the scan engine, host downsampling and the
# tool dispatcher
# ---------------------------------------------------------------------------

RESIDENT_CHUNK = 1 << 18  # four whole chunks of the 2^20-sample file
RESIDENT_GROUP = 8  # the group phase 4's CLI picks for its grid
# a catalog naming phase 4's pulsar, harmonics and subharmonics included
KNOWN_PSR = "PSR_SMOKE 0.262144 70.0 0.002 2.0\n"
SNR_MODEL = "# phase concentration amplitude\n0.5 60.0 1.0\n"


def resident_sweep(fn, card):
    """Phase 17 (a): ``sweep_resident`` of the phase-4 file held on the
    card against ``sweep_spectra`` of the same tensor at the same
    chunking, alternately after a warm-up call of each: the same bits,
    the same launches (a whole number a chunk)."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep

    with FilterbankFile(fn) as r:
        src = staged.ReaderSource(r)
        (_, data), = list(src.chan_major_blocks(src.nsamples, 0, "cuda"))
        freqs, dt = src.frequencies, src.tsamp
    dms = 0.5 * np.arange(1024)
    kw = dict(nsub=64, group_size=RESIDENT_GROUP, chunk_payload=RESIDENT_CHUNK,
              device="cuda")
    n_chunks = data.shape[1] // RESIDENT_CHUNK
    runs = {"resident": [], "streamed": []}
    out = {}
    for warm in (sweep.sweep_spectra, sweep.sweep_resident):  # allocations
        warm(data, freqs, dt, dms, **kw)
    for kind in ("streamed", "resident", "resident", "streamed"):
        fn_ = sweep.sweep_resident if kind == "resident" else \
            sweep.sweep_spectra
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn_(data, freqs, dt, dms, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[kind].append(dict(wall_s=wall, peak_device_gb=torch.cuda.max_memory_allocated()
                               / 1e9, launches=sweep_launches()))
        if kind in out:
            for f in ("snr", "peak_sample", "mean"):
                if not np.array_equal(getattr(res, f), getattr(out[kind], f)):
                    fail(f"two {kind} sweeps differ in {f}")
        out[kind] = res
    for f in ("snr", "peak_sample", "mean", "std"):
        if not np.array_equal(getattr(out["resident"], f),
                              getattr(out["streamed"], f)):
            fail(f"sweep_resident's {f} is not sweep_spectra's at the same "
                 f"chunking")
    la, lb = runs["resident"][0]["launches"], runs["streamed"][0]["launches"]
    if la != lb or min(la.values()) < 1 or any(v % n_chunks
                                               for v in la.values()):
        fail(f"resident launches {la}, streamed {lb}: not the same whole "
             f"number a chunk ({n_chunks} chunks)")
    best = out["resident"].best(1)[0]
    if abs(best["dm"] - 70.0) > 1.0:
        fail(f"the resident sweep's best DM is {best['dm']}, not 70")
    walls = [r["wall_s"] for r in runs["resident"]]
    print("path sweep_resident: " + json.dumps({
        "card": card, "trials": len(dms), "samples": int(data.shape[1]),
        "chunks": n_chunks, "chunk": RESIDENT_CHUNK,
        "resident_data_gb": data.numel() * 4 / 1e9,
        "wall_s": walls, "dm_trials_per_s": [len(dms) / w for w in walls],
        "streamed_wall_s": [r["wall_s"] for r in runs["streamed"]],
        "peak_device_gb": runs["resident"][0]["peak_device_gb"],
        "streamed_peak_device_gb": runs["streamed"][0]["peak_device_gb"],
        "best": best, "launches": la}))
    del data
    torch.cuda.empty_cache()
    return la


def scan_engine(tmp, fn, card, gather_res, gather_launches):
    """Phase 17 (b): ``cli.sweep --engine scan`` on phase 4's grid: the
    gather engine's rows bit for bit (the CPU test holds the scan's sum
    order to be the gather kernel's) and its launches."""
    import numpy as np

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel import staged

    out = os.path.join(tmp, "scan")
    argv = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
            "--nsub", "64", "-o", out, "--device", "cuda", "--engine",
            "scan"]
    with Timed(staged, "sweep_flat") as sp, PathMeter("sweep_scan",
                                                      card) as pm:
        rc = cli.main(argv)
    if rc != 0:
        fail(f"sweep --engine scan exited {rc}")
    res = sp.result.steps[0].result
    if res.engine_info.get("engine") != "scan":
        fail(f"the scan run ran {res.engine_info}")
    for f in ("snr", "peak_sample", "mean", "std"):
        if not np.array_equal(getattr(res, f), getattr(gather_res, f)):
            fail(f"--engine scan's {f} is not the gather engine's")
    if {k: pm.launches[k] for k in SWEEP_KERNELS} != dict(gather_launches):
        fail(f"--engine scan launched {pm.launches}, gather "
             f"{gather_launches}")
    same_files(os.path.join(tmp, "obs"), out, (".cands",))
    pm.line(dm_trials_per_s=len(res.dms) / pm.wall_s,
            gather_launches=gather_launches)
    return pm.launches


def host_downsampled_ddplan(tmp, fn, card):
    """Phase 17 (c): phase 9's DDplan 0-512 with ``host_downsample=True``
    and with the default card sums, alternately; then killed inside its
    host-summed downsamp-4 step and resumed."""
    import numpy as np

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel import staged

    flags = [fn, "--ddplan", "--lodm", "0", "--hidm", "512", "--nsub", "64",
             "--device", "cuda"]
    real_ddplan = staged.sweep_ddplan
    host_sums = functools.partial(real_ddplan, host_downsample=True)
    runs = {"host": [], "device": []}
    for kind in ("host", "device", "device", "host"):
        out = os.path.join(tmp, f"dd_{kind}")
        if kind == "host":
            staged.sweep_ddplan = host_sums
        try:
            with StepCounter() as sc, PathMeter(f"ddplan_{kind}",
                                                card) as pm:
                rc = cli.main(flags + ["-o", out])
        finally:
            staged.sweep_ddplan = real_ddplan
        if rc != 0:
            fail(f"the DDplan ({kind}) exited {rc}")
        runs[kind].append((sc.details, pm))
    a_steps, b_steps = runs["host"][0][0], runs["device"][0][0]
    # 8-bit samples: every downsampled step is summed on the host, its
    # uint16 sums shipping 2 / factor B a raw sample
    if [s["host_sums"] for s in a_steps] != [s["downsamp"] > 1
                                             for s in a_steps] or \
            not any(s["host_sums"] for s in a_steps) or \
            any(s["host_sums"] for s in b_steps):
        fail(f"the DDplan's steps and host sums: "
             f"{[(s['downsamp'], s['host_sums']) for s in a_steps]} / "
             f"{[(s['downsamp'], s['host_sums']) for s in b_steps]}")
    same_files(os.path.join(tmp, "dd_host"), os.path.join(tmp, "dd_device"),
               (".cands",))
    ratios = []
    for a, b in zip(a_steps, b_steps):
        for f in ("snr", "peak_sample", "mean", "std"):
            if not np.array_equal(getattr(a["result"], f),
                                  getattr(b["result"], f)):
                fail(f"downsamp-{a['downsamp']} step: host sums change {f}")
        if a["launches"] != b["launches"]:
            fail(f"downsamp-{a['downsamp']} step launched {a['launches']} "
                 f"with host sums, {b['launches']} without")
        ratio = a["bytes_shipped"] / b["bytes_shipped"]
        want = 2.0 / a["downsamp"] if a["host_sums"] else 1.0
        if not (abs(ratio - want) <= 0.05 * want if a["host_sums"]
                else ratio == 1.0):
            fail(f"downsamp-{a['downsamp']} step shipped {ratio} of the "
                 f"device path's bytes, not about {want}")
        ratios.append(ratio)
    resumed = resume_host_step(tmp, flags, card)
    pa, pb = runs["host"][0][1], runs["device"][0][1]
    pa.line(per_step=[{k: v for k, v in s.items() if k != "result"}
                      for s in a_steps],
            step_walls_s={kind: [[s["wall_s"] for s in steps]
                                 for steps, _ in runs[kind]]
                          for kind in runs},
            walls_s={kind: [p.wall_s for _, p in runs[kind]]
                     for kind in runs},
            bytes_shipped_device_path=pb.shipped,
            per_step_bytes_device_path=[s["bytes_shipped"] for s in b_steps],
            bytes_ratio_by_step=ratios)
    pb.line(per_step=[{k: v for k, v in s.items() if k != "result"}
                      for s in b_steps])
    return pa.launches, pb.launches, resumed


def resume_host_step(tmp, flags, card):
    """Phase 17 (c), the kill, at ``--chunk 65536`` (four chunks in the
    downsamp-4 step): uninterrupted with the blocks summed on the card;
    with host sums and ``--checkpoint --checkpoint-every 1`` in a child
    killed right after the downsamp-4 step's first save, resumed here
    with host sums: steps 0 and 1 from their markers, step 2 re-rooted at
    its cursor on the host path, the uninterrupted ``.cands`` bytes."""
    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel import staged

    flags = flags + ["--chunk", str(DDPLAN_CHUNK)]
    full = os.path.join(tmp, "ddh_full")
    rc = cli.main(flags + ["-o", full])
    if rc != 0:
        fail(f"the uninterrupted DDplan at --chunk {DDPLAN_CHUNK} exited "
             f"{rc}")
    ck, res = os.path.join(tmp, "ddh.ckpt"), os.path.join(tmp, "ddh_res")
    argv = flags + ["-o", res, "--checkpoint", ck, "--checkpoint-every", "1"]
    kill_s = killed_run("save", f"1:{ck}.step2.npz", "sweep_host_ds", argv)
    cursor, _, _ = ckpt_state(ck + ".step2.npz")
    starts = []
    real = staged._host_downsampled_blocks

    def recorded(src, factor, *a):
        starts.append((factor, src.start))
        return real(src, factor, *a)

    real_ddplan = staged.sweep_ddplan
    staged._host_downsampled_blocks = recorded
    staged.sweep_ddplan = functools.partial(real_ddplan, host_downsample=True)
    try:
        with StepCounter() as sc, PathMeter("ddplan_host_ds_resume",
                                            card) as pm:
            rc = cli.main(argv + ["--resume"])
    finally:
        staged._host_downsampled_blocks = real
        staged.sweep_ddplan = real_ddplan
    if rc != 0:
        fail(f"the resumed DDplan exited {rc}")
    if [d for d, _ in sc.steps] != [4] or starts != [(4, 4 * cursor)] \
            or cursor <= 0 or min(sc.steps[0][1].get(k, 0)
                                  for k in SWEEP_KERNELS) < 1:
        fail(f"the resume swept steps {sc.steps} from host blocks at "
             f"{starts} (cursor {cursor})")
    same_files(full, res, (".cands",))
    if any(os.path.exists(f"{ck}.step{i}{ext}") for i in range(3)
           for ext in (".npz", ".done.npz")):
        fail("the resumed DDplan left a checkpoint or marker")
    pm.line(killed_run_wall_s=kill_s, step2_cursor=cursor)
    return pm.launches


def dispatcher_tools(tmp, card):
    """Phase 17 (d): ``python -m pypulsar_tpu_torch.cli`` runs ``sift
    --known-sources`` over phase 6's tables and ``pfd_snr --tsys --gain
    --haslam-map`` and ``-m`` over phase 7's archives: the outputs of the
    tools' own ``main`` in this process, the pulsar vetoed; an unknown
    tool exits 2."""
    import numpy as np

    from pypulsar_tpu_torch.astro import healpix, skytemp
    from pypulsar_tpu_torch.candstore.match import load_catalog, match_known
    from pypulsar_tpu_torch.cli import pfd_snr, sift
    from pypulsar_tpu_torch.io.accelcands import parse_candlist

    d = os.path.join(tmp, "tools")
    os.makedirs(d, exist_ok=True)
    catalog = os.path.join(d, "known.txt")
    with open(catalog, "w") as f:
        f.write(KNOWN_PSR)
    model = os.path.join(d, "psr.m")
    with open(model, "w") as f:
        f.write(SNR_MODEL)
    skymap = os.path.join(d, "haslam.fits")
    theta, _ = healpix.pix2ang(64, np.arange(healpix.npix(64)))
    skytemp.write_healpix_map(skymap, 20.0 + 80.0 * np.exp(
        -((theta - np.pi / 2) / 0.1) ** 2))
    cands = sorted(glob.glob(os.path.join(tmp, "stage_DM*_ACCEL_200.cand")))
    # phase 7's archives at the pulsar's DM
    pfds = [p for p in sorted(glob.glob(os.path.join(tmp,
                                                     "fold_dats_*.pfd")))
            if abs(float(p.split("_DM")[1].split("_")[0]) - 70.0) <= 0.5]
    if not pfds:
        fail("phase 7 left no archive at DM 70")
    runs = [("sift", cands + ["-s", "4", "--min-hits", "2",
                              "--known-sources", catalog, "-o"],
             "known.accelcands", sift.main),
            ("pfd_snr", pfds + ["--tsys", "30", "--gain", "10",
                                "--haslam-map", skymap, "--json"],
             "sky.json", pfd_snr.main),
            ("pfd_snr", pfds + ["-m", model, "--json"], "model.json",
             pfd_snr.main)]
    env = dict(os.environ, PYTHONPATH=HERE)

    def by_cli(tool, *args):  # (process, wall s) of one dispatcher run
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pypulsar_tpu_torch.cli", tool, *args],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        return proc, time.perf_counter() - t0

    # the host tools' processes run side by side (each mostly its start),
    # the unknown tool's too, and the tools' mains in this process
    # meanwhile
    with concurrent.futures.ThreadPoolExecutor(len(runs) + 1) as pool:
        procs = [pool.submit(by_cli, tool, *args,
                             os.path.join(d, "cli_" + name))
                 for tool, args, name, _ in runs]
        unknown = pool.submit(by_cli, "swep")
        for tool, args, name, main_ in runs:
            if run_quiet(main_, args + [os.path.join(d, "main_" + name)]
                         )[0] != 0:
                fail(f"{tool}.main exited non-zero")
        done = [p.result() for p in procs]
        bad = unknown.result()[0]
    walls = {}
    for (tool, _, name, _), (proc, wall) in zip(runs, done):
        walls[name] = wall
        if proc.returncode != 0:
            fail(f"python -m pypulsar_tpu_torch.cli {tool} exited "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(os.path.join(d, "cli_" + name), "rb") as a, \
                open(os.path.join(d, "main_" + name), "rb") as b:
            if a.read() != b.read():
                fail(f"{tool} through the dispatcher wrote other bytes than "
                     f"its main ({name})")
    kept = parse_candlist(os.path.join(d, "cli_known.accelcands"))
    before = parse_candlist(os.path.join(tmp, "fold.accelcands"))
    known = load_catalog(catalog)
    vetoed = [c for c in before if match_known(c.period, c.dm, known)]
    if not vetoed or len(kept) != len(before) - len(vetoed) or any(
            match_known(c.period, c.dm, known) for c in kept):
        fail(f"--known-sources kept {len(kept)} of {len(before)}, "
             f"{len(vetoed)} match the pulsar")
    rows = {}
    for name in ("sky.json", "model.json"):
        with open(os.path.join(d, "cli_" + name)) as f:
            rows[name] = json.load(f)
        snrs = [r["snr"] for r in rows[name] if r["snr"] is not None]
        if not snrs or not np.isfinite(snrs).all():
            fail(f"pfd_snr {name}: no finite SNR")
    if not any(r["smean_mjy"] for r in rows["sky.json"]):
        fail("pfd_snr --tsys/--gain gave no mean flux")
    if bad.returncode != 2 or "did you mean 'sweep'" not in bad.stderr:
        fail(f"an unknown tool exited {bad.returncode}: {bad.stderr}")
    print("path dispatcher_tools: " + json.dumps({
        "card": card, "walls_s": walls, "sifted": len(before),
        "vetoed": len(vetoed), "kept": len(kept),
        "snr_rows": {k: len(v) for k, v in rows.items()},
        "best_snr": {k: max(r["snr"] or 0.0 for r in v)
                     for k, v in rows.items()},
        "unknown_tool_rc": bad.returncode}))


def resident_phase(tmp, fn, card, gather_res, gather_launches):
    """Phase 17: returns the launches of each driven path."""
    out = {"sweep_resident": resident_sweep(fn, card),
           "sweep_scan": scan_engine(tmp, fn, card, gather_res,
                                     gather_launches)}
    (out["ddplan_host_ds"], out["ddplan_device_ds"],
     out["ddplan_host_ds_resume"]) = host_downsampled_ddplan(tmp, fn, card)
    dispatcher_tools(tmp, card)
    return out


# ---------------------------------------------------------------------------
# phase 18: the survey fleet
# ---------------------------------------------------------------------------

FLEET_FLAGS = [*CHAIN_FLAGS, "--devices", "1",
               "--max-host-workers", "2", *UNTUNED]
FLEET_STAGES = ("mask", "sweep", "sift", "fold", "snr")
FLEET_DEVICE_STAGES = ("mask", "sweep", "fold")
FLEET_KILL_AT = "exit:survey.stage_done.sweep:1"  # the sweep's done


def fleet_spans(trace):
    """``{obs: {stage: (t, dur)}}`` of a fleet trace's stage spans."""
    out = collections.defaultdict(dict)
    for rec in read_trace(trace)[0]:
        name = rec.get("name", "")
        if rec.get("type") == "span" and name.startswith("survey.stage."):
            out[rec["attrs"]["obs"]][name[len("survey.stage."):]] = (
                rec["t"], rec["dur"])
    return dict(out)


def warm_pool_view(trace):
    """The warm pool in a fleet trace: ``survey.precompiled``, each
    warmed observation's ``survey.precompile`` span (wall, count, each
    warmer's wall) and each observation's first sweep chunk dispatch
    (``dispatch_sweep_chunk``, s), matched by the trace id its stage
    spans carry."""
    recs, counters, _ = read_trace(trace)
    warmed, obs_of, first = {}, {}, {}
    for r in recs:
        if r.get("type") != "span":
            continue
        attrs = r.get("attrs") or {}
        if r["name"] == "survey.precompile":
            warmed[attrs.get("obs")] = dict(attrs, wall_s=r["dur"])
        elif r["name"].startswith("survey.stage.") and r.get("trace_id"):
            obs_of[r["trace_id"]] = attrs.get("obs")
    for r in recs:
        if r.get("type") == "span" and r["name"] == "dispatch_sweep_chunk":
            obs = obs_of.get(r.get("trace_id"))
            if obs is not None and obs not in first:
                first[obs] = r["dur"]
    return {"precompiled": counters["counters"].get("survey.precompiled", 0),
            "precompile": warmed,
            "first_sweep_dispatch_s": first}


def device_lane_idle(spans):
    """(busy s, idle s) of the device lane between its first start and
    last end: the union of the device stages' spans, and the gaps."""
    iv = sorted((t, t + d) for st in spans.values()
                for name, (t, d) in st.items()
                if name in FLEET_DEVICE_STAGES)
    busy, cur = 0.0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = (iv[-1][1] - iv[0][0]) if iv else 0.0
    return busy, span - busy


def run_fleet(files, outdir, device, extra=(), tlm=None):
    """``python -m pypulsar_tpu_torch.cli survey`` in this process (its
    dispatcher's ``main``) with the counts and the broker at 0; returns
    (stdout, wall s, launches, broker stats, peak GB)."""
    import torch

    from pypulsar_tpu_torch.cli import __main__ as dispatch
    from pypulsar_tpu_torch.parallel import broker

    argv = ["survey", *files, "-o", outdir, *FLEET_FLAGS, "--device",
            str(device), *extra]
    if tlm is not None:
        argv += ["--telemetry-dir", tlm]
    broker.reset()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out = run_quiet(dispatch.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"survey {' '.join(extra)} exited {rc}: {out[-3000:]}")
    stats = broker.get_broker().stats()
    broker.reset()
    return (out, wall, launch_counts(), stats,
            torch.cuda.max_memory_allocated() / 1e9)


def fleet_bytes(serials, outdir, label):
    """Fail unless every artifact of each observation under ``outdir``
    has the bytes of its serial chain (``_snr.json`` apart from the
    archives' directory); returns the files compared."""
    n = 0
    for name, serial in serials.items():
        base = os.path.join(outdir, name)
        for pattern in LANE_PATTERNS:
            paths = sorted(glob.glob(serial + pattern))
            if not paths or len(glob.glob(base + pattern)) != len(paths):
                fail(f"fleet {label} {name}: {len(paths)} serial files of "
                     f"{pattern}, {len(glob.glob(base + pattern))} in the "
                     f"fleet")
            n += same_bytes(paths, serial, base)
        if snr_rows(serial + "_snr.json") != snr_rows(base + "_snr.json"):
            fail(f"fleet {label} {name}: _snr.json differs from the "
                 f"serial chain's")
        n += 1
    return n


def fleet_phase(tmp, fn, info, chain, card, device="cuda"):
    """Phase 18: ``survey`` over three full-width observations on the
    card (phase 8's RFI copy, phase 11's second file, phase 4's clean
    file); returns the launches of the fleet, of the killed fleet's
    resume and of the two-lease fleet."""
    import torch

    from pypulsar_tpu_torch.candstore import CandStore
    from pypulsar_tpu_torch.cli import __main__ as dispatch
    from pypulsar_tpu_torch.survey import dag
    from pypulsar_tpu_torch.survey.state import (
        Observation,
        read_fleet_health,
        status_rows,
    )

    cfg = dag.SurveyConfig(**CHAIN_CFG)
    serial_b = chain["serial_b"]
    # the third file's serial chain (phases 8 and 11 give the other two)
    os.makedirs(os.path.join(tmp, "chain_obs"))
    serial_obs = Observation("obs", fn, os.path.join(tmp, "chain_obs", "obs"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walls_obs = dag.run_observation(serial_obs, cfg, device=device)
    torch.cuda.synchronize()
    serial_walls = {"rfi": sum(chain["walls"].values()),
                    "psrb": serial_b["wall_s"],
                    "obs": time.perf_counter() - t0}
    serials = {"rfi": chain["outbase"], "psrb": serial_b["outbase"],
               "obs": serial_obs.outbase}
    files = [chain["rfi"], serial_b["fn"], fn]
    chain["fleet"] = dict(files=files, serials=serials,
                          serial_walls=serial_walls)
    psr = info["period_samples"] * info["tsamp"]
    pulsars = {"rfi": (psr, 70.0),
               "psrb": (LANE_B_PERIOD * info["tsamp"], LANE_B_DM),
               "obs": (psr, 70.0)}

    # (a) the fleet
    out_a = os.path.join(tmp, "fleet")
    tlm = os.path.join(tmp, "fleet_tlm")
    text, wall_a, launches, stats, peak_a = run_fleet(files, out_a, device,
                                                      tlm=tlm)
    need = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats")
    if min(launches[k] for k in need) < 1 or launches["fold_parts_poly"] \
            + launches["fold_parts_multi_poly"] < 1:
        fail(f"the fleet did not launch every kernel of its path: "
             f"{launches}")
    files_equal = fleet_bytes(serials, out_a, "(a)")
    hits = {}
    for name, (period, dm) in pulsars.items():
        hits[name] = lane_hits(os.path.join(out_a, name), period, dm)
        if not hits[name]:
            fail(f"fleet {name}: no candidate at its pulsar's DM and period "
                 f"or a harmonic folds to SNR > 10")
    rows = status_rows(sorted(glob.glob(os.path.join(out_a,
                                                     "*.survey.jsonl"))))
    if sorted(r["obs"] for r in rows) != sorted(serials) or any(
            r["done"] != list(FLEET_STAGES) or r["quarantine"]
            for r in rows):
        fail(f"the fleet's manifests do not show every stage done: {rows}")
    health = read_fleet_health(out_a)
    if health is not None and any(d.get("quarantined") for d in
                                  health.get("devices", {}).values()):
        fail(f"the fleet evicted a device: {health}")
    stored = [r for r in CandStore(out_a).query()
              if r.get("obs") in ("rfi", "obs")
              and abs((r.get("dm") or 0.0) - 70.0) <= 2.0
              and r.get("p_s") and harmonic_of(r["p_s"], psr) is not None
              and (r.get("snr") or 0.0) > 10]
    if not stored:
        fail("the candidate store holds no DM-70 pulsar row of SNR > 10")
    best = max(stored, key=lambda r: r["snr"])
    rc, listed = run_quiet(dispatch.main, [
        "cands", out_a, "--near", repr(best["p_s"]), repr(best["dm"]),
        "--tol-p", "1e-6", "--tol-dm", "0.01"])
    if rc != 0 or best["obs"] not in listed or "candidate(s)" not in listed:
        fail(f"cands does not list the stored pulsar: {listed}")
    spans = fleet_spans(os.path.join(tlm, "fleet.jsonl"))
    busy, idle = device_lane_idle(spans)
    serial_sum = sum(serial_walls.values())
    warm = warm_pool_view(os.path.join(tlm, "fleet.jsonl"))
    if not warm["precompile"] or warm["precompiled"] < 1:
        fail(f"the fleet's trace shows no warm pool at work: {warm}")

    # (b) a --resume of the finished fleet runs nothing
    before = sha256s(sorted(glob.glob(os.path.join(out_a, "*_cand*.pfd"))))
    text_b, wall_b, launches_b, _, _ = run_fleet(files, out_a, device,
                                                 ["--resume"])
    if "0 stages run, 15 skipped" not in text_b or any(launches_b.values()):
        fail(f"the resume of the finished fleet ran work: {launches_b}; "
             f"{text_b[-500:]}")
    if sha256s(sorted(before)) != before:
        fail("the resume of the finished fleet changed an archive")

    # (c) a fleet of the first file killed at its sweep's boundary, then
    # --resume (one file since PR 18: the script's time)
    out_c = os.path.join(tmp, "fleet_kill")
    files_c = files[:1]
    serials_c = {"rfi": serials["rfi"]}
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey", *files_c,
         "-o", out_c, *FLEET_FLAGS, "--device", str(device),
         "--fault-inject", FLEET_KILL_AT],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    killed_s = time.perf_counter() - t0
    if proc.returncode != 137:
        fail(f"the killed fleet exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    recorded = {(r["obs"], st) for r in status_rows(sorted(glob.glob(
        os.path.join(out_c, "*.survey.jsonl")))) for st in r["done"]}
    n_stages_c = len(files_c) * len(FLEET_STAGES)
    if not recorded or len(recorded) >= n_stages_c:
        fail(f"the killed fleet recorded {sorted(recorded)}")
    text_c, wall_c, launches_c, _, _ = run_fleet(files_c, out_c, device,
                                                 ["--resume"])
    want = (f"{n_stages_c - len(recorded)} stages run, {len(recorded)} "
            f"skipped")
    if want not in text_c:
        fail(f"the resume ran other stages than the unfinished ones "
             f"({want}): {text_c[-800:]}")
    resumed_equal = fleet_bytes(serials_c, out_c, "(c)")

    # (d) two device leases on the one card over the first two files
    # (three before PR 18: the script's time), traced as (a) is
    out_d = os.path.join(tmp, "fleet_2leases")
    serials_d = {k: serials[k] for k in ("rfi", "psrb")}
    _, wall_d, launches_d, stats_d, peak_d = run_fleet(
        files[:2], out_d, device, ["--devices", "2"],
        tlm=os.path.join(tmp, "fleet_2leases_tlm"))
    leases_equal = fleet_bytes(serials_d, out_d, "(d)")

    # (e) a batch lane of the first two files' folds
    lanes = lane_fleet(files[:2], out_a, device, serials_d)
    # (f) the flight recorder's cost to an untraced stage
    ring = ring_cost(tmp, fn, card)
    # (g) a strike and a watchdog interrupt on the card
    faulted = fault_fleet(files[1:2], out_a, device,
                          {"psrb": serials["psrb"]})

    print("path survey_fleet: " + json.dumps({
        "card": card, "observations": 3,
        "fleet_wall_s": wall_a, "serial_walls_s": serial_walls,
        "serial_sum_s": serial_sum, "fleet_over_serial": wall_a / serial_sum,
        "serial_obs_stage_wall_s": walls_obs,
        "fleet_stage_wall_s": {o: {k: d for k, (_, d) in st.items()}
                               for o, st in spans.items()},
        "device_lane_busy_s": busy, "device_lane_idle_s": idle,
        "device_lane_idle_share": idle / max(busy + idle, 1e-9),
        "broker": stats, "peak_device_gb": peak_a,
        "files_equal_serial": files_equal,
        "pulsars": {k: max(h, key=lambda r: r["snr"])
                    for k, h in hits.items()},
        "stored_pulsar": {k: best[k] for k in ("obs", "p_s", "dm", "snr")},
        "warm_pool": warm,
        "fleet_health": health, "launches": launches}))
    print("path survey_fleet_resume_done: " + json.dumps({
        "card": card, "wall_s": wall_b, "launches": launches_b,
        "said": text_b.strip().splitlines()[-1]}))
    print("path survey_fleet_kill_resume: " + json.dumps({
        "card": card, "killed_child_s": killed_s,
        "recorded_at_kill": sorted(recorded), "resume_wall_s": wall_c,
        "files_equal_serial": resumed_equal, "launches": launches_c,
        "said": text_c.strip().splitlines()[-1]}))
    print("path survey_fleet_2leases: " + json.dumps({
        "card": card, "observations": 2, "wall_s": wall_d,
        "over_serial_sum": wall_d / sum(serial_walls[k] for k in serials_d),
        "peak_device_gb": peak_d, "broker": stats_d,
        "files_equal_serial": leases_equal, "launches": launches_d}))
    print("path survey_fleet_lanes: " + json.dumps({"card": card, **lanes}))
    print("path flightrec_cost: " + json.dumps({"card": card, **ring}))
    print("path survey_fleet_faults: " + json.dumps({"card": card,
                                                     **faulted}))
    return {"survey_fleet": launches, "survey_fleet_resume": launches_c,
            "survey_fleet_2leases": launches_d,
            "survey_fleet_lanes": lanes["launches"],
            "stage_ring_on": ring["launches"],
            "survey_fleet_faults": faulted["launches"]}


#: the stages (e) keeps done: the two observations' folds then queue at once
LANE_FLEET_KEEP = ("mask", "sweep", "sift")


def cut_back(obs, cfg, stages):
    """Leave ``obs`` as a fleet that finished only ``stages``: the
    manifest keeps every record but the other stages' done records, and
    every artifact of the other stages is removed."""
    from pypulsar_tpu_torch.survey import dag

    keep = {path for spec in dag.build_dag(cfg) if spec.name in stages
            for path in spec.outputs(obs, cfg)}
    keep |= {obs.manifest, obs.outbase + ".chain.jsonl"}
    for path in glob.glob(obs.outbase + "[._]*"):
        if path not in keep:
            os.remove(path)
    units = {f"stage:{name}" for name in stages}
    recs = [json.loads(ln) for ln in open(obs.manifest) if ln.strip()]
    with open(obs.manifest, "w") as f:
        for rec in recs:
            if rec.get("type") != "done" or rec.get("unit") in units:
                f.write(json.dumps(rec) + "\n")


def lane_fleet(files, outdir, device, serials):
    """Phase 18 (e): the observations of ``files`` in the fleet of
    ``outdir`` cut back to their sifts, then resumed through
    ``FleetScheduler`` with the broker's window at ``LANE_WAIT_MS``: both
    folds queue at once and run as one lane; returns its numbers and
    launches."""
    import torch

    from pypulsar_tpu_torch.cli import survey as survey_cli
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.parallel import broker
    from pypulsar_tpu_torch.survey.scheduler import FleetScheduler

    args = survey_cli.build_parser().parse_args(
        [*files, "-o", outdir, *FLEET_FLAGS])
    cfg = survey_cli._survey_config(args)
    obs = survey_cli._observations(files, outdir)
    for o in obs:
        cut_back(o, cfg, LANE_FLEET_KEEP)
    broker.reset()
    broker.get_broker().wait_ms = float(LANE_WAIT_MS)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.session() as tlm:
        res = FleetScheduler(
            obs, cfg, max_host_workers=args.max_host_workers,
            devices=args.devices, resume=True, device=device).run()
        decisions = tlm.event_counts.get("survey.lane_decision", 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stats = broker.get_broker().stats()
    broker.reset()
    n_kept = len(obs) * len(LANE_FLEET_KEEP)
    if not res.ok or len(res.skipped) != n_kept or \
            len(res.ran) != len(obs) * len(FLEET_STAGES) - n_kept:
        fail(f"the lane fleet ran {res.ran}, skipped {res.skipped}, "
             f"quarantined {res.quarantined}")
    if decisions < 1 or stats["coalesced_units"] < 2 or \
            launches["fold_parts_multi_poly"] < 1 or \
            stats["unit_retries"] or stats["fused_faults"]:
        fail(f"the fleet's folds did not run as a fused lane: {decisions} "
             f"lanes, {stats}, {launches}")
    return dict(wall_s=wall, stages_run=len(res.ran),
                stages_skipped=len(res.skipped), lanes=decisions,
                wait_ms=LANE_WAIT_MS, broker=stats,
                peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                files_equal_serial=fleet_bytes(serials, outdir, "(e)"),
                launches=launches)


#: (g)'s faults: an OOM that escapes the fold stage's start (a strike),
#: then a hang at the retry's second fold dispatch (a stall)
FLEET_FAULTS = "oom:survey.stage_start.fold:1,hang:fold.batch_dispatch:2"
FLEET_STALL_S = 3.0


def fault_fleet(files, outdir, device, serials):
    """Phase 18 (g): the observation of ``files`` cut back to its sift,
    resumed through ``FleetScheduler(..., stall_s=FLEET_STALL_S,
    retries=2)`` with ``FLEET_FAULTS`` armed: the OOM strikes the card
    (its cache emptied) and retries; the retry hangs inside a fold
    dispatch, the watchdog interrupts it, the card is synchronized and
    the fold's partial outputs scrubbed, and the second retry finishes;
    returns its numbers and launches."""
    import torch

    from pypulsar_tpu_torch.cli import survey as survey_cli
    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.resilience import faultinject
    from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
    from pypulsar_tpu_torch.survey.state import read_fleet_health

    args = survey_cli.build_parser().parse_args(
        [*files, "-o", outdir, *FLEET_FLAGS])
    cfg = survey_cli._survey_config(args)
    obs = survey_cli._observations(files, outdir)
    for o in obs:
        cut_back(o, cfg, LANE_FLEET_KEEP)
    reset_launch_counts()
    hang_s = faultinject.HANG_S
    faultinject.HANG_S = 20 * FLEET_STALL_S  # the watchdog ends the hang
    faultinject.configure(FLEET_FAULTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with telemetry.session() as tlm:
            res = FleetScheduler(
                obs, cfg, max_host_workers=args.max_host_workers,
                devices=args.devices, resume=True, retries=2,
                stall_s=FLEET_STALL_S, device=device).run()
            events = {k: tlm.event_counts.get(k, 0) for k in (
                "mesh.device_strike", "survey.stage_stalled",
                "survey.stage_retry")}
        fired = faultinject.fired_counts()
    finally:
        faultinject.reset()
        faultinject.HANG_S = hang_s
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    health = read_fleet_health(outdir) or {}
    dev0 = health.get("devices", {}).get("0", {})
    if not res.ok or res.retried != 2 or res.timeouts != 1 or \
            res.evicted_devices or dev0.get("strikes") != 1 or \
            dev0.get("quarantined"):
        fail(f"the faulted fleet: ok {res.ok}, {res.retried} retries, "
             f"{res.timeouts} interrupts, evicted {res.evicted_devices}, "
             f"health {health}, events {events}, fired {fired}")
    if launches["fold_parts_poly"] < 1:
        fail(f"the faulted fleet's fold launched no fold kernel: {launches}")
    return dict(wall_s=wall, stall_s=FLEET_STALL_S, faults=FLEET_FAULTS,
                fired=fired, retried=res.retried, interrupts=res.timeouts,
                events=events, device_health=dev0,
                files_equal_serial=fleet_bytes(serials, outdir, "(g)"),
                launches=launches)


def ring_record_cost(n=2000):
    """Host seconds of one session-off span or event (``n`` of each)."""
    from pypulsar_tpu_torch.obs import telemetry

    t0 = time.perf_counter()
    for i in range(n):
        with telemetry.span("cost", i=i):
            pass
        telemetry.event("cost.e", i=i)
    return (time.perf_counter() - t0) / (2 * n)


def ring_cost(tmp, fn, card):
    """Phase 18 (f): phase 6's stage untraced with the flight recorder's
    ring off and then on (the same bytes as phase 6's), the ring records
    the stage wrote, and the host cost of a session-off record with the
    ring off and on, in alternating pairs; returns the numbers and the
    ring-on run's launches."""
    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.obs import flightrec

    real, written = flightrec.record, [0]

    def counted(rec):
        written[0] += 1
        real(rec)

    ref = os.path.join(tmp, "stage")
    walls, records, launches = {}, {}, None
    try:
        for label, size in (("ring_off", 0), ("ring_on", None)):
            flightrec.configure(size)
            written[0] = 0
            flightrec.record = counted
            out = os.path.join(tmp, "stage_" + label)
            with PathMeter("stage_" + label, card) as pm:
                rc = cli.main(stage_argv(fn, out, STAGE_LODM, STAGE_DMS,
                                         ["--write-dats"]))
            flightrec.record = real
            if rc != 0:
                fail(f"the stage with the {label} exited {rc}")
            same_outputs(ref, out)
            walls[label], records[label] = pm.wall_s, written[0]
            if launches is not None and pm.launches != launches:
                fail(f"the ring changed the stage's launches: "
                     f"{pm.launches}, {launches}")
            launches = pm.launches
        per_record = {"off": [], "on": []}
        for _ in range(3):
            for label, size in (("off", 0), ("on", None)):
                flightrec.configure(size)
                per_record[label].append(ring_record_cost())
    finally:
        flightrec.record = real
        flightrec.configure(None)
    extra_s = (statistics.median(per_record["on"])
               - statistics.median(per_record["off"]))
    return dict(stage_walls_s=walls, ring_records=records,
                record_cost_us={k: [x * 1e6 for x in v]
                                for k, v in per_record.items()},
                ring_cost_s=extra_s * records["ring_on"],
                ring_cost_fraction=extra_s * records["ring_on"]
                / walls["ring_off"],
                launches=launches)


# ---------------------------------------------------------------------------
# phase 19: the multi-host fleet, the streaming daemon, the serial fallback
# ---------------------------------------------------------------------------

HOST_LEASE_S = 6.0
#: (c)'s tenants: teamA owns the watched directory, teamB the socket
DAEMON_TENANTS = ("teamA:1", "teamB:0:0:4")
DAEMON_IDLE_EXIT_S = 120.0  # a bound: (c) drains by SIGTERM well before
#: the trace counter of a wrapper's launches -> the kernels line's name
TRACE_KERNELS = {
    "kernel_launches.shifted_gather_sum.stage1": "gather_sum/stage1",
    "kernel_launches.shifted_gather_sum.stage2": "gather_sum/stage2",
    "kernel_launches.shifted_gather_sum.tree_level": "gather_sum/tree_level",
    "kernel_launches.shifted_gather_sum.tree_snap": "gather_sum/tree_snap",
    "kernel_launches.boxcar_stats": "boxcar_stats",
    "kernel_launches.fold_parts_batch": "fold_parts_batch",
    "kernel_launches.fold_parts_poly": "fold_parts_poly",
    "kernel_launches.fold_parts_multi": "fold_parts_multi",
    "kernel_launches.fold_parts_multi_poly": "fold_parts_multi_poly",
    "kernel_launches.fold_chan": "fold_chan",
}
#: a survey host in a child that first builds the fleet's kernels into
#: a directory of its own choosing (argv: build dir, then survey's
#: argv): two such hosts started at once build under the build lock
HOST_RUNNER = r"""
import sys
from pypulsar_tpu_torch.ops import _build
from pypulsar_tpu_torch.cli import survey

_build.BUILD_DIR = sys.argv[1]
built = _build.build_all(('gather_sum', 'boxcar_stats', 'fold_parts',
                          'psrcodec'))
print(f"# kernels ready in {built:.1f} s, {len(_build._built)} built here",
      flush=True)
sys.exit(survey.main(sys.argv[2:]))
"""


def trace_totals(paths):
    """(launches by kernel name, every counter) summed over the traces
    at ``paths``: each trace's last counters record, partial or not (a
    SIGKILLed host flushes its counters at event cadence)."""
    from pypulsar_tpu_torch.obs.summarize import load_records, summarize

    counters = collections.Counter()
    for path in paths:
        counters.update(summarize(load_records(path)).counters)
    launches = {name: int(counters.get(key, 0))
                for key, name in TRACE_KERNELS.items()}
    return launches, dict(counters)


def check_fleet_launches(what, launches):
    need = ("gather_sum/stage1", "gather_sum/stage2", "boxcar_stats")
    if min(launches[k] for k in need) < 1 or launches["fold_parts_poly"] \
            + launches["fold_parts_multi_poly"] < 1:
        fail(f"{what} did not launch every kernel of its path: {launches}")


def no_fallbacks(what, counters):
    if counters.get("accel.serial_fallbacks", 0):
        fail(f"{what}: {counters['accel.serial_fallbacks']} accel batches "
             f"fell back to serial searches on an unfaulted path")


def done_records(outdir):
    """Every manifest ``done`` record under ``outdir``, as (manifest
    name, record)."""
    out = []
    for path in sorted(glob.glob(os.path.join(outdir, "*.survey.jsonl"))):
        for line in open(path):
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn line a killed host left
            if rec.get("type") == "done":
                out.append((os.path.basename(path), rec))
    return out


def check_tlmtrace(what, tlm):
    from pypulsar_tpu_torch.cli import tlmtrace

    import contextlib
    import io

    paths = sorted(glob.glob(os.path.join(tlm, "*.jsonl")))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, text = run_quiet(tlmtrace.main, ["--check", *paths])
    if rc != 0:
        fail(f"{what}: tlmtrace --check failed: {text[-800:]} "
             f"{err.getvalue()[-800:]}")
    return text.strip().splitlines()[-1] if text.strip() else "", \
        err.getvalue()


def survey_argv(files, outdir, extra=()):
    return ["survey", *files, "-o", outdir, *FLEET_FLAGS,
            "--device", "cuda", *extra]


def hosts_fleet(tmp, fleet, card):
    """Phase 19 (a): ``survey --hosts 2`` over the first two files."""
    from pypulsar_tpu_torch.cli import __main__ as dispatch
    from pypulsar_tpu_torch.survey.fleet import read_plane_status
    from pypulsar_tpu_torch.survey.state import status_rows

    files = fleet["files"][:2]
    serials = {k: fleet["serials"][k] for k in ("rfi", "psrb")}
    out = os.path.join(tmp, "hosts")
    tlm = os.path.join(tmp, "hosts_tlm")
    argv = survey_argv(files, out, ["--hosts", "2", "--host-lease",
                                    str(HOST_LEASE_S), "--telemetry-dir",
                                    tlm])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pypulsar_tpu_torch.cli",
                           *argv], cwd=HERE, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"survey --hosts 2 exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    done = done_records(out)
    if len(done) != len(files) * len(FLEET_STAGES) or \
            len({(m, r["unit"]) for m, r in done}) != len(done) or \
            not all(isinstance(r.get("token"), int) for _, r in done):
        fail(f"survey --hosts 2: {len(done)} done records (want "
             f"{len(files) * len(FLEET_STAGES)}, each once with a token)")
    files_equal = fleet_bytes(serials, out, "(19a)")
    rows = status_rows(sorted(glob.glob(os.path.join(out,
                                                     "*.survey.jsonl"))))
    if any(r["done"] != list(FLEET_STAGES) for r in rows):
        fail(f"survey --hosts 2: a manifest lacks a stage: {rows}")
    view = read_plane_status(out)
    owners = {o: c["host"] for o, c in view["claims"].items()}
    if set(view["hosts"]) != {"host0", "host1"} or not all(
            h.get("left") for h in view["hosts"].values()) or \
            set(owners) != set(serials) or \
            {c["state"] for c in view["claims"].values()} != {"done"}:
        fail(f"survey --hosts 2: the plane does not show both hosts LEFT "
             f"and every observation done: {view}")
    rc, text = run_quiet(dispatch.main, ["survey", "--status", "-o", out])
    lines = text.splitlines()
    if rc != 0 or "host" not in lines[0] or text.count("LEFT") != 2 or \
            not all(any(name in ln and owners[name] in ln for ln in lines)
                    for name in serials):
        fail(f"survey --status does not show both hosts LEFT and the "
             f"owners: {text}")
    paths = sorted(glob.glob(os.path.join(tlm, "fleet.host*.jsonl")))
    launches, counters = trace_totals(paths)
    check_fleet_launches("survey --hosts 2", launches)
    no_fallbacks("survey --hosts 2", counters)
    if counters.get("survey.stages_run") != len(files) * len(FLEET_STAGES):
        fail(f"survey --hosts 2 ran {counters.get('survey.stages_run')} "
             f"stages by its traces")
    checked = check_tlmtrace("(19a)", tlm)
    # --resume with the same flags (its traces apart, to read its
    # launches): both hosts run 0 stages
    tlm_r = os.path.join(tmp, "hosts_resume_tlm")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", *survey_argv(
            files, out, ["--hosts", "2", "--host-lease", str(HOST_LEASE_S),
                         "--telemetry-dir", tlm_r, "--resume"])],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    said = proc.stdout
    resumed = [ln for ln in said.splitlines() if "stages run" in ln]
    traces_r = sorted(glob.glob(os.path.join(tlm_r, "fleet.host*.jsonl")))
    relaunches, recounters = trace_totals(traces_r)
    if proc.returncode != 0 or len(traces_r) != 2 or not all(
            any(f"[host{r}] " in ln and " 0 stages run" in ln
                for ln in resumed) for r in range(2)) or \
            recounters.get("survey.stages_run", 0) or \
            any(relaunches.values()):
        fail(f"the --resume of the two-host fleet ran work (exit "
             f"{proc.returncode}, {recounters.get('survey.stages_run', 0)} "
             f"stages, {relaunches}): {said[-2000:]} {proc.stderr[-2000:]}")
    serial_sum = sum(fleet["serial_walls"][k] for k in serials)
    spans = {}
    for path in paths:
        for o, st in fleet_spans(path).items():
            spans.setdefault(o, {}).update(st)
    busy, idle = device_lane_idle(spans)
    print("path survey_hosts: " + json.dumps({
        "card": card, "hosts": 2, "observations": len(files),
        "wall_s": wall, "serial_sum_s": serial_sum,
        "over_serial_sum": wall / serial_sum,
        "stage_wall_s": {o: {k: d for k, (_, d) in st.items()}
                         for o, st in spans.items()},
        "device_stage_busy_s": busy, "device_stage_gaps_s": idle,
        "owners": owners, "done_records": len(done),
        "files_equal_serial": files_equal, "resume_wall_s": resume_s,
        "resume_said": resumed,
        "tlmtrace_check": checked[0], "launches": launches}))
    return launches


def child(argv, log):
    """A child process of this checkout, its output to the file ``log``
    (a pipe nobody drains would stall a talkative child)."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *argv], cwd=HERE,
                                stdout=f, stderr=subprocess.STDOUT)


def host_child(builddir, argv, log):
    return child(["-c", HOST_RUNNER, builddir, *argv], log)


def read_log(log):
    with open(log, errors="replace") as f:
        return f.read()


def trace_time(path, name):
    """Unix time of the first event ``name`` in the trace at ``path``
    (its meta's session start plus the event's offset), or None."""
    t_unix = None
    for line in open(path):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("type") == "meta":
            t_unix = rec.get("t_unix")
        elif rec.get("type") == "event" and rec.get("name") == name \
                and t_unix is not None:
            return float(t_unix) + float(rec["t"])
    return None


def adopt_fleet(tmp, fleet, card):
    """Phase 19 (b): host0 SIGKILLed inside its fold's start, host1
    adopting its observation; both build the kernels into one fresh
    directory at once."""
    import signal

    files = fleet["files"][:2]
    serials = {k: fleet["serials"][k] for k in ("rfi", "psrb")}
    out = os.path.join(tmp, "adopt")
    tlm = os.path.join(tmp, "adopt_tlm")
    builddir = os.path.join(tmp, "adopt_kernels")
    common = [*files, "-o", out, *FLEET_FLAGS, "--device", "cuda",
              "--host-lease", str(HOST_LEASE_S), "--telemetry-dir", tlm]
    t0 = time.perf_counter()
    # started together: each builds the kernels first (one compiles, the
    # other waits on the lock), then each claims one observation
    logs = [os.path.join(tmp, f"adopt_host{r}.log") for r in range(2)]
    victim = host_child(builddir, [
        *common, "--host-id", "host0", "--fault-inject",
        "hang:survey.stage_start.fold:1"], logs[0])
    survivor = host_child(builddir, [*common, "--host-id", "host1"],
                          logs[1])
    vtrace = os.path.join(tlm, "fleet.host0.jsonl")
    parked = False
    deadline = time.monotonic() + 600
    while time.monotonic() < deadline and victim.poll() is None:
        try:
            parked = "resilience.fault_injected" in open(vtrace).read()
        except OSError:
            parked = False
        if parked:
            break
        time.sleep(0.1)
    if not parked:
        survivor.kill()
        victim.kill()
        fail(f"host0 never reached its armed hang: "
             f"{read_log(logs[0])[-2000:]}")
    os.kill(victim.pid, signal.SIGKILL)
    t_kill = time.time()
    victim.wait(timeout=60)
    survivor.wait(timeout=900)
    said = read_log(logs[1])
    wall = time.perf_counter() - t0
    if survivor.returncode != 0 or "from silent host 'host0'" not in said:
        fail(f"host1 exited {survivor.returncode} without adopting host0's "
             f"observation: {said[-3000:]}")
    want = (f"{len(files) * len(FLEET_STAGES) - 3} stages run, 3 skipped")
    if want not in said:
        fail(f"host1 did not skip the three stages host0 recorded "
             f"({want}): {said[-2000:]}")
    t_adopt = trace_time(os.path.join(tlm, "fleet.host1.jsonl"),
                         "survey.obs_adopted")
    files_equal = fleet_bytes(serials, out, "(19b)")
    launches, counters = trace_totals(
        sorted(glob.glob(os.path.join(tlm, "fleet.host*.jsonl"))))
    check_fleet_launches("the adopting fleet", launches)
    no_fallbacks("the adopting fleet", counters)
    checked = check_tlmtrace("(19b)", tlm)
    libs = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(builddir, "lib*.so")))
    if len(libs) < 3 or glob.glob(os.path.join(builddir, "*.tmp")):
        fail(f"the hosts' concurrent build left {libs} and temporaries")
    builds = [ln for log in logs for ln in read_log(log).splitlines()
              if "kernels ready in" in ln]
    compiles = host_compiles(logs, tlm)
    print("path survey_adopt: " + json.dumps({
        "card": card, "lease_s": HOST_LEASE_S, "wall_s": wall,
        "builds": builds,
        "kill_to_adoption_s": (t_adopt - t_kill) if t_adopt else None,
        "adopted_line": [ln for ln in said.splitlines()
                         if "ADOPTED" in ln],
        "host1_said": [ln for ln in said.splitlines()
                       if "stages run" in ln],
        "files_equal_serial": files_equal, "kernels_built": libs,
        "compile_counters": compiles,
        "tlmtrace_check": checked[0],
        "tolerated": checked[1].strip().splitlines()[:3],
        "launches": launches}))
    return launches


def host_compiles(logs, tlm):
    """Phase 19 (b)'s build accounting: the host whose log says it built
    the kernels must count ``compile.cache_miss`` and no
    ``compile.persistent_hit`` in its trace, the host that waited the
    reverse; returns each host's ``compile.*`` counters and its
    ``compile.first.<stage>`` spans (seconds, libraries)."""
    from pypulsar_tpu_torch.obs.summarize import load_records, summarize

    out, built, firsts = {}, [], {}
    for r, log in enumerate(logs):
        host = f"host{r}"
        summary = summarize(load_records(os.path.join(
            tlm, f"fleet.{host}.jsonl")))
        c = summary.counters
        out[host] = {k: v for k, v in c.items() if k.startswith("compile.")}
        firsts[host] = {k: v for k, v in summary.stages.items()
                        if k.startswith("compile.first.")}
        if ", 0 built here" not in read_log(log):
            built.append(host)
    if len(built) != 1:
        fail(f"not exactly one host built the kernels: {built}")
    for host, c in out.items():
        miss = c.get("compile.cache_miss", 0)
        hit = c.get("compile.persistent_hit", 0)
        if host in built:
            ok, role = miss >= 1 and hit == 0, "built"
        else:
            ok, role = hit >= 1 and miss == 0, "waited"
        if not ok:
            fail(f"{host} ({role}) counted {c}")
    return {"counters": out, "first_loads": firsts}


def http_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return json.load(r)


def http_text(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def daemon_child(out, watch, tlm, log, extra=()):
    return child(["-m", "pypulsar_tpu_torch.cli", "survey", "--daemon",
                  "-o", out, *FLEET_FLAGS, "--device", "cuda",
                  "--watch", f"{watch}:teamA", "--daemon-port", "0",
                  "--status-port", "0", "--tenant", DAEMON_TENANTS[0],
                  "--tenant", DAEMON_TENANTS[1], "--telemetry-dir", tlm,
                  *extra], log)


def daemon_ports(proc, log):
    """The submit port and the status URL a daemon child printed."""
    sub = status = None
    deadline = time.monotonic() + 300
    while (sub is None or status is None) and time.monotonic() < deadline \
            and proc.poll() is None:
        for line in read_log(log).splitlines():
            if "daemon submissions on 127.0.0.1:" in line:
                sub = int(line.rsplit(":", 1)[1])
            if "live status at " in line:
                status = line.split("live status at ", 1)[1].split(
                    "/status.json")[0]
        time.sleep(0.1)
    if sub is None or status is None:
        proc.kill()
        fail(f"the daemon did not open its ports: {read_log(log)[-2000:]}")
    return sub, status


def daemon_fleet(tmp, fleet, info, card):
    """Phase 19 (c): the streaming daemon with the live endpoint."""
    import signal
    import socket

    files = fleet["files"][:2]
    serials = {k: fleet["serials"][k] for k in ("rfi", "psrb")}
    out = os.path.join(tmp, "daemon")
    watch = os.path.join(tmp, "daemon_watch")
    tlm = os.path.join(tmp, "daemon_tlm")
    os.makedirs(watch)
    log = os.path.join(tmp, "daemon.log")
    t0 = time.perf_counter()
    proc = daemon_child(out, watch, tlm, log, [
        "--daemon-idle-exit", str(DAEMON_IDLE_EXIT_S)])
    try:
        sub, url = daemon_ports(proc, log)
        t_up = time.perf_counter() - t0
        shutil.copyfile(files[0], os.path.join(watch,
                                               os.path.basename(files[0])))
        with socket.create_connection(("127.0.0.1", sub), timeout=30) as c:
            c.sendall(f"teamB {files[1]}\n".encode())
            verdict = c.makefile().readline().strip()
        if verdict.split()[0] not in ("accepted", "pending"):
            fail(f"the daemon refused the socket submission: {verdict}")
        snap, polls = None, 0
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            snap = http_json(url + "/status.json")
            polls += 1
            rows = snap.get("rows") or []
            if len(rows) == 2 and all(r["state"] == "done" for r in rows):
                break
            if proc.poll() is not None:
                fail(f"the daemon exited {proc.returncode} early")
            time.sleep(0.5)
        done_s = time.perf_counter() - t0
        rows = snap.get("rows") or []
        if len(rows) != 2 or any(r["state"] != "done" for r in rows):
            fail(f"/status.json never showed both observations done: "
                 f"{snap}")
        metrics = http_text(url + "/metrics")
        if 'pypulsar_counter{name="survey.stages_run"} 10' not in metrics:
            fail(f"/metrics lacks the survey counters: {metrics[:2000]}")
        # the store's publish follows the last stage's manifest record:
        # poll until it lands
        psr = info["period_samples"] * info["tsamp"]
        found = []
        deadline = time.monotonic() + 120
        while not found and time.monotonic() < deadline:
            for k in range(1, 5):
                doc = http_json(f"{url}/candidates?p={psr / k!r}&dm=70"
                                f"&tol_dm=3")
                found += [r for r in doc["records"]
                          if r.get("obs") == "rfi"
                          and (r.get("snr") or 0.0) > 10
                          and harmonic_of(r["p_s"], psr) is not None]
            if not found:
                time.sleep(0.5)
        if not found:
            doc = http_json(f"{url}/candidates?top=5")
            fail(f"/candidates near the pulsar's period (or a harmonic) "
                 f"and DM 70 returns no row of the RFI file's pulsar; the "
                 f"store: {doc['store']}, its best rows {doc['records']}")
        best = max(found, key=lambda r: r["snr"])
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    wall = time.perf_counter() - t0
    said = read_log(log)
    if proc.returncode != 0 or "daemon drained — 2 submitted, 2 accepted" \
            not in said:
        fail(f"the daemon's SIGTERM drain exited {proc.returncode}: "
             f"{said[-2000:]}")
    files_equal = fleet_bytes(serials, out, "(19c)")
    launches, counters = trace_totals([os.path.join(tlm, "fleet.jsonl")])
    check_fleet_launches("the daemon", launches)
    no_fallbacks("the daemon", counters)
    # a restart on the same directory: the journal replays, nothing runs
    tlm2 = os.path.join(tmp, "daemon_tlm2")
    log2 = os.path.join(tmp, "daemon_restart.log")
    t1 = time.perf_counter()
    again = daemon_child(out, watch, tlm2, log2,
                         ["--daemon-idle-exit", "2"])
    again.wait(timeout=600)
    restart_s = time.perf_counter() - t1
    text2 = read_log(log2)
    relaunches, recounters = trace_totals([os.path.join(tlm2,
                                                        "fleet.jsonl")])
    if again.returncode != 0 or recounters.get("survey.stages_run", 0) or \
            any(relaunches.values()) or \
            "2 submitted, 2 accepted, 0 shed, 0 quarantined, 2 completed" \
            not in text2:
        fail(f"the restarted daemon ran work (exit {again.returncode}, "
             f"{recounters.get('survey.stages_run', 0)} stages, "
             f"{relaunches}): {text2[-2000:]}")
    print("path survey_daemon: " + json.dumps({
        "card": card, "tenants": list(DAEMON_TENANTS), "up_s": t_up,
        "both_done_s": done_s, "wall_s": wall,
        "serial_sum_s": sum(fleet["serial_walls"][k] for k in serials),
        "status_polls": polls, "socket_verdict": verdict,
        "metrics_lines": len(metrics.splitlines()),
        "candidate": {k: best[k] for k in ("obs", "p_s", "dm", "snr")},
        "tenants_books": (snap.get("tenants") or {}).get("tenants"),
        "files_equal_serial": files_equal, "restart_s": restart_s,
        "restart_said": [ln for ln in text2.splitlines()
                         if "drained" in ln],
        "launches": launches}))
    return launches


def accel_fallback(tmp, fn, card):
    """Phase 19 (d): phase 6's stage at ``--accel-batch 8`` with the
    second batch's dispatch failing once."""
    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands
    from pypulsar_tpu_torch.parallel import accelpipe

    clear_accel_counters("phase 19 (d)")
    out = os.path.join(tmp, "stage_fallback")
    real, calls = accelpipe._accel_dispatch, []

    def dispatch(*a):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("chip_smoke: the second batch's dispatch fails")
        return real(*a)

    accelpipe._accel_dispatch = dispatch
    try:
        with PathMeter("accel_serial_fallback", card) as pm:
            rc = cli.main(stage_argv(fn, out, STAGE_LODM, STAGE_DMS,
                                     ["--accel-batch", "8"]))
    finally:
        accelpipe._accel_dispatch = real
    fallbacks = accel_counters()["accel.serial_fallbacks"]
    if rc != 0 or fallbacks != 1:
        fail(f"the faulted stage exited {rc} with {fallbacks} fallbacks")
    ref = os.path.join(tmp, "stage")
    serial = range(8, 16)  # the second batch of 8
    # every trial, the serial ones too (each prepped as its batch was),
    # has phase 6's bytes; the serial ones also meet the contract
    same, misses = 0, []
    for i in range(STAGE_DMS):
        tag = f"_DM{STAGE_LODM + i:.2f}"
        a, b = ref + tag + ACCEL_SUFFIX, out + tag + ACCEL_SUFFIX
        if i in serial:
            misses += contract_misses(read_rzwcands(a), read_rzwcands(b))
        same_files(a[:-5], b[:-5], (".cand", ".txtcand"))
        same += 2
    if misses:
        fail(f"the serially searched trials break the matched-candidate "
             f"contract against phase 6's: {misses[:5]}")
    if min(pm.launches[k] for k in SWEEP_KERNELS) < 1:
        fail(f"the faulted stage launched no sweep kernel: {pm.launches}")
    pm.line(serial_fallbacks=fallbacks,
            serial_trials=[STAGE_LODM + i for i in serial],
            files_equal_phase6=same, contract_misses=0)
    return pm.launches


def plane_phase(tmp, fn, info, chain, card):
    """Phase 19: (a)-(d); returns each path's launches."""
    fleet = chain["fleet"]
    return {"survey_hosts": hosts_fleet(tmp, fleet, card),
            "survey_adopt": adopt_fleet(tmp, fleet, card),
            "survey_daemon": daemon_fleet(tmp, fleet, info, card),
            "accel_serial_fallback": accel_fallback(tmp, fn, card)}


MESH_KS = (1, 2, 4)  # (a)'s 'dm' sizes, every position on the one card
#: a rank of (c): the sweep CLI under a wrapper of the time-sharded sweep
#: that keeps its result; writes the rank's numbers to argv[1] (JSON)
#: and its rows to argv[1] + ".npz"; the rest of argv is the CLI's
RANK_RUNNER = r"""
import json, os, sys, time
import numpy as np
import torch
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats
from pypulsar_tpu_torch.ops.gather_sum import shifted_gather_sum
from pypulsar_tpu_torch.parallel import distributed, prefetch

out, go, coord, rank = sys.argv[1:5]
argv = sys.argv[5:]
# the card and the group are up before the signal: the timed run is the
# sweep CLI's
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
cuda_s = time.perf_counter() - t0
assert distributed.initialize(coord, 2, int(rank))
init_s = time.perf_counter() - t0 - cuda_s
while not os.path.exists(go):
    time.sleep(0.05)
real = distributed.time_sharded_sweep
box = {}


def wrapped(*a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    box["res"] = real(*a, **kw)
    torch.cuda.synchronize()
    box["sweep_s"] = time.perf_counter() - t0
    return box["res"]


distributed.time_sharded_sweep = wrapped
prefetch.ship_ahead.bytes = 0
shifted_gather_sum.launches.clear()
boxcar_stats.launches = 0
t0 = time.perf_counter()
rc = cli.main(argv + ["--process-id", rank])
torch.cuda.synchronize()
wall = time.perf_counter() - t0
distributed.shutdown()
res = box["res"]
np.savez(out + ".npz", snr=res.snr, peak=res.peak_sample)
with open(out, "w") as f:
    json.dump({"rc": rc, "wall_s": wall, "sweep_s": box["sweep_s"],
               "cuda_init_s": cuda_s, "group_init_s": init_s,
               "h2d_bytes": int(prefetch.ship_ahead.bytes),
               "launches": {
                   "gather_sum/stage1": shifted_gather_sum.launches["stage1"],
                   "gather_sum/stage2": shifted_gather_sum.launches["stage2"],
                   "boxcar_stats": boxcar_stats.launches}}, f)
sys.exit(rc)
"""
RANK_TIMEOUT_S = 300


def same_rows(what, got, ref):
    """Fail unless ``got`` has ``ref``'s rows bit for bit."""
    import numpy as np

    for f in ("snr", "peak_sample", "mean", "std"):
        if not np.array_equal(getattr(got, f), getattr(ref, f)):
            fail(f"{what}: {f} differs from the single-device rows")


def two_d_contract(what, snr, peak, ref):
    """Fail unless the peaks are ``ref``'s bit for bit and the SNR within
    2e-6 relative; returns the largest relative SNR difference."""
    import numpy as np

    if not np.array_equal(peak, ref.peak_sample):
        fail(f"{what}: peak samples differ from the single-device sweep")
    rel = float((np.abs(snr - ref.snr)
                 / np.maximum(np.abs(ref.snr), 1.0)).max())
    if rel > 2e-6:
        fail(f"{what}: SNR {rel:.3e} relative from the single-device "
             f"sweep, past 2e-6")
    return rel


def mesh_resident(fn, card):
    """Phase 20 (a): ``sweep_resident`` of phase 17's tensor over 'dm'
    meshes naming the card k times, a 2 x 2 'dm' x 'time' chunk, and the
    tree engine at k = 2; returns the launches by path."""
    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged, sweep
    from pypulsar_tpu_torch.parallel.mesh import explicit_device, make_mesh

    with FilterbankFile(fn) as r:
        src = staged.ReaderSource(r)
        (_, data), = list(src.chan_major_blocks(src.nsamples, 0, "cuda"))
        freqs, dt = src.frequencies, src.tsamp
    card0 = explicit_device("cuda")
    dms = 0.5 * np.arange(1024)
    kw = dict(nsub=64, group_size=RESIDENT_GROUP,
              chunk_payload=RESIDENT_CHUNK, device="cuda")
    groups = len(dms) // RESIDENT_GROUP
    ref = sweep.sweep_resident(data, freqs, dt, dms, **kw)
    launches, numbers = {}, {}

    def timed(name, fn_, *a, **k):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn_(*a, **k)
        torch.cuda.synchronize()
        numbers[name] = dict(wall_s=time.perf_counter() - t0,
                             peak_device_gb=torch.cuda.max_memory_allocated()
                             / 1e9)
        launches[name] = launch_counts()
        return out

    for k in MESH_KS:
        m = make_mesh([k], ("dm",), devices=[card0] * k)
        # padded past the groups: the padding's rows must not leak
        got = timed(f"mesh_resident_k{k}", sweep.sweep_resident, data,
                    freqs, dt, dms, mesh=m, pad_groups_to=groups + k, **kw)
        same_rows(f"resident sweep on a {k}-position mesh", got, ref)
        la = launches[f"mesh_resident_k{k}"]
        if min(la[n] for n in SWEEP_KERNELS) < 1:
            fail(f"the {k}-position resident sweep launched no kernel: {la}")
    # 2 x 2: each time shard half the series, its halo by a card copy
    T = int(data.shape[1])
    lp = T // 2
    plan = sweep.make_sweep_plan(dms, freqs, dt, nsub=64,
                                 group_size=RESIDENT_GROUP,
                                 pad_groups_to=groups)
    ref2 = sweep.sweep_spectra(data, freqs, dt, dms, nsub=64,
                               group_size=RESIDENT_GROUP, chunk_payload=lp,
                               device="cuda")
    m2 = make_mesh([2, 2], ("dm", "time"), devices=[card0] * 4)
    base = data.mean(dim=1, keepdim=True)
    fn2 = sweep.make_sharded_sweep_chunk_2d(m2, 64, lp, plan.min_overlap,
                                            plan.max_shift2, plan.widths)
    s, ss, mb, ab = timed("mesh_2d", fn2, data - base, plan.stage1_bins,
                          plan.stage2_bins)
    got2 = sweep.finalize_sweep(plan, T, s, ss, mb, ab,
                                float(base.double().sum().item()))
    rel2 = two_d_contract("the 2 x 2 mesh", got2.snr, got2.peak_sample,
                          ref2)
    if min(launches["mesh_2d"][n] for n in SWEEP_KERNELS) < 1:
        fail(f"the 2 x 2 mesh launched no kernel: {launches['mesh_2d']}")
    del ref2, base
    torch.cuda.empty_cache()
    # the tree engine, each position its own plan and state
    tkw = dict(kw, engine="tree")
    tref = timed("mesh_tree_k1", sweep.sweep_spectra, data, freqs, dt, dms,
                 **tkw)
    torch.cuda.empty_cache()
    tgot = timed("mesh_tree_k2", sweep.sweep_spectra, data, freqs, dt, dms,
                 mesh=make_mesh([2], ("dm",), devices=[card0] * 2), **tkw)
    same_rows("the tree engine on a 2-position mesh", tgot, tref)
    lt = launches["mesh_tree_k2"]
    if min(lt["gather_sum/tree_level"], lt["gather_sum/tree_snap"],
           lt["boxcar_stats"]) < 1:
        fail(f"the sharded tree launched no tree kernel: {lt}")
    del data
    torch.cuda.empty_cache()
    print("path mesh_resident: " + json.dumps({
        "card": card, "trials": len(dms), "samples": T,
        "chunk": RESIDENT_CHUNK, "ks": list(MESH_KS),
        "2d_snr_max_rel": rel2, "tree_merge_levels":
        tgot.engine_info.get("merge_levels"),
        "tree_state_gb": {"k1": tref.engine_info.get("state_bytes", 0) / 1e9,
                          "k2": tgot.engine_info.get("state_bytes", 0) / 1e9},
        "runs": numbers, "launches": launches}))
    return {k: v for k, v in launches.items() if k != "mesh_tree_k1"}


def mesh_stage(tmp, fn):
    """Phase 20 (b): phase 6's stage as ``sweep --mesh 2`` in-process
    under a lease naming the card twice: every artifact phase 6's
    bytes."""
    import torch

    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.parallel.mesh import device_lease, explicit_device

    out = os.path.join(tmp, "stage_mesh")
    argv = stage_argv(fn, out, STAGE_LODM, STAGE_DMS,
                      ["--write-dats", "--mesh", "2"])
    card0 = explicit_device("cuda")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_lease([card0, card0]):
        rc, text = run_quiet(cli.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0:
        fail(f"sweep --mesh 2 exited {rc}: {text[-2000:]}")
    if min(launches[n] for n in SWEEP_KERNELS) < 1:
        fail(f"sweep --mesh 2 launched no kernel: {launches}")
    ref = os.path.join(tmp, "stage")
    n = same_bytes(sorted(glob.glob(ref + "_DM*_ACCEL_200.*cand"))
                   + sorted(glob.glob(ref + "_DM*.dat")), ref, out)
    with open(ref + ".cands", "rb") as a, open(out + ".cands", "rb") as b:
        if a.read() != b.read():
            fail("sweep --mesh 2's .cands differ from phase 6's")
    print("path mesh_stage: " + json.dumps({
        "wall_s": wall, "files_equal": n + 1, "launches": launches}))
    return launches


def start_ranks(tmp, fn):
    """Phase 20 (c)'s two ranks, started early: each brings up the card
    and joins the gloo group, then waits for ``go`` to run ``sweep
    --time-shard`` of phase 4's grid on phase 4's file."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    go = os.path.join(tmp, "ranks.go")
    argv = [fn, "--lodm", "0", "--dmstep", "0.5", "--numdms", "1024",
            "--nsub", "64", "-o", os.path.join(tmp, "ts"), "--device",
            "cuda", "--time-shard", "--coordinator", coord,
            "--num-processes", "2"]
    procs, logs = [], []
    for r in range(2):
        logs.append(os.path.join(tmp, f"rank{r}.log"))
        procs.append(child(["-c", RANK_RUNNER, os.path.join(
            tmp, f"rank{r}.json"), go, coord, str(r), *argv], logs[r]))
    return dict(procs=procs, logs=logs, go=go)


def time_shard_ranks(tmp, ranks, gather_res):
    """Phase 20 (c): the two ranks on the card over gloo, each sweeping
    half the 67-s file's chunks (``sweep --time-shard``), run at the
    signal; returns each rank's launches."""
    import numpy as np

    procs, logs = ranks["procs"], ranks["logs"]
    out = os.path.join(tmp, "ts")
    t0 = time.perf_counter()
    with open(ranks["go"], "w"):
        pass
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks, launches = [], {}
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"time-shard rank {r} exited {p.returncode}: "
                 f"{read_log(logs[r])[-3000:]}")
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            numbers = json.load(f)
        with np.load(os.path.join(tmp, f"rank{r}.json.npz")) as z:
            rel = two_d_contract(f"time-shard rank {r}", z["snr"],
                                 z["peak"], gather_res)
        if min(numbers["launches"].values()) < 1:
            fail(f"time-shard rank {r} launched no kernel: {numbers}")
        launches[f"time_shard_r{r}"] = numbers["launches"]
        ranks.append(dict(numbers, snr_max_rel=rel))
    if not os.path.exists(out + ".cands"):
        fail("the time-sharded sweep wrote no .cands")
    print("path time_shard_2ranks: " + json.dumps({
        "wall_s": wall, "ranks": ranks,
        "phase4_h2d_bytes": PHASE4.get("h2d_bytes"),
        "h2d_fraction_of_phase4": [
            r["h2d_bytes"] / PHASE4["h2d_bytes"] for r in ranks]
        if PHASE4.get("h2d_bytes") else None}))
    return launches


def gang_fleet(tmp, chain, card, device="cuda"):
    """Phase 20 (d): ``survey --devices 2 --gang 2`` over phase 18's
    clean file on the card: the sweep a gang of two leases (``--mesh 2``
    on the card twice), every artifact the serial chain's bytes, and a
    ``survey.gang_decision`` of k = 2 in the trace."""
    from pypulsar_tpu_torch.obs.summarize import load_records

    fleet = chain["fleet"]
    out = os.path.join(tmp, "gang_fleet")
    tlm = os.path.join(tmp, "gang_tlm")
    text, wall, launches, _, peak = run_fleet(
        [fleet["files"][2]], out, device,
        ["--devices", "2", "--gang", "2"], tlm=tlm)
    if min(launches[n] for n in SWEEP_KERNELS) < 1 or \
            launches["fold_parts_poly"] + launches["fold_parts_multi_poly"] \
            < 1:
        fail(f"the gang fleet did not launch every kernel: {launches}")
    n = fleet_bytes({"obs": fleet["serials"]["obs"]}, out, "(gang)")
    decisions = [rec["attrs"] for rec in load_records(
        os.path.join(tlm, "fleet.jsonl"))
        if rec.get("name") == "survey.gang_decision"]
    gangs = [d for d in decisions if d.get("stage") == "sweep"]
    if not gangs or any(d["k"] != 2 or len(set(d["chips"])) != 2
                        for d in gangs):
        fail(f"the sweep did not run as a gang of 2 leases: {decisions}")
    print("path survey_gang: " + json.dumps({
        "card": card, "wall_s": wall, "peak_device_gb": peak,
        "files_equal": n, "gang_decisions": decisions,
        "serial_wall_s": fleet["serial_walls"]["obs"],
        "launches": launches}))
    return launches


def mesh_phase(tmp, fn, info, chain, card, gather_res):
    """Phase 20: several logical devices on the one card."""
    # the ranks' start (interpreters, the card, the group) overlaps (a)
    # and (b); their timed sweep runs alone
    ranks = start_ranks(tmp, fn)
    try:
        paths = mesh_resident(fn, card)
        paths["mesh_stage"] = mesh_stage(tmp, fn)
    except BaseException:
        for p in ranks["procs"]:
            p.kill()
            p.wait()
        raise
    paths.update(time_shard_ranks(tmp, ranks, gather_res))
    paths["survey_gang"] = gang_fleet(tmp, chain, card)
    return paths


# ---------------------------------------------------------------------------
# phase 21: auto-tuning
# ---------------------------------------------------------------------------

TUNE_TRIALS = 4
TUNE_STAGES = (  # (stage, cli.tune geometry flags)
    ("sweep", ["--nchan", "64", "--nsamp", str(1 << 16), "--dm-count",
               "32"]),
    ("accel", ["--nsamp", str(1 << 14), "--zmax", "20", "--numharm", "2"]))
CONSULT_ARGV = ["--lodm", "30", "--dmstep", "1", "--numdms", "32",
                "--nsub", "32", "--accel-search", "--accel-zmax", "20",
                "--accel-numharm", "2", "--write-dats", "--device", "cuda"]
CONSULT_CONFIG = {"accel": {"batch": 16, "hbm_budget_bytes": 2e9},
                  "sweep": {"chunk_fft_len": 1 << 16}}


def tune_search(tmp, card):
    """Phase 21 (a): the bounded search of both stages through the
    dispatcher; returns its launches."""
    import contextlib
    import io

    from pypulsar_tpu_torch.cli import __main__ as dispatch

    cache = os.path.join(tmp, "tune_search.json")
    out = {}
    with PathMeter("tune_search", card) as pm:
        for stage, flags in TUNE_STAGES:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = dispatch.main(["tune", "--search", "--stage", stage,
                                    *flags, "--trials", str(TUNE_TRIALS),
                                    "--device", "cuda", "--cache", cache,
                                    "--json"])
            if rc != 0:
                fail(f"tune --search --stage {stage} exited {rc}")
            res = json.loads(buf.getvalue())
            found = res["search"][stage]
            if not 1 <= (found["n_trials"] or 0) <= TUNE_TRIALS:
                fail(f"tune[{stage}]: {found['n_trials']} trials stored")
            out[stage] = dict(found, winner=res["tuned"][stage])
    if min(pm.launches["gather_sum/stage1"],
           pm.launches["gather_sum/stage2"]) < 1:
        fail(f"the sweep measure launched no gather-sum: {pm.launches}")
    pm.line(trials=TUNE_TRIALS, stages=out)
    return pm.launches


def tune_consult(tmp, fn, card):
    """Phase 21 (b): a non-default cache entry through ``sweep --tune
    cache`` against ``--tune off``; returns the launches of both runs."""
    import torch

    from pypulsar_tpu_torch import tune
    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.io.rfimask import write_mask
    from pypulsar_tpu_torch.obs import telemetry

    cache = os.path.join(tmp, "tune_consult.json")
    c = tune.TuneCache(cache)
    nsamp = 1 << 16  # phase 3's small file
    c.store(tune.make_key("accel", nsamp=nsamp, zmax=20, device="cuda"),
            CONSULT_CONFIG["accel"])
    c.store(tune.make_key("sweep", nchan=256, nsamp=nsamp, dtype="nbits8",
                          engine="gather", device="cuda"),
            CONSULT_CONFIG["sweep"])
    mask = write_mask(os.path.join(tmp, "consult.mask"), nchan=256,
                      nint=4, ptsperint=nsamp // 4, zap_chans=[3, 4],
                      zap_chans_per_int=[[], [9], [], []])
    runs = {}
    for mode, extra in (("off", ()), ("cache", ()),
                        ("masked_off", ("--mask", mask)),
                        ("masked_cache", ("--mask", mask))):
        base = os.path.join(tmp, f"consult_{mode}", "x")
        os.makedirs(os.path.dirname(base))
        with telemetry.session() as tlm, \
                PathMeter(f"tune_{mode}", card) as pm:
            rc = cli.main([fn, "-o", base, *CONSULT_ARGV, *extra, "--tune",
                           mode.split("_")[-1], "--tune-cache", cache])
            counts = tlm.counter_totals()
        if rc != 0:
            fail(f"sweep --tune {mode} exited {rc}")
        runs[mode] = dict(base=base, wall_s=pm.wall_s, launches=pm.launches,
                          batches=int(counts.get("accel.stream_batches", 0)),
                          chunks=int(counts.get("dedisperse.chunks", 0)),
                          hits=int(counts.get("tune.cache_hit", 0)))
    n_equal = 0
    for pre, chunks, hits in (("", (1, 2), 2), ("masked_", (1, 1), 1)):
        off, hit = runs[pre + "off"], runs[pre + "cache"]
        if (off["batches"], hit["batches"]) != (1, 2):
            fail(f"{pre}accel dispatches {off['batches']} / "
                 f"{hit['batches']}, not 1 / 2 (batch 32 / the stored 16)")
        if (off["chunks"], hit["chunks"]) != chunks or hit["hits"] != hits:
            fail(f"{pre}series chunks {off['chunks']} / {hit['chunks']}, "
                 f"cache hits {hit['hits']}, not {chunks} and {hits}")
        names = [p for pat in ("_DM*.dat", "_DM*.inf", "_DM*_ACCEL_20.cand",
                               "_DM*_ACCEL_20.txtcand", ".cands")
                 for p in sorted(glob.glob(off["base"] + pat))]
        if len(names) != 4 * 32 + 1:
            fail(f"{pre}--tune off wrote {len(names)} files, not "
                 f"{4 * 32 + 1}")
        for p in names:
            with open(p, "rb") as a, \
                    open(hit["base"] + p[len(off["base"]):], "rb") as b:
                if a.read() != b.read():
                    fail(f"{pre}{os.path.basename(p)} differs under the "
                         f"tuned config")
        n_equal += len(names)
    torch.cuda.synchronize()
    print("path tune_consult: " + json.dumps({
        "config": CONSULT_CONFIG, "files_equal": n_equal, "card": card,
        **{f"{m}_{k}": runs[m][k] for m in runs
           for k in ("wall_s", "batches", "chunks", "hits")}}))
    return {f"tune_{m}": runs[m]["launches"] for m in runs}


def tune_phase(tmp, small_fn, card):
    """Phase 21: returns the launches of each driven path."""
    out = {"tune_search": tune_search(tmp, card)}
    out.update(tune_consult(tmp, small_fn, card))
    return out


CHAOS_COPIES = ("chaos_a", "chaos_b")
#: SEED:RATE:KINDS of phase 22's spray: at this seed and rate the spray
#: fires on the card and the fleet is done in a few rounds
CHAOS_SPEC = "1:0.01:oom+io+device"
CHAOS_KILL = "kill:survey.stage_done.sweep:1"
CHAOS_ROUNDS = 15
CHAOS_FLAGS = ["--lodm", "30", "--devices", "1", "--max-host-workers",
               "2", "--retries", "2", *UNTUNED]
RACE_SEED, RACE_PAUSE_US = 5, 100.0
FUZZ_N, FUZZ_SEED = 60, 11


def chaos_round(files, outdir, extra):
    """One in-process ``survey`` of ``files``: (exit code, or "killed"
    when an injected kill unwound it, and its stdout)."""
    from pypulsar_tpu_torch.cli import __main__ as dispatch
    from pypulsar_tpu_torch.parallel import broker
    from pypulsar_tpu_torch.resilience import faultinject

    argv = ["survey", *files, "-o", outdir, *CHAOS_FLAGS, "--device",
            "cuda", *extra]
    broker.reset()
    try:
        return run_quiet(dispatch.main, argv)
    except faultinject.InjectedKill:
        return "killed", ""
    finally:
        broker.reset()


def chaos_phase(tmp, small_fn, card):
    """Phase 22: a chaos fleet resumed to the unfaulted bytes under race
    mode, and the reader fuzz; returns the launches of the unfaulted and
    the chaos fleets."""
    from pypulsar_tpu_torch.resilience import dataguard, faultinject, locks

    indir = os.path.join(tmp, "chaos_in")
    os.makedirs(indir)
    files = []
    for name in CHAOS_COPIES:
        files.append(os.path.join(indir, name + ".fil"))
        shutil.copyfile(small_fn, files[-1])
    clean = os.path.join(tmp, "chaos_clean")
    with PathMeter("chaos_clean", card) as pm_clean:
        rc, said = chaos_round(files, clean, [])
    if rc != 0:
        fail(f"the unfaulted fleet exited {rc}: {said[-2000:]}")
    check_fleet_launches("the unfaulted fleet", pm_clean.launches)

    # (a) and (b): the spray, the kill and race mode, resumed until done
    out = os.path.join(tmp, "chaos")
    faultinject.reset()
    locks.configure_race(RACE_SEED, pause_us=RACE_PAUSE_US)
    rounds = []
    try:
        with PathMeter("chaos_fleet", card) as pm:
            while len(rounds) < CHAOS_ROUNDS and (not rounds
                                                  or rounds[-1] != 0):
                extra = ["--fault-chaos", CHAOS_SPEC] + (
                    ["--resume"] if rounds else ["--fault-inject",
                                                 CHAOS_KILL])
                rc, said = chaos_round(files, out, extra)
                if rc not in (0, 1, "killed"):
                    fail(f"chaos round {len(rounds) + 1} exited {rc}: "
                         f"{said[-2000:]}")
                rounds.append(rc)
        fired = faultinject.fired_counts()
        pauses = locks.race_pauses()
    finally:
        faultinject.reset()
        locks.configure_race(None)
    sprayed = sum(fired.get(k, 0) for k in ("oom", "io", "device"))
    if rounds[-1] != 0:
        fail(f"the chaos fleet did not finish in {CHAOS_ROUNDS} rounds: "
             f"{rounds}, fired {fired}")
    if "killed" not in rounds or fired.get("kill", 0) != 1 or sprayed < 1:
        fail(f"the kill or the spray did not fire: rounds {rounds}, "
             f"fired {fired}")
    check_fleet_launches("the chaos fleet", pm.launches)
    serials = {name: os.path.join(clean, name) for name in CHAOS_COPIES}
    files_equal = fleet_bytes(serials, out, "(22a)")
    with PathMeter("chaos_final_resume", card) as pm_final:
        rc, said = chaos_round(files, out, ["--resume"])
    n_stages = len(files) * len(FLEET_STAGES)
    if rc != 0 or f"0 stages run, {n_stages} skipped" not in said or any(
            pm_final.launches.values()):
        fail(f"the final resume without chaos ran work: "
             f"{pm_final.launches}; {said[-800:]}")
    if pauses < 1:
        fail("race mode paused at no lock boundary")

    # (c) the reader fuzz
    fuzz = {}
    t0 = time.perf_counter()
    for fmt in dataguard.FUZZ_FORMATS:
        counts, failures = dataguard.run_reader_fuzz(
            fmt, FUZZ_N, FUZZ_SEED, os.path.join(tmp, "fuzz", fmt),
            device="cuda")
        if failures or sum(counts.values()) != FUZZ_N:
            fail(f"the {fmt} reader fuzz: {counts}, failures "
                 f"{failures[:5]}")
        fuzz[fmt] = counts
    fuzz_s = time.perf_counter() - t0
    pm.line(spec=CHAOS_SPEC, armed=CHAOS_KILL, rounds=rounds,
            fired=fired, files_equal_unfaulted=files_equal,
            unfaulted_wall_s=pm_clean.wall_s,
            final_resume_wall_s=pm_final.wall_s,
            said=said.strip().splitlines()[-1])
    print("path race_mode: " + json.dumps({
        "card": card, "seed": RACE_SEED, "pause_us": RACE_PAUSE_US,
        "race_pauses": pauses}))
    print("path reader_fuzz: " + json.dumps({
        "card": card, "n": FUZZ_N, "seed": FUZZ_SEED, "outcomes": fuzz,
        "failures": 0, "wall_s": fuzz_s}))
    return {"chaos_clean": pm_clean.launches, "chaos_fleet": pm.launches}


#: phase 23 (a): a PALFA beam's series (2^22 samples at 64 us, 268 s);
#: a session's dozens of beams cut to 6
PALFA_N, PALFA_DT, PALFA_BEAMS = 1 << 22, 64e-6, 6
PALFA_TONES = (60.0, 120.0)  # mains and its first harmonic, in every beam
PALFA_PSR_P, PALFA_PSR_BEAM = 0.0731, 2  # s; the one beam with a pulsar
ZAP_MASK_RTOL = 1e-6  # card and CPU masks may differ only this near
ZAP_ACCEL = ["-z", "20", "--dz", "2", "-n", "4"]
#: phase 23 (c): one planted violation of each rule, and a stale
#: suppression (PL010); the sources are whole lines, so none of these
#: strings is itself a fault spec or a telemetry name of this script
LINT_PLANTED = {
    "pypulsar_tpu_torch/planted.py": (
        "import os, threading, torch\n"
        "from pypulsar_tpu_torch.obs import telemetry\n"
        "def f(a, n, out, acc=[]):\n"
        "    x = a[n / 2]\n"
        "    torch.cuda.set_device(0)\n"
        "    open(out + '.cands', 'w').write('x')\n"
        "    telemetry.span('planted')\n"
        "    t = threading.Thread(target=print)\n"
        "    t.start()\n"
        "    telemetry.event('survey.planted_orphan', n=1)\n"
        "    g = torch.compile(lambda y: y)\n"
        "    return x, acc, os.getenv('HOME'), g\n"
        "def h():  # psrlint: ignore[PL001] -- stale\n"
        "    return 1\n"),
    "pypulsar_tpu_torch/locking.py": (
        "import threading\n"
        "a_lock, b_lock = threading.Lock(), threading.Lock()\n"
        "a_cv = threading.Condition()\n"
        "def one(x):\n"
        "    with a_lock:\n"
        "        with b_lock:\n"
        "            return x.item()\n"
        "def two():\n"
        "    with b_lock:\n"
        "        with a_lock:\n"
        "            pass\n"
        "    a_lock.acquire()\n"
        "    a_lock.release()\n"
        "    with a_cv:\n"
        "        a_cv.wait()\n"),
    "pypulsar_tpu_torch/tune/knobs.py": (
        "def _declare(name, stage, ktype, **kw):\n"
        "    pass\n"
        "def resolve(stage, name):\n"
        "    pass\n"
        "_declare('chunk', 'sweep', 'int')\n"
        "def f():\n"
        "    return resolve('sweep', 'chunkk')\n"),
    "pypulsar_tpu_torch/io/planted.py": (
        "import struct\n"
        "def header(f):\n"
        "    return struct.unpack('<i', f.read(4))\n"),
    "pypulsar_tpu_torch/survey/planted.py": (
        "def run(fn):\n"
        "    try:\n"
        "        return fn()\n"
        "    except Exception:\n"
        "        return None\n"),
    "tests/test_torch_planted.py": (
        "from pypulsar_tpu_torch.resilience import faultinject\n"
        "def test_ghost():\n"
        "    faultinject.configure('oom:ghost.planted:1')\n"),
}


def write_palfa_beams(d):
    """Phase 23 (a)'s six ``.fft`` files; returns their paths."""
    import numpy as np

    from pypulsar_tpu_torch.fourier.prestofft import write_fft
    from pypulsar_tpu_torch.io.infodata import InfoData

    os.makedirs(d)
    rng = np.random.default_rng(SEED + 23)
    t = np.arange(PALFA_N) * PALFA_DT
    tones = (0.05 * np.sin(2 * np.pi * PALFA_TONES[0] * t)
             + 0.02 * np.sin(2 * np.pi * PALFA_TONES[1] * t)).astype(
                 np.float32)
    fns = []
    for i in range(PALFA_BEAMS):
        x = rng.standard_normal(PALFA_N, dtype=np.float32) + tones
        if i == PALFA_PSR_BEAM:
            x += np.float32(0.1) * ((t / PALFA_PSR_P) % 1.0 < 0.05)
        inf = InfoData()
        inf.basenm, inf.object = f"beam{i}", f"PALFA_BEAM{i}"
        inf.epoch, inf.dt, inf.N = 55000.0, PALFA_DT, PALFA_N
        inf.telescope, inf.bary, inf.DM = "Arecibo", 1, 0.0
        inf.RA, inf.DEC = "19:00:00.0000", "05:00:00.0000"
        inf.lofreq, inf.BW, inf.numchan, inf.chan_width = (
            1214.0, 300.0, 1, 300.0)
        fns.append(os.path.join(d, f"beam{i}.fft"))
        write_fft(fns[-1], np.fft.rfft(x).astype(np.complex64), inf)
    return fns


def zapped(zapfn, f0):
    """Whether a row of the zaplist (centre, half-width) covers ``f0``."""
    import numpy as np

    rows = np.atleast_2d(np.loadtxt(zapfn))
    return bool(any(c - w <= f0 <= c + w for c, w in rows))


def autozap_path(tmp, card):
    """Phase 23 (a): autozap on the card against the CPU at a PALFA beam's
    width, then the card's zaplist through ``accelsearch --zapfile``."""
    import numpy as np

    from pypulsar_tpu_torch.cli import accelsearch as acli
    from pypulsar_tpu_torch.cli import autozap
    from pypulsar_tpu_torch.io.prestocand import read_rzwcands

    d = os.path.join(tmp, "palfa")
    t0 = time.perf_counter()
    fns = write_palfa_beams(d)
    write_s = time.perf_counter() - t0
    out, walls = {}, {}
    for dev in ("cuda", "cpu"):
        base = os.path.join(d, f"zap_{dev}")
        with PathMeter("autozap", card) as pm:
            rc, _ = run_quiet(autozap.main, fns + [
                "-o", base, "--device", dev, "--plotfile", base + ".npz"])
        if rc != 0:
            fail(f"autozap --device {dev} exited {rc}")
        for f0 in PALFA_TONES:
            if not zapped(base + ".zaplist", f0):
                fail(f"autozap --device {dev}: the {f0}-Hz tone is not in "
                     f"its zaplist")
        with np.load(base + ".npz") as z:
            out[dev] = {k: z[k] for k in ("mask", "margins")}
        walls[dev] = pm.wall_s
        if dev == "cuda":
            card_pm = pm
    differ = np.flatnonzero(out["cuda"]["mask"] != out["cpu"]["mask"])
    near = np.minimum(np.abs(out["cuda"]["margins"][differ]),
                      np.abs(out["cpu"]["margins"][differ]))
    far = differ[~(near <= ZAP_MASK_RTOL)]
    if far.size:
        fail(f"autozap: the card's and the CPU's masks differ at "
             f"{far.size} bins farther than {ZAP_MASK_RTOL} from their "
             f"thresholds (bins {far[:5].tolist()})")
    max_margin_diff = float(np.nanmax(np.abs(
        out["cuda"]["margins"] - out["cpu"]["margins"])))

    # the card's zaplist through the accel search of the pulsar's beam
    psr = fns[PALFA_PSR_BEAM]
    T = PALFA_N * PALFA_DT
    found = {}
    for label, extra in (("bare", []), ("zapped", [
            "--zapfile", os.path.join(d, "zap_cuda.zaplist")])):
        ob = os.path.join(d, f"accel_{label}")
        # phase 22's chaos spray may have made serial fallbacks: faulted
        # by design, so cleared here, not checked
        accel_counters().clear()
        with PathMeter("autozap_accel", card) as pm:
            rc, _ = run_quiet(acli.main, [psr, *ZAP_ACCEL, "-o", ob,
                                          "--device", "cuda", *extra])
        if rc != 0 or accel_counters()["accel.serial_fallbacks"]:
            fail(f"accelsearch {label} exited {rc}")
        cands = read_rzwcands(f"{ob}_ACCEL_{ZAP_ACCEL[1]}.cand")
        freqs = np.array([c.r / T for c in cands])
        sigs = np.array([c.sig for c in cands])
        tone = [f for f in freqs
                if min(abs(f - f0) for f0 in PALFA_TONES) < 0.05]
        k = np.round(freqs * PALFA_PSR_P)
        psr_hit = (k >= 1) & (np.abs(freqs - k / PALFA_PSR_P) < 0.01) & (
            sigs > 6.0)
        found[label] = {"cands": len(cands), "tone_cands": len(tone),
                        "pulsar_best_sigma": float(sigs[psr_hit].max())
                        if psr_hit.any() else 0.0, "wall_s": pm.wall_s}
    if not found["bare"]["tone_cands"] or found["zapped"]["tone_cands"]:
        fail(f"accelsearch --zapfile: the tones' candidates are not there "
             f"without the zaplist or not gone with it: {found}")
    if found["zapped"]["pulsar_best_sigma"] <= 6.0:
        fail(f"accelsearch --zapfile lost the pulsar: {found}")
    card_pm.line(beams=PALFA_BEAMS, nsamp=PALFA_N, dt=PALFA_DT,
                 write_s=write_s, cuda_s=walls["cuda"], cpu_s=walls["cpu"],
                 masked_bins=int(out["cuda"]["mask"].sum()),
                 mask_differences=int(differ.size),
                 max_margin_difference=max_margin_diff, accel=found)
    return {"autozap": card_pm.launches}


def tools_path(tmp, small_fn, card, coord_child):
    """Phase 23 (b): the host tools on phases 3, 6, 7 and 14's files;
    ``coord_child`` is (Popen, stdout path) of ``python -m
    pypulsar_tpu_torch.cli coordconv``."""
    import re

    import numpy as np

    from pypulsar_tpu_torch.cli import (combinefil, demodulate,
                                        mockspecfil2subbands, pfdinfo,
                                        pulse_energy_distribution,
                                        stitchdat)
    from pypulsar_tpu_torch.io.datfile import write_dat
    from pypulsar_tpu_torch.io.filterbank import (FilterbankFile,
                                                  write_filterbank)
    from pypulsar_tpu_torch.io.infodata import InfoData
    from pypulsar_tpu_torch.io.parfile import write_par
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    d = os.path.join(tmp, "s27")
    os.makedirs(d)
    numbers = {}
    with PathMeter("s27_tools", card) as pm:
        # combinefil of the two channel halves of phase 3's file
        t0 = time.perf_counter()
        with FilterbankFile(small_fn) as fb:
            hdr, data = dict(fb.header), fb.get_samples(0, fb.nspec)
        half = hdr["nchans"] // 2
        halves = []
        for i in range(2):
            h = dict(hdr, nchans=half,
                     fch1=hdr["fch1"] + i * half * hdr["foff"])
            halves.append(os.path.join(d, f"half{i}.fil"))
            write_filterbank(halves[-1], h,
                             data[:, i * half:(i + 1) * half])
        comb = os.path.join(d, "comb.fil")
        rc, _ = run_quiet(combinefil.main, halves[::-1] + ["-o", comb])
        with FilterbankFile(comb) as fb:
            same = (fb.header["nchans"] == hdr["nchans"]
                    and fb.header["fch1"] == hdr["fch1"]
                    and np.array_equal(fb.get_samples(0, fb.nspec), data))
        if rc != 0 or not same:
            fail(f"combinefil: exit {rc}, data the source's: {same}")
        numbers["combinefil_s"] = time.perf_counter() - t0

        # stitchdat of two halves of phase 6's DM-70 series, 1000 apart
        t0 = time.perf_counter()
        src = os.path.join(tmp, "stage_DM70.00")
        ts = np.fromfile(src + ".dat", dtype=np.float32)
        inf = InfoData(src + ".inf")
        cut, gap = ts.size // 2, 1000
        parts = []
        for i, (lo, hi) in enumerate(((0, cut), (cut + gap, ts.size))):
            part = InfoData(src + ".inf")
            part.epoch = inf.epoch + lo * inf.dt / 86400.0
            part.N = hi - lo
            parts.append(os.path.join(d, f"part{i}"))
            write_dat(parts[-1], ts[lo:hi], part)
        stitched = os.path.join(d, "stitched")
        rc, _ = run_quiet(stitchdat.main, [p + ".dat" for p in parts]
                          + ["-o", stitched])
        got = np.fromfile(stitched + ".dat", dtype=np.float32)
        want = ts.copy()
        want[cut:cut + gap] = np.median(ts[:cut])
        if rc != 0 or not np.array_equal(got, want):
            fail(f"stitchdat: exit {rc}, {got.size} samples against "
                 f"{want.size}, equal: {np.array_equal(got, want)}")
        numbers["stitchdat_s"] = time.perf_counter() - t0

        # mockspecfil2subbands: each .sub file one channel, low first
        t0 = time.perf_counter()
        subs = os.path.join(d, "subs")
        rc, _ = run_quiet(mockspecfil2subbands.main, [small_fn, "-o", subs])
        C = hdr["nchans"]
        bad = [j for j in range(C) if not np.array_equal(
            np.fromfile(f"{subs}.sub{j:04d}", dtype=np.uint8),
            data[:, C - 1 - j if hdr["foff"] < 0 else j])]
        if rc != 0 or bad:
            fail(f"mockspecfil2subbands: exit {rc}, channels wrong: "
                 f"{bad[:5]}")
        numbers["mockspecfil2subbands_s"] = time.perf_counter() - t0

        # demodulate a binary's series: samples dropped and added
        t0 = time.perf_counter()
        n, dt = 1 << 20, 2e-3
        binf = InfoData()
        binf.epoch, binf.dt, binf.N, binf.bary, binf.DM = (
            55000.0, dt, n, 1, 0.0)
        binf.telescope, binf.object = "Arecibo", "BINARY"
        binf.RA, binf.DEC = "19:00:00.0000", "05:00:00.0000"
        binf.lofreq, binf.BW, binf.numchan, binf.chan_width = (
            1214.0, 300.0, 1, 300.0)
        binbase = os.path.join(d, "binary")
        write_dat(binbase, np.random.default_rng(SEED).standard_normal(
            n).astype(np.float32), binf)
        par = os.path.join(d, "binary.par")
        write_par(par, dict(PSR="J1900+0500", F0=100.0, F1=0.0,
                            PEPOCH=55000.0, DM=0.0, RAJ="19:00:00",
                            DECJ="05:00:00", BINARY="BT", A1=2.0, PB=0.02,
                            T0=55000.0, OM=0.0, E=0.0))
        cwd = os.getcwd()
        os.chdir(d)  # the scratch ephemeris is written in the cwd
        try:
            rc, said = run_quiet(demodulate.main, [binbase + ".dat", "-f",
                                                   par])
        finally:
            os.chdir(cwd)
        nrem = int(said.split("removed:")[1].split()[0])
        nadd = int(said.split("added:")[1].split()[0])
        nout = os.path.getsize(binbase + "_demod.dat") // 4
        if rc != 0 or not (nrem and nadd) or nout % 2 or \
                nout != n + nadd - nrem - (n + nadd - nrem) % 2 or \
                InfoData(binbase + "_demod.inf").N != nout:
            fail(f"demodulate: exit {rc}, removed {nrem}, added {nadd}, "
                 f"{nout} samples")
        numbers.update(demodulate_s=time.perf_counter() - t0,
                       demodulate_removed=nrem, demodulate_added=nadd)

        # pfdinfo of a phase-7 archive
        pfd_fn = sorted(glob.glob(os.path.join(tmp, "fold_dats_*.pfd")))[0]
        rc, said = run_quiet(pfdinfo.main, [pfd_fn, "-a",
                                            "candnm,proflen,npart,nsub"])
        pfd = PfdFile(pfd_fn)
        want = "\t".join(str(getattr(pfd, a)) for a in (
            "candnm", "proflen", "npart", "nsub"))
        if rc != 0 or said.strip() != want:
            fail(f"pfdinfo: exit {rc}, {said!r} against {want!r}")

        # pulse_energy_distribution over phase 14's pulse files
        profs = glob.glob(os.path.join(tmp, "pulses", "psr.prof*"))
        npz = os.path.join(d, "energies.npz")
        rc, _ = run_quiet(pulse_energy_distribution.main,
                          profs + ["-q", "-o", npz])
        with np.load(npz) as z:
            energies, counts = z["energies"], z["counts"]
        if rc != 0 or not np.isfinite(energies).all() or \
                not 0 < energies.size <= len(profs) or \
                counts.sum() != energies.size:
            fail(f"pulse_energy_distribution: exit {rc}, "
                 f"{energies.size} energies of {len(profs)} files")
        numbers["pulse_files"] = len(profs)

        # coordconv through the dispatcher, in the child started with
        # the phase
        proc, log = coord_child
        rc = proc.wait(timeout=120)
        with open(log) as f:
            said = f.read()
        lb = [float(v) for v in re.findall(r"-?\d+\.\d*", said)]
        if rc != 0 or len(lb) != 2 or not lb[1] > 89.0:
            fail(f"coordconv: exit {rc}, {said[-500:]!r}")
        numbers["galactic"] = lb
    pm.line(**numbers)
    return {"s27_tools": pm.launches}


def start_children(tmp):
    """Phase 23's children, started together: (c)'s two linters (the
    checkout and the planted tree) and (b)'s ``coordconv``. Returns
    [(name, Popen, stdout path)] and the time they started."""
    plant = os.path.join(tmp, "lint_planted")
    for rel, src in LINT_PLANTED.items():
        path = os.path.join(plant, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src)
    kids = []
    for name, argv in (
            ("checkout", ["psrlint", "--json"]),
            ("planted", ["psrlint", "--json", "--root", plant]),
            ("coordconv", ["coordconv", "192.25", "27.4"])):
        log = os.path.join(tmp, f"child_{name}.out")
        with open(log, "w") as f:
            kids.append((name, subprocess.Popen(
                [sys.executable, "-m", "pypulsar_tpu_torch.cli", *argv],
                cwd=HERE, stdout=f, stderr=subprocess.STDOUT), log))
    return kids, time.perf_counter()


def check_psrlint(kids, t0, card):
    """Phase 23 (c): the checkout is clean, the planted tree names every
    rule."""
    from pypulsar_tpu_torch.analysis import all_rules

    reports = {}
    for name, proc, log in kids[:2]:
        rc = proc.wait(timeout=600)
        with open(log) as f:
            text = f.read()
        try:
            reports[name] = (rc, json.loads(text))
        except ValueError:
            fail(f"psrlint on the {name} tree exited {rc}: {text[-1500:]}")
    wall = time.perf_counter() - t0
    rc, doc = reports["checkout"]
    if rc != 0 or doc["findings"]:
        fail(f"psrlint on the checkout exited {rc}: {doc['findings'][:5]}")
    rc, planted = reports["planted"]
    want = {r.code for r in all_rules()} | {"PL010"}
    if rc != 1 or set(planted["counts"]) != want:
        fail(f"psrlint on the planted tree exited {rc}, named "
             f"{sorted(planted['counts'])}, not {sorted(want)}")
    print("path psrlint: " + json.dumps({
        "wall_s": wall, "files": doc["files"], "rules": len(doc["rules"]),
        "findings": 0, "planted_counts": planted["counts"],
        "card": card}))


def tools_phase(tmp, small_fn, card):
    """Phase 23: returns the launches of (a) and (b)."""
    kids, t0 = start_children(tmp)
    try:
        launches = autozap_path(tmp, card)
        launches.update(tools_path(tmp, small_fn, card, kids[2][1:]))
        check_psrlint(kids, t0, card)
    finally:
        for _, proc, _ in kids:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return launches

# ---------------------------------------------------------------------------
# phase 24: the last host slice

#: phase 24 (a): the traced sweep's trials on phase 3's file (DM 40 among
#: them)
TRACE_DMS = tuple(30.0 + 2.0 * i for i in range(16))
#: the kernels phase 24 (a)'s trace must name (``kernel_name`` of each
#: record of the trace's ``kernel`` category)
TRACED_KERNELS = ("gather_sum_kernel", "boxcar_segment_kernel")
#: phase 24 (c): the orbit fitkepler recovers (asini lt-s, Pb d, P s, T0
#: MJD, ecc, omega rad) and its start
KEPLER_TRUE = (2.0, 0.5, 0.005, 55000.1, 0.0, 0.0)
KEPLER_INIT = ("1.5", "0.45", "0.005", "55000.05", "0.001", "0.0")


def small_sweep_result(small_fn, device="cuda"):
    """Phase 24 (a)'s sweep of phase 3's file: the flat sweep at
    :data:`TRACE_DMS`, phase 3's geometry."""
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel.staged import sweep_flat

    with FilterbankFile(small_fn) as r:
        return sweep_flat(r, TRACE_DMS, nsub=32, group_size=8,
                          chunk_payload=20000, device=device).steps[0].result


#: the sweep result's fields phase 24 (a) holds bit for bit
TRACE_FIELDS = ("dms", "snr", "peak_sample", "mean", "std")
#: phase 24 (a)'s child: the traced sweep in a fresh process (argv:
#: checkout, file, trace directory, result path). Started beside phase
#: 23: in this process, after earlier profiler sessions and minutes of
#: other work, a trace on the H100 kept 2 kernel records of the sweep's
#: 30; a fresh process's keeps them all.
TRACE_RUNNER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from pypulsar_tpu_torch.utils import profiling
small_fn, logdir, out = sys.argv[2:5]
torch.cuda.init()
cs.reset_launch_counts()
t0 = time.perf_counter()
with profiling.trace(logdir):
    res = cs.small_sweep_result(small_fn)
traced_s = time.perf_counter() - t0
np.savez(out + ".npz", **{f: getattr(res, f) for f in cs.TRACE_FIELDS})
with open(out, "w") as f:
    json.dump({"traced_s": traced_s, "launches": cs.launch_counts()}, f)
"""


def start_traced_sweep(tmp, small_fn):
    """Phase 24 (a)'s child, started before phase 23: (Popen, log, trace
    directory, result path)."""
    logdir = os.path.join(tmp, "trace")
    out = os.path.join(tmp, "trace.json")
    log = os.path.join(tmp, "trace.log")
    return (child(["-c", TRACE_RUNNER, HERE, small_fn, logdir, out], log),
            log, logdir, out)


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def traced_sweep(small_fn, card, traced):
    """Phase 24 (a): the child's traced sweep against an untraced one
    here; returns its launches and the two walls."""
    import numpy as np
    import torch

    proc, log, logdir, out = traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = small_sweep_result(small_fn)
    plain_s = time.perf_counter() - t0
    rc = proc.wait(timeout=300)
    if rc != 0:
        fail(f"traced sweep: the child exited {rc}: {read_log(log)[-1500:]}")
    with open(out) as f:
        rec = json.load(f)
    with np.load(out + ".npz") as z:
        for field in TRACE_FIELDS:
            a, b = getattr(plain, field), z[field]
            if a.dtype != b.dtype or a.shape != b.shape or \
                    a.tobytes() != b.tobytes():
                fail(f"traced sweep: {field} is not the untraced run's "
                     f"bytes")
        if not (np.isfinite(z["snr"]).all() and z["snr"].shape[0] == 16):
            fail("traced sweep: non-finite or misshapen SNR")
        best_dm = float(z["dms"][int(z["snr"].max(axis=1).argmax())])
    names = sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
    if len(names) != 1:
        fail(f"traced sweep: {len(names)} trace files under {logdir}")
    with open(names[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(
        kernel_name(e.get("name", "")) for e in events
        if e.get("cat") == "kernel")
    missing = [k for k in TRACED_KERNELS if not kernels[k]]
    if missing:
        fail(f"traced sweep: the trace names no {missing}; it names "
             f"{kernels.most_common(8)}")
    launches = rec["launches"]
    launched = {k: v for k, v in launches.items() if v}
    if set(launched) != {"gather_sum/stage1", "gather_sum/stage2",
                         "boxcar_stats"}:
        fail(f"traced sweep: the wrappers counted {launched}")
    print("path s27b_traced_sweep: " + json.dumps({
        "trials": 16, "untraced_s": plain_s, "traced_s": rec["traced_s"],
        "trace_bytes": os.path.getsize(names[0]),
        "trace_kernel_records": {k: kernels[k] for k in TRACED_KERNELS},
        "trace_kernels_all": sum(kernels.values()), "best_dm": best_dm,
        "card": card, "launches": launches}))
    return {"s27b_traced_sweep": launches}, plain_s, rec["traced_s"]


def zero_dm_block(small_fn):
    """Phase 24 (b): ``zero_dm_filter.filter`` of a uint8 block on the
    card against the CPU; returns (shape, differing bytes)."""
    from pypulsar_tpu_torch.cli import zero_dm_filter
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    with FilterbankFile(small_fn) as r:
        n, C = r.nspec, r.nchans
        block = r._read_raw_block(0, n).reshape(n, C)
    got = zero_dm_filter.filter(block)
    want = zero_dm_filter.filter(block, device="cpu")
    if got.dtype != block.dtype or got.shape != block.shape:
        fail(f"zero_dm_filter.filter: {got.dtype} {got.shape} from a "
             f"{block.dtype} {block.shape} block")
    bad = zero_dm_filter.unproven_differences(block, got, want)
    if bad.size:
        fail(f"zero_dm_filter.filter: {len(bad)} bytes differ from the "
             f"CPU's without a float64 tie, first at {bad[0].tolist()}")
    return list(block.shape), int((got != want).sum())


def host_clis(d):
    """Phase 24 (c): the seven CLIs through the dispatcher; returns their
    numbers and walls."""
    import importlib.util
    import re
    import warnings

    import numpy as np

    from pypulsar_tpu_torch.cli import __main__ as dispatch
    from pypulsar_tpu_torch.cli.fitkepler import kepler_period
    from pypulsar_tpu_torch.cli.gridding import angsep_arcmin
    from pypulsar_tpu_torch.astro.estimate_snr import airy_pattern
    from pypulsar_tpu_torch.io.prestopfd import make_pfd
    from pypulsar_tpu_torch.io.residuals import write_residuals

    def tool(argv, npz=None):
        argv = argv + (["-o", os.path.join(d, npz)] if npz else [])
        rc, said = run_quiet(dispatch.main, argv)
        if rc != 0:
            fail(f"{argv[0]} exited {rc}: {said[-500:]}")
        if npz:
            return said, np.load(os.path.join(d, npz))
        return said

    numbers, walls = {}, {}
    t0 = time.perf_counter()
    said = tool(["massfunc", "-f", "0.15", "-m", "1.4", "-i", "60"])
    mc = float(re.findall(r"([\d.]+) Msun", said)[0])
    fm = (mc * np.sin(np.deg2rad(60.0))) ** 3 / (1.4 + mc) ** 2
    if abs(fm - 0.15) > 1e-5:
        fail(f"massfunc: {mc} Msun gives a mass function of {fm}")
    numbers["massfunc_msun"] = mc
    _, z = tool(["pbdot"], "pbdot.npz")
    if z["pbdots"].shape != (1000, 1000) or not (z["pbdots"] < 0).all():
        fail("pbdot: the Pb-dot plane is misshapen or not all decay")
    numbers["pbdot_nan_share"] = float(np.isnan(
        z["tspans_needed_days"]).mean())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tool's low-eccentricity note
        _, z = tool(["shapiro"], "shapiro.npz")
    incl = z["inclination"]
    if incl.shape != (1000, 1000) or incl.min() < 0 or incl.max() > 91:
        fail("shapiro: inclinations outside 0-91 deg")
    numbers["shapiro_max_us"] = float(np.nanmax(z["delays"]) * 1e6)
    walls["mass_tools_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED % 2 ** 31)
    mjds = 55000.0 + np.linspace(0, 1.0, 40)
    ps = kepler_period(mjds, *KEPLER_TRUE) + rng.randn(40) * 2e-9
    ptxt = os.path.join(d, "periods.txt")
    np.savetxt(ptxt, np.column_stack([mjds, ps * 1000,
                                      np.full(40, 2e-6)]))
    _, z = tool(["fitkepler", ptxt, "--init", *KEPLER_INIT],
                "fitkepler.npz")
    fit = z["params"]
    if abs(fit[0] / KEPLER_TRUE[0] - 1) > 0.01 or \
            abs(fit[1] / KEPLER_TRUE[1] - 1) > 0.001:
        fail(f"fitkepler: fitted {fit.tolist()} for {KEPLER_TRUE}")
    numbers["fitkepler"] = fit.tolist()
    walls["fitkepler_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    true_ra = (12 + 2.0 / 3600) * 15 * 60  # arcmin
    true_dec = (30 + 30.0 / 3600) * 60
    pfds = []
    for ii, (dra, ddec) in enumerate([(0, 0), (1.0, 0), (-1.0, 0),
                                      (0, 1.0), (0, -1.0)]):
        ra_am, dec_am = 12 * 15 * 60 + dra, 30 * 60 + ddec
        snr = 40.0 * float(airy_pattern(3.35, angsep_arcmin(
            true_ra, true_dec, ra_am, dec_am))[0])
        phases = np.arange(64) / 64
        shape = snr * 1.17 * np.exp(-0.5 * ((phases - 0.3) / 0.03) ** 2)
        pfd = make_pfd(rng.randn(8, 4, 64) + shape / 4, dt=1e-3,
                       lofreq=1400.0, chan_wid=25.0, fold_p1=0.064,
                       bestdm=0.0, candnm="GRID")
        h, rem = divmod(ra_am / 900.0, 1)
        m, rem = divmod(rem * 60, 1)
        dh, drem = divmod(dec_am / 60, 1)
        dm_, drem = divmod(drem * 60, 1)
        pfd.rastr = "%02d:%02d:%07.4f" % (h, m, rem * 60)
        pfd.decstr = "%02d:%02d:%07.4f" % (dh, dm_, drem * 60)
        pfds.append(os.path.join(d, f"point{ii}.pfd"))
        pfd.write(pfds[-1])
    _, z = tool(["gridding", *pfds], "gridding.npz")
    _, fra, fdec = z["fit"]
    if abs(fra - true_ra) > 2.0 or abs(fdec - true_dec) > 2.0:
        fail(f"gridding: fitted ({fra}, {fdec}) arcmin for ({true_ra}, "
             f"{true_dec})")
    numbers["gridding_offset_arcmin"] = [float(fra - true_ra),
                                         float(fdec - true_dec)]
    walls["gridding_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, z = tool(["pyppdot", "--def-lines", "--binaries", "--magnetars"],
                "pyppdot.npz")
    names = list(z["names"])
    if len(names) < 1000 or "B0531+21" not in names or \
            not (np.isfinite(z["p"]).all() and (z["pdot"] > 0).all()):
        fail(f"pyppdot: {len(names)} pulsars from the bundled catalog")
    numbers["pyppdot_pulsars"] = len(names)
    n = 30
    res = os.path.join(d, "resid2.tmp")
    post = rng.randn(n) * 1e-4
    write_residuals(res, bary_TOA=55000 + np.arange(n, dtype=float),
                    postfit_phs=post * 10.0, postfit_sec=post,
                    prefit_sec=post + 1e-4)
    _, z = tool(["pyplotres", "--resid-file", res, "--both"],
                "pyplotres.npz")
    if not (np.array_equal(z["postfit"], post * 1e6)
            and np.array_equal(z["prefit"], (post + 1e-4) * 1e6)):
        fail("pyplotres: the plotted residuals are not the file's")
    walls["catalog_residuals_s"] = time.perf_counter() - t0
    numbers["matplotlib_installed"] = \
        importlib.util.find_spec("matplotlib") is not None
    return numbers, walls


def datafile_and_wapp(d):
    """Phase 24 (d) and (e): the data-file object of a Mock PSRFITS beam,
    and a WAPP file read back when ``pycparser`` is there."""
    import importlib.util
    import struct

    import numpy as np

    from pypulsar_tpu_torch.io import datafile
    from pypulsar_tpu_torch.io.psrfits import write_psrfits

    fn = os.path.join(d, "4bit-p2030.20101105.FAKE.b3s1g0.00100.fits")
    write_psrfits(fn, np.random.default_rng(SEED).integers(
        0, 255, (8, 128)).astype(np.float32), 1400.0 + np.arange(8),
        tsamp=6.4e-5, nsamp_per_subint=64, nbits=8, start_mjd=55500.25,
        src_name="FAKE", extra_primary={"IBEAM": 3})
    obj = datafile.autogen_dataobj([fn])
    if type(obj).__name__ != "MockPsrfitsData" or obj.beam_id != 3 or \
            abs(obj.sample_time - 64.0) > 1e-9 or obj.num_samples != 128:
        fail(f"autogen_dataobj: {type(obj).__name__}, beam {obj.beam_id}, "
             f"{obj.sample_time} us, {obj.num_samples} samples")
    out = {"datafile": type(obj).__name__}
    out["pycparser"] = importlib.util.find_spec("pycparser") is not None
    if out["pycparser"]:
        from pypulsar_tpu_torch.io.wapp import WappFile

        wfn = os.path.join(d, "p2030.FAKE.wapp1.55000.0003")
        src = ("struct WAPP_HEADER { char src_name[12]; double samp_time;"
               " int num_lags; int lagformat; };")
        lags = np.arange(16 * 8, dtype=np.int32)
        with open(wfn, "wb") as f:
            f.write(src.encode() + b"\0" + struct.pack(
                "=12sdii", b"J0000+0000", 64.0, 8, 1))
            lags.tofile(f)
        with WappFile(wfn) as w:
            if w.number_of_samples != 16 or not np.array_equal(
                    w.read_lags(3, 4), lags.reshape(16, 8)[3:7]):
                fail("WappFile: the 32-bit lags read back wrong")
        out["wapp_samples"] = 16
    return out


def s27b_phase(tmp, small_fn, card, traced):
    """Phase 24; ``traced`` is :func:`start_traced_sweep`'s child.
    Returns the traced sweep's launches."""
    d = os.path.join(tmp, "s27b")
    os.makedirs(d)
    walls = {}
    t0 = time.perf_counter()
    shape, differing = zero_dm_block(small_fn)
    walls["zero_dm_filter_s"] = time.perf_counter() - t0
    numbers, cli_walls = host_clis(d)
    walls.update(cli_walls)
    t0 = time.perf_counter()
    numbers.update(datafile_and_wapp(d))
    walls["datafile_wapp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, plain_s, traced_s = traced_sweep(small_fn, card, traced)
    walls["traced_sweep_s"] = time.perf_counter() - t0
    print("path s27b: " + json.dumps({
        "walls_s": walls, "untraced_sweep_s": plain_s,
        "traced_sweep_s": traced_s, "zero_dm_block": shape,
        "zero_dm_differing_bytes": differing, **numbers, "card": card}))
    return launches



# ---------------------------------------------------------------------------
# phase 25: the host codec and its pread ring
# ---------------------------------------------------------------------------

#: phase 25 (a)'s subint: spectra x channels
SUBINT = (4096, 1024)
#: phase 25 (a)'s boxcar series and widths (0 and past the end give 0)
BOXCAR_N = 1 << 20
BOXCAR_WIDTHS = (0, 1, 2, 4, 8, 16, 32, BOXCAR_N, BOXCAR_N + 1)
#: phase 25 (c)'s truncated copy: samples copied, then kept; and (c)'s
#: blocks (payload, overlap), many to a file so the ring is mid-stream
TRUNC_COPY, TRUNC_KEEP, TEARDOWN_BLOCK = 1 << 17, 100000, (1 << 15, 1024)


def codec_cases(rng):
    """Phase 25 (a): (name, function, inputs, bytes in + out, (rtol,
    atol) or None for bit for bit) of the seven loops at a subint's
    size."""
    import numpy as np

    nspec, nchan = SUBINT
    n = nspec * nchan
    packed = rng.integers(0, 256, n // 2, dtype=np.uint8)
    data = (rng.random((nspec, nchan)) * 100).astype(np.float32)
    per_chan = [(rng.random(nchan) + 0.5).astype(np.float32),
                rng.standard_normal(nchan).astype(np.float32),
                (rng.random(nchan) > 0.1).astype(np.float32)]
    series = rng.standard_normal(BOXCAR_N).astype(np.float32)
    series[100000:100008] += 10.0
    u8 = rng.integers(0, 256, n, dtype=np.uint8)
    u16 = rng.integers(0, 65536, n).astype(np.uint16)
    f32 = rng.standard_normal(n).astype(np.float32)
    cases = [(f"unpack_bits/{b}", "unpack_bits", (packed[:n * b // 8], b),
              n * b // 8 + 4 * n, None) for b in (4, 2, 1)]
    cases += [(f"widen/{a.dtype}", "widen", (a,), a.nbytes + 4 * n, None)
              for a in (u8, u16, f32)]
    cases.append(("scale_offset_weight", "scale_offset_weight",
                  (data, *per_chan), 8 * n + 12 * nchan, None))
    cases.append(("zero_dm", "zero_dm", (data,), 8 * n, (0.0, 2e-4)))
    cases += [(f"transpose_to_chan_major/{a.dtype}",
               "transpose_to_chan_major", (a, nspec, nchan),
               a.nbytes + 4 * n, None) for a in (u8, u16, f32)]
    cases.append(("boxcar_peak_snr", "boxcar_peak_snr",
                  (series, BOXCAR_WIDTHS), 4 * BOXCAR_N, (1e-5, 0.0)))
    return cases


def check_codec():
    """Phase 25 (a): each loop against its NumPy twin; returns each
    case's wall ms and GB/s."""
    import numpy as np

    from pypulsar_tpu_torch import native

    out = {}
    for what, name, args, nbytes, tol in codec_cases(
            np.random.default_rng(SEED)):
        copies = lambda: [a.copy() if isinstance(a, np.ndarray) else a
                          for a in args]
        fn, twin = getattr(native, name), getattr(native, "_numpy_" + name)
        fn(*copies())  # the first call loads the library
        walls = []
        for _ in range(3):
            inputs = copies()
            t0 = time.perf_counter()
            got = fn(*inputs)
            walls.append(time.perf_counter() - t0)
        want = twin(*copies())
        if got.dtype != np.float32 or got.shape != want.shape:
            fail(f"codec {what}: {got.dtype} {got.shape} against the "
                 f"twin's {want.dtype} {want.shape}")
        if tol is None:
            if not np.array_equal(got, want):
                fail(f"codec {what}: not the twin's bits "
                     f"({int((got != want).sum())} values differ)")
            err = 0.0
        else:
            err = float(np.abs(got - want).max())
            if not np.allclose(got, want, rtol=tol[0], atol=tol[1]):
                fail(f"codec {what}: {err:.3g} from the twin (rtol "
                     f"{tol[0]}, atol {tol[1]})")
        wall = min(walls)
        out[what] = {"ms": wall * 1e3, "gb_per_s": nbytes / wall / 1e9,
                     "max_abs_err": err}
    return out


def _device_digest(block, weights):
    """Two int64 sums over a uint8 block's 32-bit words, plain and
    weighted (mod 2^64: exact whatever the reduction's order), on the
    device."""
    import torch

    words = block.reshape(-1).view(torch.int32).to(torch.int64)
    return torch.stack([words.sum(), (words * weights[:words.numel()]).sum()])


def _rss_kb():
    """The process's resident set now, kB (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return -1


def copied_blocks(fb, payload, overlap):
    """(pos, [time, chan] uint8 block) of an 8-bit file from the ring with
    each block copied out before its slot goes back (the JAX package's
    contract, ``PrefetchReader``'s default; no program path reads so)."""
    from pypulsar_tpu_torch.native import PrefetchReader

    for pos, buf in PrefetchReader(fb.filename, fb.header_size,
                                   fb.bytes_per_spectrum,
                                   fb.number_of_samples, payload, overlap):
        yield pos, buf.reshape(-1, fb.nchans)


#: phase 25 (b)'s reads of raw blocks: the ring lending its slots to the
#: ship thread (``ReaderSource``'s), the ring copying each block out, and
#: one synchronous read a block (``prefetch=False``, and ``iter_blocks``'
#: way for blocks the caller keeps)
INGEST_MODES = {
    "ring_lent": lambda fb, p, o: fb.iter_blocks(p, o, raw=True,
                                                 borrow=True),
    "ring_copied": copied_blocks,
    "sync": lambda fb, p, o: fb.iter_blocks(p, o, raw=True, borrow=True,
                                            prefetch=False)}
#: phase 25 (b)'s widened reads (float32 blocks widened from the ring's
#: lent slots, and ``iter_blocks``' synchronous ones), host only, over
#: this many blocks of phase 4's file
WIDENED_BLOCKS = 2


def ingest_pass(fn, payload, overlap, mode, weights):
    """Phase 25 (b): one ship of phase 4's file to the card, read as
    :data:`INGEST_MODES` ``mode`` says; (wall s, bytes, digests, the
    largest RSS seen while blocks arrived, kB)."""
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import prefetch as pf

    digests, rss, nbytes = [], 0, 0
    with FilterbankFile(fn) as fb:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shipped = pf.ship_ahead(INGEST_MODES[mode](fb, payload, overlap),
                                torch.device("cuda"))
        for pos, dev in shipped:
            nbytes += dev.numel()
            digests.append((pos, _device_digest(dev, weights)))
            rss = max(rss, _rss_kb())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, nbytes, [(p, tuple(d.tolist())) for p, d in digests], rss


def widened_pass(fn, payload, overlap, ring):
    """Phase 25 (b): the wall s of :data:`WIDENED_BLOCKS` float32 blocks
    of phase 4's file, widened from the ring's lent slots or read by
    ``iter_blocks`` synchronously, and a digest of them (float64 sums
    of every 97th row)."""
    import numpy as np

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    digest = []
    with FilterbankFile(fn) as fb:
        blocks = fb.iter_blocks(payload, overlap, raw=ring, borrow=ring,
                                prefetch=ring)
        t0 = time.perf_counter()
        for _ in range(WIDENED_BLOCKS):
            pos, block = next(blocks)
            if ring:  # phase 4's file is 8-bit
                block = block.astype(np.float32)
            digest.append((pos, block.shape, float(block[::97].sum(
                dtype=np.float64))))
        wall = time.perf_counter() - t0
        blocks.close()
    return wall, digest


def _threads():
    return set(os.listdir("/proc/self/task"))


def _threads_after(before, wait_s=5.0):
    """The threads alive once none is left that ``before`` lacks (or
    after ``wait_s``: a joined thread leaves the task list a moment after
    its join returns)."""
    give_up = time.monotonic() + wait_s
    while _threads() - before and time.monotonic() < give_up:
        time.sleep(0.01)
    return _threads()


def ring_teardown(tmp, fn):
    """Phase 25 (c): the thread counts before, during and after a
    consumer that stops after one block, and before and after a
    truncated copy raises; no thread may be left that was not there
    before."""
    import warnings

    import torch

    from pypulsar_tpu_torch.io.errors import DataFormatError
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import staged

    out, left = {}, {}
    with FilterbankFile(fn) as fb:
        before = _threads()
        blocks = staged.ReaderSource(fb).chan_major_blocks(
            *TEARDOWN_BLOCK, torch.device("cuda"))
        next(blocks)
        during = _threads()
        blocks.close()
        after = _threads_after(before)
        out["early_stop"] = [len(before), len(during), len(after)]
        left["early stop"] = after - before
        if not during - before:
            fail("ring teardown: no ring or ship thread while a block was "
                 "held")
        header = fb.header_size
        nbytes = header + TRUNC_COPY * fb.bytes_per_spectrum
        keep = header + TRUNC_KEEP * fb.bytes_per_spectrum
    copy = os.path.join(tmp, "native_truncated.fil")
    with open(fn, "rb") as src, open(copy, "wb") as dst:
        dst.write(src.read(nbytes))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the copy's header says 2^20
        fb = FilterbankFile(copy)
    with fb:
        os.truncate(copy, keep)
        before = _threads()
        try:
            for _ in staged.ReaderSource(fb).chan_major_blocks(
                    *TEARDOWN_BLOCK, torch.device("cuda")):
                pass
        except DataFormatError as e:
            out["truncated_error"] = str(e).split(": ", 1)[1]
        else:
            fail("a copy truncated under its reader raised nothing")
        after = _threads_after(before)
        out["truncated"] = [len(before), len(after)]
        left["truncated copy"] = after - before
    os.unlink(copy)
    for what, tids in left.items():
        if tids:
            fail(f"ring teardown: after the {what}, threads {sorted(tids)} "
                 f"are left ({out})")
    return out


def native_phase(tmp, fn, card, gather_wall):
    """Phase 25: the codec against its twins, phase 4's ingest with the
    ring on and off, and the ring's teardown."""
    import resource

    import numpy as np
    import torch

    from pypulsar_tpu_torch.io.filterbank import FilterbankFile
    from pypulsar_tpu_torch.parallel import prefetch as pf
    from pypulsar_tpu_torch.parallel import staged
    from pypulsar_tpu_torch.parallel.sweep import DEFAULT_WIDTHS

    walls = {}
    t0 = time.perf_counter()
    codec = check_codec()
    walls["codec_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with FilterbankFile(fn) as fb:
        plan, payload, _ = staged.step_geometry(
            staged.ReaderSource(fb), np.arange(1024) * 0.5, 1, 64, 0,
            DEFAULT_WIDTHS, None)
        overlap = int(plan.min_overlap)
        longest = (payload + overlap) * fb.bytes_per_spectrum // 4
    seeded = torch.Generator("cuda").manual_seed(SEED)
    weights = torch.randint(-(1 << 62), 1 << 62, (longest,),
                            dtype=torch.int64, device="cuda",
                            generator=seeded)
    passes, shipped = [], []
    for mode in (*INGEST_MODES, *INGEST_MODES):
        pf.ship_ahead.bytes = 0
        wall, nbytes, digests, rss = ingest_pass(fn, payload, overlap, mode,
                                                 weights)
        shipped.append(int(pf.ship_ahead.bytes))
        passes.append({"mode": mode, "wall_s": wall,
                       "gb_per_s": nbytes / wall / 1e9, "bytes": nbytes,
                       "blocks": len(digests), "rss_kb": rss,
                       "digests": digests})
    del weights
    if any(p["digests"] != passes[0]["digests"] for p in passes[1:]):
        fail("phase 4's ingest: the device blocks' digests differ between "
             "the passes (" + ", ".join(INGEST_MODES) + ")")
    if set(shipped) != {PHASE4["h2d_bytes"]}:
        fail(f"phase 4's ingest shipped {shipped} bytes, phase 4's sweep "
             f"{PHASE4['h2d_bytes']}: not phase 4's geometry")
    widened = [(ring, *widened_pass(fn, payload, overlap, ring))
               for ring in (True, False, True, False)]
    if any(w[2] != widened[0][2] for w in widened[1:]):
        fail("iter_blocks' float32 blocks differ between the ring and "
             "synchronous reads")
    walls["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    teardown = ring_teardown(tmp, fn)
    walls["teardown_s"] = time.perf_counter() - t0
    by_mode = {m: [p["wall_s"] for p in passes if p["mode"] == m]
               for m in INGEST_MODES}
    sync = statistics.mean(by_mode["sync"])
    widened_s = {"ring": [w[1] for w in widened if w[0]],
                 "sync": [w[1] for w in widened if not w[0]]}
    print("path native_ingest: " + json.dumps({
        "walls_s": walls, "codec": codec,
        "geometry": {"payload": int(payload), "overlap": overlap},
        "passes": [{k: v for k, v in p.items() if k != "digests"}
                   for p in passes],
        "mode_walls_s": by_mode,
        "over_sync": {m: statistics.mean(w) / sync
                      for m, w in by_mode.items()},
        "widened_blocks": WIDENED_BLOCKS, "widened_walls_s": widened_s,
        "widened_ring_over_sync": statistics.mean(widened_s["ring"])
        / statistics.mean(widened_s["sync"]),
        "blocks_equal": True, "block_digest_0": passes[0]["digests"][0],
        "host_peak_rss_kb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss,
        "phase4_sweep_s_this_run": gather_wall,
        "phase4_sweep_s_perf_md": 0.736,
        "note": "phase 4's sweep (this run, over the ring) and PERF.md's "
                "0.736 s (an earlier run, synchronous reads) are different "
                "runs",
        "teardown_threads": teardown, "card": card}))


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "pypulsar_tpu_torch")):
        fail("run from a checkout: pypulsar_tpu_torch/ is not beside "
             "chip_smoke.py")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    sys.path.insert(0, HERE)
    from pypulsar_tpu_torch.ops import _build

    wall_functions()

    card = card_line()
    t_start = time.perf_counter()
    phase_s = {}

    def mark(phase):  # the wall since the last mark, for the time budget
        phase_s[phase] = time.perf_counter() - t_start - sum(
            phase_s.values())

    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(f"kernels built in {_build.build_all():.1f} s")
    mark("1 build")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    report = []
    ts, payload = check_gather(device, report)
    check_gather_edges(device)
    check_boxcar(device, report, ts, payload)
    del ts
    torch.cuda.empty_cache()
    check_small_accel(device)
    probe_batched_transforms(device)
    mark("2 kernels, 5 accel")
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as stack:
        untuned(tmp)
        small_fn = check_small_sweep(tmp)
        plain_paths = plain_write_dats(tmp, small_fn, card)
        fn, info = write_obs(tmp)
        check_stage_kernels(fn, device)
        launches, gather_wall, gather_res = main_path(tmp, fn, info)
        mark("3 small sweep, 4 main path")
        stage_sp, stage_series, stage_s, stage_numbers = stage_path(
            tmp, fn, info)
        mark("6 stage")
        fold_dats, fold_stream = fold_stage(tmp, fn, info, device, report)
        mark("7 fold")
        chain = survey_chain(tmp, fn, info, device, stage_s)
        setup = start_setup(tmp, fn, chain["rfi"])
        # on a failure too: no writer outlives the script or its temp dir
        stack.callback(setup["pool"].shutdown, cancel_futures=True)
        mark("8 chain")
        engines = engine_paths(tmp, fn, info, device, report, gather_res)
        spectral = spectral_stage(tmp, fn, info, stage_s, stage_numbers)
        decimated = decimated_regime(tmp, fn, info)
        spectral_ch = spectral_chain(tmp, info, device, chain)
        ddplan = ddplan_path(tmp, fn)
        mark("9 engines")
        prep = prepfold_phase(tmp, fn, info, device, report)
        mark("10 prepfold")
        lane_launches = lane_and_multi_phase(tmp, info, device, report,
                                             chain)
        mark("11 lane")
        fits_paths = psrfits_phase(tmp, fn, info, chain, card, setup)
        mark("12 inputs")
        spectra_paths = spectra_phase(tmp, fn, card)
        mark("13 spectra")
        hour_paths = accel_hour_phase(tmp, fn, info, card, setup)
        setup["pool"].shutdown()
        mark("14 1-h search")
        resume_paths = resume_phase(tmp, fn, info, card)
        mark("15 resume")
        telemetry_paths = telemetry_phase(tmp, fn, info, card, stage_series,
                                          chain, prep["prepfold"])
        mark("16 telemetry")
        resident_paths = resident_phase(tmp, fn, card, gather_res, launches)
        mark("17 resident")
        fleet_paths = fleet_phase(tmp, fn, info, chain, card)
        mark("18 fleet")
        plane_paths = plane_phase(tmp, fn, info, chain, card)
        mark("19 hosts, daemon")
        mesh_paths = mesh_phase(tmp, fn, info, chain, card, gather_res)
        mark("20 meshes")
        tune_paths = tune_phase(tmp, small_fn, card)
        mark("21 tune")
        chaos_paths = chaos_phase(tmp, small_fn, card)
        mark("22 chaos, race, fuzz")
        traced = start_traced_sweep(tmp, small_fn)
        # on a failure too: the child outlives neither the script nor
        # its temp dir
        stack.callback(stop_child, traced[0])
        tools_paths = tools_phase(tmp, small_fn, card)
        mark("23 tools, psrlint")
        s27b_paths = s27b_phase(tmp, small_fn, card, traced)
        mark("24 last host slice")
        native_phase(tmp, fn, card, gather_wall)
        mark("25 host codec, ring")
    paths = {"sweep_1024_trials": launches,
             "stage_single_pulse_pass": stage_sp,
             "stage_series_pass": stage_series,
             "fold_dats": fold_dats, "fold_stream": fold_stream,
             "survey_chain": chain["launches"],
             "sweep_tree": engines["tree"], "sweep_fourier": engines["fourier"],
             "spectral_stage": spectral, "spectral_decimated": decimated,
             "spectral_chain": spectral_ch, "ddplan": ddplan, **prep,
             "lane": lane_launches, **fits_paths, **spectra_paths,
             **hour_paths, **resume_paths, **telemetry_paths,
             **resident_paths, **fleet_paths, **plane_paths,
             **mesh_paths, **plain_paths, **tune_paths, **chaos_paths,
             **tools_paths, **s27b_paths}
    for k in report:
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in paths.items()}
        # the first path that drives the kernel: the 1024-trial sweep for
        # the dedispersion kernels, the tree engine's sweep for its levels
        # and snap, the --datbase fold for the candidate fold (whose array
        # form no driven path calls: its launches stay 0), prepfold for
        # the channel fold, the lane for the multi-series fold (its array
        # form, too, stays 0)
        first = (lane_launches if k["name"].startswith("fold_parts_multi")
                 else fold_dats if k["name"].startswith("fold_parts")
                 else prep["prepfold"] if k["name"] == "fold_chan"
                 else engines["tree"] if k["name"].startswith(
                     "gather_sum/tree") else launches)
        k["launches"] = first[k["name"]]
    slowest = sorted(FUNCTION_WALLS.items(), key=lambda kv: -kv[1][1])[:40]
    print("function walls s: " + json.dumps(dict(slowest)))
    print("phase walls s: " + json.dumps(phase_s))
    print(json.dumps({"kernels": report}))
    print(card)
    # the contract's card count: every card, not a lease's
    count = torch.cuda.device_count()  # psrlint: ignore[PL002] -- the contract
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of soc_tpu_torch: the quickest proof that the port still
builds, agrees with its plain versions and runs its main path on the card.

    python3 chip_smoke.py            # full size, one CUDA device

Phases (any failure exits non-zero before the final line):
  1. device: a CUDA device must be present (there is no CPU path); prints
     the card's name and power limit as nvidia-smi reports them
  2. build: compiles every soc_tpu_torch/csrc/*.cu source with nvcc, one
     process each, all at once, and prints each kernel's registers and
     spills from ptxas; a spill in a2e_all_sizes or a2e_clamp fails
  3. A2E kernel against its plain twin on the card at NE 16/48/128/256
     (NFREQ 44, all 24 grain sizes), TF32 off; then its tile, staged
     columns and resident warps per SM at the pipeline's shape (fewer
     than 8 warps fail), and both timed there (262,144 cells, NE 128);
     then the shapes both A2E kernels take on this card (their shared
     memory ceiling: the largest NE at NFREQ 1000, the largest NFREQ at
     NE 256 and at NE 32)
  4. the `pipeline` verb (cli.main, as `python -m soc_tpu_torch pipeline`)
     on a 64^3 model with a stochastic (GSET) dust: absorption run ->
     A2E -> 64x64 map, with checks of shapes,
     finiteness, energy balance and the kernel's launch count; then the
     absorption stage again with the same seed and lane pool: the
     run-to-run spread of the tallies (the atomics add in another order),
     max |diff| / max, the largest relative difference above 1e-3 of the
     maximum and the share of entries that differ, and the float64 escape
     totals, within phase 9's bound (1e-4 relative or 1e-6 of the
     maximum)
  5. the `rt` verb on the same grid with the equilibrium dust the
     pipeline's absorption stage wrote
  6. the A2E clamp kernel (negative weights and absorbed values) against
     the plain twin at NE 16/48/128/256 (all 24 sizes), on inputs where
     the clamp takes effect: some heating entries are negative, and the
     pre-folded kernel (which cannot clamp) differs from the twin by more
     than 10x the tolerance; then
     `stochastic.solve_emission` on such inputs at the pipeline's shape,
     which must run the clamp kernel and not the pre-folded one; then the
     clamp kernel's tile, staged rows and resident warps per SM at that
     shape (fewer than 8 warps fail), and both timed there
  7. the gather/scatter probes (soc_tpu_torch.probes: probe_gather,
     probe_gather2, gather_probe) at the scripts' constants: every row
     timed through its CUDA kernel and its plain version and held to it
     (gathers bit for bit, RG at 1e-6 relative, scatters and one-hot
     deposits at 1e-5 of the maximum, the MX correctness deposit also at
     1e-5 of an exact float32 scatter's maximum), and every row but RG
     also through one PyTorch call, its library yardstick (embedding_bag
     for the gathers, index_add_ for the scatters and one-hot deposits);
     each gather, RG and scatter row's device time (best of 3, with the
     spread; a row whose time was not measured fails; with its best
     call's span, first start to last end, and each of its device
     intervals where it has several) beside its plain version's and its
     library call's (with its span), and RG's beside its two-call
     reference (embedding_bag, then a sum: RG has no one-call
     yardstick); for each MX row the deposit rate (deposits per second of
     device time) of the kernel and of index_add_; then the rate of random
     atomics, the scatter kernel's FLAT LCG_BEFORE form over S1's inputs
     (launches outside the counted run)
  8. the sharded A2E solve: `stochastic.solve_emission` at the pipeline's
     shape (262,144 cells x 24 sizes x NE 128 x NFREQ 44, with the
     polarised sum) over all visible cards, then over cuda:0 two and three
     times, on both routes (pre-folded; clamp, with a negative weight and
     negative absorbed values): equal bit for bit to the one-launch solve,
     one launch per shard; then solve_all_sizes_sharded over phase 9's six
     shards timed against the plain twin
  9. the `devices N` path: the `pipeline` verb (full.run_pipeline with a
     device list) at full width over cuda:0 six times, a (dp 3 x freq 2)
     mesh: energy balance per channel, absorbed.data, emitted.data and the
     map against phase 4's one-device run, one A2E launch per shard; then
     the `rt` verb's path (driver.run) over the same mesh with one packet
     batch per surface element
 10. the `rt` verb (cli.main) on BASELINE config 2's octree at full width:
     a 64^3 root with its central 8^3 block refined and a 64-cell cascade
     below (266,752 cells), the equilibrium dust at 44 channels, the
     background packets of phase 4, `cellpackets` 533,504 (2 a cell a
     channel: 23,474,176 packets a cell pass), a 64x64 map; three runs:
     (a) `iterations 3` (with `csave`), (b) the same with `ali 1` and
     `reference 1`, (c) `emweight 1` and `iterations 2` at a quarter of
     the cell packets, each cell pass one mixed pool over (cell,
     channel) on every route. (b) and (c) `cload` (a)'s constant-source
     heating: the same background packets on the same streams, not traced
     again. These cuts, and the ALI rerun's below, hold the smoke's time
     down: (b) keeps its packets, since its gate against (a) is set by
     their spread at 2 packets a cell; (c)'s gate (the balance) and the
     rerun's (the same packets without and with ALI) do not depend on the
     packet count. Each: finite fields, each cell pass's
     energy balance per channel (signed sums, driver.pass_balance) within
     0.5%, the stage seconds and each pass's packets/s; (b)'s temperatures
     within 2% of (a)'s (soc_tpu's bound for iterated runs) on all but
     1e-4 of the leaf cells, within 5% on every one; then one cell pass of
     (a)'s last emission, one packet a cell and channel, rerun without
     and with ALI: tabs_noali within 1e-4 relative or 1e-6 of the maximum
     of tabs_ali + xab, xab a nonzero, partial share. Phase 17 (b1) runs
     (b) over six shards against this one-card run
 11. the `pipeline` verb (cli.main) on the same octree with the GSET dust
     (phase 4's .solver file reused; a quarter of `bgpackets` since phase
     16 runs, as in 14 (a)): absorption run -> A2E (one launch a
     card, every cell, the 576 parent cells' rows zero) -> map: energy
     balance, emitted.data zero on the parents, the map finite; then the
     A2E kernel on those absorptions against its plain twin, timed
 12. the constant sources on the same octree, each source one
     mixed-frequency pool: (a) the `rt` verb with the equilibrium dust,
     BASELINE config 2 whole: the background with `split 4` and two point
     sources, one inside the refined block and one outside the cloud
     with PS_METHOD 4 (the illumination cone): each source's packets,
     seconds and packets/s, the clones served (none fails), the energy
     balance per channel ((absorbed + escaped + born outside) / launched,
     within 0.5%), the point sources' share of the absorbed energy, and
     the refined leaves' absorbed energy from the split background
     against phase 10 (a)'s split-free background (the same packets'
     streams) within five times the spread of 64 cell groups'
     differences; (b) the `pipeline` verb with the GSET dust (phase 4's
     .solver reused) at a quarter of `bgpackets` (one batch of the
     background, 8,650,752 packets, and 249,999 a channel of the sky: its
     gates hold for any count, and the cut keeps the smoke under 800 s
     with phase 15): the split background, the weighted Healpix sky
     (`hpbgw`), a diffuse field (one packet a cell and channel since
     phase 16 runs, two before) and `saveint 2`: the balance per
     channel, the (I, Ix, Iy, Iz) intensity file finite with I equal to
     the absorbed file times PLANCK f gl_cm / (ABS_f FACTOR) (1e-5
     relative), the parents' emission zero, one A2E launch a card, then
     a2e_all_sizes on these absorptions against its plain twin, timed;
     (c) the `rt` verb with two dusts and `abundance` (MSF on, one
     scattering function a dust) at half of `bgpackets` (three batches of
     the background, cut with (b) to keep the smoke under 800 s), `simum`
     selecting about half of the
     channels, without and with `optishalf`: the masked channels absorb
     nothing, the balance per selected channel, and the temperatures of
     the two runs within 1% (bfloat16 keeps 8 bits)
 13. ROI save and load, mmapabs, the weighting, mirrored faces and the
     render suite on the same octree with the equilibrium dust, the
     background of phase 4, no cell packets: (a) `rt` with `roi 8 15 8 15
     8 15` (an 8^3 box of unrefined root cells clear of the refined block
     and the faces), `roisave`, `roinside 8` and `mmapabs` with
     SOC_TPU_TALLY_BYTES set for four device blocks of 11 channels: the
     ROI file finite, non-negative, with photons in every lit channel;
     then the same run in memory: absorbed.data and the ROI tally within
     1e-4 relative or 1e-6 of the maximum (phase 4's rerun bound), and the
     background's seconds with the blocks, in memory and (phase 10 (a))
     without the ROI save;
     (b) `rt` on the box's 8^3 sub-model (example_model's roi_box) with
     `roiload` of (a)'s file and `roipackets` 589,824 (4 a (element,
     pixel) pair and channel, 25.95M packets): (absorbed + escaped) /
     injected within 0.5% a channel, the absorbed energy within 10% of
     (a)'s inside the box (soc_tpu's tests/test_roi.py bound); (c1) `rt`
     with `stepweight 2 1.3 0.4`, `direweight 1 0.5` and `split 4`: no
     clone; against (a), the leaf cells' temperatures within 5% on all but
     5e-3 of them (soc_tpu's 5% on all but 1e-4 is below the weighting's
     variance at these packets), their mean |relative difference| within
     2e-2, each level's signed mean within 1e-3, 3e-3 and 3e-2 (levels
     0-2), each lit channel's absorption over the leaf cells within 1%
     (bounds from seed-to-seed readings on an H100); (c2) `rt`
     with `mirror xyz` (the three low faces, an octant of a symmetric
     cloud) at a quarter of `bgpackets` (one batch of the background, a
     fifth of (a)'s packets; cut with 12 (b) and (c) to keep the smoke
     under 800 s): the balance per channel within 0.5%, absorbed at
     least (a)'s in every channel; (d) from (a)'s temperatures (loadtemp):
     the orthographic map from theta 70 deg with FITS, `savetau` at 100
     and 850 um and column density and `pssavetau` for phase 12's point
     sources; MAP_HIER orthographic; `mapint 2`; `yshear 2`; the Healpix
     map at NSIDE 64 from the centre with `interpolate 3` and without;
     MAP_HIER Healpix; a 256x128 perspective panorama; `roimap` in the
     map-only mode with a NaN emission outside the box: every map finite
     with a positive peak, the hierarchy planes summed equal to the plain
     maps within 1e-5 of the peak, every FITS file read back bit for bit
     equal to its plane, the sheared map at least the plain one; each
     run's seconds and packets/s, each render's seconds, rays and steps
 14. polarized dust emission on the same octree: (a) the `pipeline` verb
     with phase 11's GSET model, `polarisation` (write_aalg: an aligned
     grain size a cell, an eighth of the cells below the size grid and an
     eighth above) and `polmap` with a tangled field: a2e_all_sizes
     launched once a card, with the align weights; PEMITTED against the
     plain twin's align sum on 16,384 leaf cells (REL_TOL); emitted.data.P
     equal to the returned PEMITTED, at most EMITTED (1e-5 relative), zero
     on the 576 parents, EMITTED (1e-5) where aalg lies below the smallest
     size and zero above the largest; then a2e_all_sizes with align on
     the run's absorptions against its plain twin, timed; (b) nine
     map-only `rt` runs from (a)'s emission: `polmap` from theta 70 deg,
     `polstat 1` and `3` each with the tangled field and a uniform
     in-plane one, `polstat 2` with `yshear 2` and a `maxlos` of twice
     the box, Healpix I/Q/U at NSIDE 64 from the centre with
     `interpolate 3` and without, Healpix POLSTAT with a uniform field
     along +Z: every plane finite, the map files equal to the returned
     planes, the polarized fraction at most p0 / (1 - p0/3), I within
     [1 - p0/3, 1 + 2 p0/3] times the plain map of the same run (1e-5
     slack; not under POLSTAT 2, whose rays stop at `maxlos`), the
     uniform field's rT and jT below 1e-3 rad, B_LOS and B_POS at most B,
     POLSTAT 3's column density the plain map's (1e-5 of the peak), the
     sheared I at least the unsheared one, the polar pixels' rI above 1.3
     rad, every FITS file read back bit for bit; (c) `rt` with
     `CR_HEATING 1.0` from a `cload` of phase 10 (a)'s constant-source
     heating (phase 10 (a) runs `csave`): no leaf cell's temperature below
     (a)'s by more than 1e-4 (phase 4's rerun bound), the coldest decile's
     mean raised; each run's seconds, each render's seconds, rays and
     steps
 15. scattered light (the `sca` verb, cli.main) on BASELINE config 4's
     model, phase 10's octree with the equilibrium dust, `ffs 1`: (a) the
     isotropic background (one batch, 196,608 packets a channel), phase
     12's two point sources (20,000 packets each a channel) and the
     Healpix sky (NSIDE 16, 50,000 a channel) over `simum 0.1 3.0` (15
     channels), three directions, 64x64 maps, each source one mixed pool;
     the background on two channels as one mixed pool, as a pool a
     channel (soc_tpu's schedule) and under `devices 2` on this card, the
     last two held to the first (phase 9's rerun bound, and 2e-4); the
     three pools' seconds printed; a thin uniform 64^3
     cloud: the single-scattering normalisation within 4%; (b) the
     internal observer at the centre (`outnside 64`): the background and
     the diffuse field (one packet a cell) over 4 channels; (c) two dusts
     with abundances (WITH_MSF), one direction, `fits 1`, 5 channels; (d)
     the cell emission of phase 14 (a)'s emitted file, one packet a cell,
     `simum 3 200` (17 channels), with `ffs 1` and `ffs 0`: with FFS every
     packet gives an event, and the thin channels' flux (scattering depth
     below 0.1 across the cloud) is at least the ffs 0 run's less five of
     that run's standard errors (sqrt(2 / its events): the two estimate
     the same flux, FFS with far less variance); (e) both A2E kernels'
     global-memory form beyond the shared form's ceiling, NE 1856 at
     NFREQ 44 and NFREQ 1088 at NE 256, one size of seeded stacks
     (example_model.seeded_a2e_stacks), 512 cells, the align weights:
     launched through the wrappers, then held to the plain twin (REL_TOL)
     and timed (the kernel the mean of 3 calls after a warm-up, the twin
     one call). Every map finite and non-negative, outcoming.socs read back
     (header, frequencies, maps), the FITS cube read back bit for bit,
     every event peeled toward every observer (none dropped); each source
     pass's seconds, packets, events, transport and peel-off lane steps
 16. BASELINE config 5 ("Full ASOC_driver pipeline: multi-population dust
     with spatially varying abundances (A2E_MABU) + library lookup
     acceleration (A2E_LIB)") on phase 10's octree: two GSET dusts (tst,
     tst2, 24 sizes, NE 128; phase 4's .solver for the first) with
     per-cell abundances, 44 channels, a quarter of `bgpackets` as in
     phase 12 (b) (every gate holds for any count; cut for time). (a) the
     `pipeline` verb in makelib mode: one A2E launch a dust and card, the
     energy balance per channel within 0.5%, the parents' emission zero,
     the library written with its occupancy in (0, 1]; the stage seconds,
     each dust's A2E seconds, build_library's (host NumPy); a2e_all_sizes
     timed on the first dust's share, held to the plain twin on 16,384
     leaves. (b) uselib: only the 3 FSELECT channels simulated, a
     3-column absorbed.data; the lookup on the card timed with CUDA events
     (cells/s), the same bin as its NumPy twin in >= 99.9% of the cells,
     emitted.data the twin's lookup of (a)'s absorptions in >= 99.9% of
     the leaves, and against (a) at >= 100 um over the entries above 1e-3
     of the peak: the median and 90th percentile of the relative
     difference (LIB_MEDIAN, LIB_P90); the map finite. (c) nnmake then
     nnsolve (nnabs at the FSELECT wavelengths, nnemit 8 FIR channels,
     nnthin 4, nnnet 13 17 13) through the `mabu` verb on (a)'s
     absorbed.data (A2E_MABU's NN paths; a pipeline run would simulate
     the absorptions twice more): two A2E launches, then none; nn_fit's
     seconds and Adam steps/s on the card; the columns outside nnemit
     exactly 0, the median against (a) in the nnemit columns
     (NN_MEDIAN). (d) the host verbs through
     cli.main on (a)'s files: a2e_pre for tst2 at NE 128 (the .solver bit
     for bit the pipeline's); a2e on the first dust's share under
     --profile (one launch a chunk; the Chrome trace names a2e_all_sizes;
     the output the in-memory solve's bit for bit), the streamed solve in
     65,536-row chunks (a launch each), IFREQ with aalg (one column, a
     .P file); a2e_lib makelib (the real solve), uselib on the full and
     on the 3-column file (equal), ofreq; mabu on (a)'s absorbed.data
     (equal bit for bit to (a)'s emitted.data) and with an ofreq file;
     eqsolve on the equilibrium dust (<dust>.T finite, the leaves within
     1-200 K with a median of 3-30 K: the background alone heats them);
     dust and sampleini in a scratch directory
 17. checkpoint/resume and `devices` on phase 10's octree (266,752 cells,
     44 channels, a 64x64 map), a quarter of `bgpackets` (one batch of
     the background, 8,650,752 packets: every gate below holds for any
     count) but in (b1): (a) `python -m soc_tpu_torch rt` with
     `checkpoint ck.npz 1`, `iterations 2` and phase 10 (c)'s cell
     packets (one a cell and channel), SIGKILLed once the file lists a
     phase-1 unit, run again and SIGKILLed once it has added a unit and
     the file holds `iter0`, then run to its end through cli.main: its
     stderr names the units it skipped (at least one); absorbed, emitted,
     T and the map within phase 4's rerun bound (1e-4 relative or 1e-6 of
     the maximum) of an uninterrupted run; the balance per channel
     ((absorbed + escaped + born outside + the cell passes' escaped) /
     (launched + the cell passes' injected), and each cell pass's) within
     0.5%; each flush's seconds and bytes. (b1) phase 10 (b)'s run (`ali
     1`, `reference 1`, `iterations 3`, all its cell packets, (a)'s
     heating loaded) over phase 9's six shards (cuda:0 six times, dp 3 x
     freq 2): absorbed, emitted, T and the map within the rerun bound of
     phase 10 (b)'s one-card run, each pass's seconds and packets/s beside
     one card's, the balance. (b2) over MESH_SIMUM's band (30-3000 um: 19
     channels, all in frequency block 0, so the three dp shards of that
     block run the pools; (b1) and (c) run both blocks, and the shorter
     channels' tails cost minutes over the shards), the background
     and the weighted Healpix sky (`hpbgw`) with `split 4`, two point
     sources (PS_METHOD 4 for the external one), a diffuse field, two
     dusts' `abundance`, `roi` + `roisave` and `mmapabs`, over the six
     shards and on one card: the balance per channel within 0.5% on both;
     each source whose packets keep their streams (no clone served) its
     own absorbed energy a cell (the pass's own TABS: its deposits alone,
     whatever the sources before it left) within the rerun bound; each
     split source's refined leaves within five times the spread of 64
     cell groups' differences (phase 12 (a)'s rule) plus 1e-4 of their
     total (the order of the additions, where both serve the same
     clones); the ROI file's photons within 1%. (b3) the background over
     the same band without splitting, under `mirror xyz`, `stepweight 2
     1.3 0.4` and `direweight 1 0.5`: its own absorbed energy a cell, the
     absorbed file and T within the rerun bound (the weights keep the
     balance only in expectation: phase 13 (c1) holds their bias).
     (c) phase 11's `pipeline` (the GSET dust, a quarter of `bgpackets`)
     over the six shards with `checkpoint ck.npz 1`, SIGKILLed once its
     absorption stage has recorded its unit, then resumed in-process: a
     skipped unit, one a2e_all_sizes launch a shard (the kernels line's
     ckpt_launches), and emitted.data and absorbed.data within the bound
     of phase 11's one-card run
 18. `domains 4` (parallel/domain.py: the grid cut into four Z slabs of
     16 root planes, the central refined block cut by the face at z 32)
     over cuda:0 four times, on phase 10's octree, against the same ini
     on one card. Each slab pass
     prints its seconds and packets/s beside one card's, its supersteps,
     its emigrants a superstep (mean and peak) and its pending queue's
     peak. Each field is held by the CPU tests' rule for domain runs
     (soc_tpu's, tests/test_domain.py: a packet that crosses a slab face
     moves by up to PEPS and may take another path): its total within
     1e-3 and at least 98% of its cells within 1e-3 relative or 1e-6 of
     its maximum; the absorbed files' parent rows (-1e20) equal. (a) `rt`
     with `iterations 2` of cell emission under `ali 1` (one packet a
     cell and channel, one ALI pass) from phase 10 (a)'s background
     heating (`cload`; (b) runs the background over the slabs): absorbed,
     emitted, T and the map; the run's balance per channel and the cell
     pass's within 0.5%. (b) phase 11's GSET `pipeline`
     (full.run_pipeline with the domains list, a quarter of
     `bgpackets`): one a2e_all_sizes launch on the assembled tallies (the
     kernels line's domain_launches), emitted.data and absorbed.data
     against phase 11's. (c) at a sixteenth of `bgpackets` over
     MESH_SIMUM's band, under `mirror z` and two dusts' abundances (MSF):
     the background and the weighted Healpix sky with `split 4`, two
     point sources (PS_METHOD 4 for the external one) and a diffuse
     field with EMWEI (`cellpackets` set, which EMWEI needs; a quarter
     of a packet a cell and channel, no cell pass at `iterations 1`): the
     phase-1 balance per channel within 0.5%; each source whose packets
     keep their streams its own absorbed energy a cell by the rule, each
     split source's refined leaves by phase 12 (a)'s. A pass over the
     slabs costs its supersteps (four pools' bodies each) more than its
     packets, hence (c)'s cut, one run for
     the ALI pass and the sources (EMWEI would take the cell pass's
     route), and one mirrored Z face, the bottom slab's: the band's
     transparent channels keep a packet between two mirrored Z faces
     bouncing for 1e5 steps and more (the tests hold `mirror zZ` on
     thick channels)
 19. several processes (parallel/dist.py on torch.distributed, one gloo
     group): (a) the `pipeline` verb through cli.main as six processes on
     this card, started with soc_tpu's variables (SOC_TPU_COORDINATOR,
     SOC_TPU_NUM_PROCESSES, SOC_TPU_PROCESS_ID; CUDA_VISIBLE_DEVICES the
     card), phase 9's model with `devices 6`: phase 9's (dp 3 x freq 2)
     mesh, one shard a process. Process 0's absorbed.data, emitted.data
     and map_dir_00.bin against phase 4's within phase 9's bound; each
     process's balance a channel within 0.5%, one a2e_all_sizes launch and
     no a2e_clamp launch (each solves every cell on its own card), the
     same absorbed and emitted arrays (sha256) in every process; the
     processes past 0 write no file (each runs in a directory of its own,
     with links to the files process 0 writes before the others read
     them). Each process's stage seconds, its transport passes' device
     spans (CUDA events) and its host seconds in the collectives (waits
     for the others included), and the phase's wall time. (b) with two cards
     or more visible, one process a card (`devices` the cards) held the
     same way, its absorption seconds beside the same mesh driven from
     one host thread in this process, phase 4's one pool and PR 3's
     one-thread `devices 4` and one pool; on one card it prints that it
     needs two. Every
     process has MP_TIMEOUT seconds; a failure kills the others and
     fails the phase with their stderr
 20. `sca` with `devices 4` over processes: phase 15 (a)'s model
     (BASELINE config 4's octree, ffs 1) cut to its background in one
     direction over (a)'s optically thinnest channel (2.87 um): a pool's
     cost is its drain tail, paid a shard, and its longest packets' many
     scatterings set that tail (at 0.21 um, with one direction or with
     three and two channels, the phase took 41-43 s); one process with
     devices cuda:0
     four times, then two processes on this card of two shards each
     (SOC_TPU_LOCAL_DEVICE_IDS 0,0), started as phase 19 starts its. Both
     processes' maps equal (sha256); process 0's outcoming.socs against
     the one process's maps within phase 9's rerun bound (the peel-off's
     atomics add in another order on every run, so the card gives no bit
     for bit, which the CPU tests hold); process 1 writes no file; each
     run's seconds
 21. the `bench` verb's module (soc_tpu_torch/bench.py): (a)
     march_path_lengths of 2^17 rays on the soc_example grid in blocks of
     32 steps, a block one CUDA graph, against the step-by-step form, bit
     for bit, both timed; (b) its sections as functions at cut sizes:
     their own arguments (repeats 1, 2^20 octree packets, 2^16 scattered
     light packets, 16,384 A2E cells, iters 20, a 128x128 map) and
     soc_tpu's knobs as tests/test_bench_harness.py sets them (a 16^3
     large model, 4,096 streamed rows, a 32^3 xl model, 8,192 packets):
     every key of each section present, every rate finite and positive,
     every `sane` true, a2e_all_sizes launched (bench_launches)
 22. the transport's march block as one kernel (csrc/march.cu
     `march_block`, transport/march_kernel.run_block) against the eager
     block (StepKit.service + StepKit.march), one block each from the same
     pool snapshot at the main path's shape (a 64^3 root grid, 44
     channels, 2^21 lanes, csc 2500 bins, after one eager body: frozen,
     dead and live lanes), plain, with the per-frequency tally, with ALI
     and with a col0 tally block: ind, pending, scatterings and counter
     agree on 99.9% of the lanes or more, the float state there within
     1e-6 relative, the served lanes' new directions (the kernel's
     Threefry words) within 1e-6 on 99.9% of them, tabs, intf, xab and
     absd within 1e-5 (the atomics add in another order); then with the
     tally both blocks timed from one snapshot (CUDA events, 5 graph
     replays and 3 issued calls each) beside the kernel's bound
The kernels line gives each kernel's launches on its path (phase 4 for the
A2E kernel and for march_block, whose launches are the main path's pool's,
one a refill body; under octree_* the A2E kernel's launches, time, plain time and bound
on phase 11's octree, under sources_* on phase 12 (b)'s, under pol_* on
phase 14 (a)'s with the align weights; 6 for the clamp kernel, 7 for the probes, 9 for the
sharded A2E, whose other numbers phase 8 takes over the same six shards,
and under ckpt_launches its launches on phase 17 (c)'s resumed run;
under domain_launches the A2E kernel's on phase 18 (b)'s; under
mp_launches each process's in phase 19 (a); under bench_launches phase
21's;
15 (e) for the two kernels' global-memory forms, a2e_all_sizes_global and
a2e_clamp_global, at NE 1856 and under nf1088_* at NFREQ 1088; under
config5_* phase 16 (a)'s launches, the kernel's time on the first dust's
share, its bound, and on 16,384 leaves (config5_check_cells) the kernel's
and the plain twin's times and the largest difference; march_block's
time, plain time (the eager block's graph replay) and bound from phase 22),
its time, its plain version's, its library call's where one exists, and
its bound: the larger of the bytes it must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s (an H100 SXM's published peaks). The
last line is a JSON object naming the device.
"""

import argparse
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()
REL_TOL = 1e-4          # kernel vs plain twin, relative, see phase 3
CLAMP_EFFECT = 10 * REL_TOL   # least change the clamp must make, phase 6
BALANCE_TOL = 5e-3      # (absorbed + escaped) / injected - 1, per frequency
# phase 9 against phase 4: the same packets on the same streams, the
# card's atomic adds in another order: every entry within 1e-4 relative or
# 1e-6 of the field's maximum
PRODUCT_RTOL, PRODUCT_ATOL = 1e-4, 1e-6
PRODUCT_SHARDS = 6      # phase 9: dp 3 x freq 2 at NFREQ 44
FULL_BGPACKETS = 999999
N = 64                  # root grid size: 64^3 cells, soc_example's
OCTREE = (8, 64, 3)     # phases 10-11: BASELINE config 2's refinement
OCTREE_CELLS = 266752   # 64^3 + 4,096 + 512
OCTREE_PARENTS = 576    # 512 refined root cells + the 64-cell cascade
CELLPACKETS = 533504    # phase 10: 2 packets a cell a channel
EMWEI_PACKETS = CELLPACKETS // 4   # phase 10 (c): a quarter of them
# phase 10, (b) against (a): soc_tpu's own bound for iterated runs, 2%
# (tests/test_iterations.py, on every cell of an 8^3 model), on all but
# ITER_SHARE of the leaf cells and ITER_MAX on every one: at 2 packets a
# cell the coldest, densest cells (3.1-3.6 K on level 2) scatter by up to
# 2.5% between two iterations of one plain run (on an H100)
ITER_RTOL, ITER_SHARE, ITER_MAX = 0.02, 1e-4, 0.05
SPLIT = 4               # phase 12: `split 4`: at most 15 clones a packet
PSPACKETS = 50000       # phase 12 (a): packets a point source and channel
# phase 12 (a): (x, y, z, share of the background's power) in root cells:
# one inside the refined block (root cells 28-35), one above the cloud
POINT_SOURCES = ((32.13, 31.87, 32.29, 0.2), (30.7, 33.2, 104.0, 1.0))
PS_METHOD = 4           # phase 12 (a): the external source's cone
SKY_NSIDE = 16          # phase 12 (b): the Healpix sky's resolution
DIFFUSE_SHARE = 0.5     # phase 12 (b): the diffuse field's power share
SPLIT_SIGMAS = 5.0      # phase 12 (a): the refined cells' statistical bound
SIMUM = (1.0, 200.0)    # phase 12 (c): the simulated band [um], 22 of 44
OPTISHALF_TOL = 0.01    # phase 12 (c): T with and without optishalf
ROI_BOX = (8, 15, 8, 15, 8, 15)   # phase 13: an 8^3 box of unrefined root
ROI_NSIDE = 8           # cells, clear of the refined block and the faces
ROI_PACKETS = 589824    # phase 13 (b): 4 a (element, pixel) pair a channel
ROI_RTOL = 0.1          # (b) in-box absorption, soc_tpu's tests/test_roi.py
MMAP_BLOCK = 11         # phase 13 (a): channels a device block of mmapabs
# phase 13 (c1) against (a), each bound set from seed-to-seed readings
# of weight_readings on an H100 (PERF.md):
# soc_tpu's 5% (tests/test_ini_wiring.py) on all but WEIGHT_SHARE of the
# leaf cells (the pair reads 1.3e-3, (c1) at another seed against (a)
# 3.2e-3); the leaf cells' mean |relative T difference| (8.8e-3; 1.4e-2
# between two seeds of (c1)); each level's signed mean (at most 2.4e-4,
# 9.9e-4 and 1.2e-2 over levels 0-2 seed to seed; a dropped service weight
# or direction weight moves levels 0 and 1 by 4.3e-3-1.9e-2); a channel's
# absorption over the leaf cells (2.5e-3; 4.3e-3 seed to seed)
WEIGHT_RTOL, WEIGHT_SHARE, WEIGHT_MEAN_ABS = 0.05, 5e-3, 2e-2
WEIGHT_LEVEL = (1e-3, 3e-3, 3e-2)
WEIGHT_CHANNEL = 0.01
MIRROR = "xyz"          # (c2) the low faces: an octant of a symmetric cloud
HP_NSIDE = 64           # phases 13 (d), 14 (b): the all-sky maps' resolution
POL_RTOL = 1e-5         # phase 14: the formulas' bounds, relative slack
POL_CHECK_CELLS = 16384  # phase 14 (a): PEMITTED against the plain twin
HIER_TOL = 1e-5         # (d) the MAP_HIER planes summed, of the peak
# phase 15: scattered light on the octree (BASELINE config 4)
SCA_SIMUM = (0.1, 3.0)      # (a): 15 channels, 0.10-2.87 um
SCA_SIMUM_2 = (0.2, 0.3)    # (a) on 2 channels (0.21, 0.26 um): the pools
SCA_SIMUM_B = (1.2, 3.0)    # (b): 4 channels
SCA_SIMUM_C = (0.3, 1.0)    # (c): 5 channels
SCA_SIMUM_D = (3.0, 200.0)  # (d): 17 channels, 3.6-169 um
SCA_BGPACKETS = 50000       # the sky's packets a channel; the background
                            # sends its one batch, 8 AREA = 196,608
SCA_PSPACKETS = 20000       # (a): packets a point source and channel
SCA_DIRS = ((0.0, 0.0), (70.0, 30.0), (120.0, -45.0))   # (a): degrees
A2E_BEYOND = ((44, 1856), (1088, 256))   # (e): (NFREQ, NE), beyond both
                                         # kernels' shared forms
# phase 16 (b), (c): the surrogates' envelope against the full solve, the
# median and 90th percentile of the relative difference at >= 100 um. The
# library's p90 is soc_tpu's for a steep octree (tests/test_library.py:
# 172-173). soc_tpu's medians, 0.12 for the library and 0.1 for the NN
# (tests/test_pipeline_modes.py:90-94), do not hold on this model for
# soc_tpu's own algorithms: at a quarter of `bgpackets` a cell's
# absorption in a reference channel is noisy, 1.5e-4 of the leaves absorb
# nothing in one (which floors that library axis at log10 1e-33), and the
# two dusts' abundances vary cell to cell. On an H100 the library reads a
# median of 0.1703, the NN 0.1767-0.1785 with three or four nnabs
# channels (PERF.md):
# each median bound is that reading with soc_tpu's ~50% headroom.
# NN_EMIT_CHANNELS: the FIR channels of nnemit
LIB_MEDIAN, LIB_P90 = 0.25, 0.7
NN_MEDIAN, NN_EMIT_CHANNELS = 0.25, 8
# phase 17 (b2): the ROI file's photons over the mesh against one card:
# the split background's clones (a statistical share) cross into the box
ROI_MESH_RTOL = 0.01
# phase 17 (b2), (b3): the simulated band [um], 19 of 44 channels, all in
# frequency block 0 of the six shards, so its three dp shards run the
# pools: the shorter channels' drain tails in the dense core, paid once a
# shard in turn on one card, make a pass over the mesh several times
# longer (as at 15-3000 um, which reaches block 1's 15.4 um channel);
# (b1) and (c) run both blocks
MESH_SIMUM = (30.0, 3000.0)
MESH_PSPACKETS = 5000   # (b2): packets a point source and channel
DOMAIN_SLABS = 4        # phase 18: Z slabs, cuda:0 four times
DOMAIN_RTOL, DOMAIN_ATOL, DOMAIN_SHARE = 1e-3, 1e-6, 0.98   # the rule
DOMAIN_MIRROR = "z"     # phase 18 (c): the bottom slab's face
SCA_MP_SHARDS = 4       # phase 20: `devices 4`: cuda:0 four times in one
SCA_MP_RANKS = 2        # process, and two processes of two shards each
SCA_SIMUM_20 = (2.5, 3.0)   # phase 20: (a)'s thinnest channel, 2.87 um
# phase 21: the bench's sections at cut sizes: soc_tpu's knobs as
# tests/test_bench_harness.py sets them, then each section's own sizes
BENCH_KNOBS = dict(SOC_BENCH_LARGE_N="16", SOC_BENCH_LARGE_ROWS=str(1 << 12),
                   SOC_BENCH_XL_N="32", SOC_BENCH_XL_PKTS=str(1 << 13))
BENCH_CUT_LANES = 1 << 16   # phase 21: the 16^3 and 32^3 sections' pools
MP_RANKS = PRODUCT_SHARDS   # phase 19 (a): processes on one card, one
                            # shard each of phase 9's (dp 3 x freq 2) mesh
MP_TIMEOUT = 600        # phase 19: seconds a process may take
MP_GROUP_TIMEOUT = 300  # phase 19: seconds a collective may wait
# phase 19 (b): PR 3 run 7's `devices 4` absorption on four H100s, one
# host thread, and one pool on one card (PERF.md)
PR3_THREAD_S, PR3_POOL_S = 5.995, 4.501
# phase 19: one process of the group (python -c RANK_CODE <cli args>): the
# `pipeline` verb through cli.main with CUDA events around each transport
# pass (product.run_freqs) on its stream and the host seconds spent in
# dist's collectives (waits for the other processes included), then one
# RESULT line
RANK_CODE = r"""
import hashlib, json, sys, time
import numpy as np
import torch
t0 = time.time()
from soc_tpu_torch import cli
from soc_tpu_torch.parallel import dist, product
from soc_tpu_torch.solve import a2e_kernel
real, spans = product.run_freqs, []
def run_freqs(*args, **kw):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = real(*args, **kw)
    ev[1].record()
    ev[1].synchronize()
    spans.append(ev[0].elapsed_time(ev[1]) / 1e3)
    return out
product.run_freqs = run_freqs
coll = [0.0]
def host_timed(fn):
    def call(*args, **kw):
        t = time.time()
        try:
            return fn(*args, **kw)
        finally:
            coll[0] += time.time() - t
    return call
for name in ("barrier", "gather_objects", "share", "broadcast", "move"):
    setattr(dist, name, host_timed(getattr(dist, name)))
results = {}
rc = cli.main(sys.argv[1:], results)
torch.cuda.synchronize()
a, m = results["absorption"], results["map"]
def digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]
bal = (a.absorbed_photons + a.escaped) / a.injected - 1.0
print("RESULT " + json.dumps(dict(
    rc=rc, rank=dist.process_index(), size=dist.process_count(),
    launches=a2e_kernel.launches, clamp=a2e_kernel.clamp_launches,
    absorbed=digest(a.absorbed), emitted=digest(results["emitted"]),
    balance=float(np.abs(bal).max()), spans=spans, collectives_s=coll[0],
    absorption_s=a.timings["constant_sources"], a2e_s=m.timings["a2e"],
    maps_s=m.timings["maps"], wall_s=time.time() - t0,
    foreign=sorted(k for k in sys.modules
                   if k.split(".")[0] in ("jax", "soc_tpu")))), flush=True)
"""
# phase 20: one process of the `sca` verb (python -c SCA_RANK_CODE <cli
# args>): its maps' sha256, its source passes' seconds and its wall time
SCA_RANK_CODE = r"""
import hashlib, json, sys, time
import numpy as np
import torch
t0 = time.time()
from soc_tpu_torch import cli
from soc_tpu_torch.parallel import dist
results = {}
rc = cli.main(sys.argv[1:], results)
torch.cuda.synchronize()
maps = np.ascontiguousarray(results["sca"])
print("RESULT " + json.dumps(dict(
    rc=rc, rank=dist.process_index(), size=dist.process_count(),
    maps=hashlib.sha256(maps.tobytes()).hexdigest()[:16],
    passes=[(p["source"], p["seconds"], p["packets"], p["events"])
            for p in results["sca_passes"]], wall_s=time.time() - t0,
    foreign=sorted(k for k in sys.modules
                   if k.split(".")[0] in ("jax", "soc_tpu")))), flush=True)
"""
SOURCES = ("a2e", "march", "probe_gather", "probe_scatter", "probe_onehot")
PROBE_KERNELS = {       # kernel -> (source, the Pallas call sites it replaces)
    "probe_gather": ("soc_tpu_torch/csrc/probe_gather.cu",
                     "scripts/probe_gather.py:111,:130,:148,:167,:186; "
                     "scripts/probe_gather2.py:102,:126,:152,:177; "
                     "scripts/gather_probe.py:74"),
    "probe_row_gather": ("soc_tpu_torch/csrc/probe_gather.cu",
                         "scripts/probe_gather2.py:204"),
    "probe_scatter": ("soc_tpu_torch/csrc/probe_scatter.cu",
                      "scripts/probe_gather.py:207; "
                      "scripts/probe_gather2.py:230"),
    "probe_onehot": ("soc_tpu_torch/csrc/probe_onehot.cu",
                     "scripts/probe_gather2.py:292,:332"),
}


def a2e_work(cells, nsize, ne, nf, clamp, align):
    """(float32 operations, bytes) of one A2E solve over all sizes: the
    function's work, counted once (an FMA counts 2, an add 1; the divides
    and the rescale, O(NE) a cell and size, are left out), whatever loops
    a kernel runs (a2e_all_sizes orders its sums otherwise, csrc/a2e.cu),
    so that the bounds of successive designs compare. Pre-folded
    solve, per cell and size: the bottom row NF*NE FMAs; substitution rows
    j = 1 .. NE-2, (NF + 1) FMAs and 1 subtraction for each l < j; the last
    row NE-1 FMAs; the emission NF*NE FMAs and NE adds. Exact (clamp)
    solve: (NF + 1) FMAs for each heating entry below the diagonal,
    NE(NE-1)/2 of them, and (NE-2)(NE-1)/2 adds of suffix sums, then the
    same emission. Bytes: each input read once and each output written
    once."""
    tri = (ne - 2) * (ne - 1) // 2
    if clamp:
        fma = (nf + 1) * ne * (ne - 1) // 2 + nf * ne
    else:
        fma = nf * ne + (nf + 1) * tri + (ne - 1) + nf * ne
    flops = cells * nsize * (2 * fma + tri + ne)
    words = (cells * nf + nsize * nf * ne * ne + nsize * ne + nsize * nf * ne
             + cells * nf)
    if align:
        words += nsize * cells + cells * nf
    return flops, 4 * words


def ptxas_kernels(log):
    """[(kernel, registers, bytes of spill stores and loads)] from nvcc's
    -Xptxas -v output, one entry per compiled kernel."""
    out = []
    for m in re.finditer(r"Function properties for (\S+)\s*\n\s*(\d+) "
                         r"bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads", log):
        regs = re.search(r"Used (\d+) registers", log[m.end():])
        out.append((m.group(1), int(regs.group(1)) if regs else -1,
                    int(m.group(3)) + int(m.group(4))))
    return out


def bound(flops, nbytes):
    """(least ms on the card, "bytes" or "operations"), at the H100's
    published peaks (probes.common.bound_seconds)."""
    from soc_tpu_torch.probes.common import bound_seconds
    seconds, by = bound_seconds(nbytes, flops)
    return 1e3 * seconds, by


def fail(msg):
    print("chip_smoke: FAILED: " + msg, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def read_cell_frequency_array(path):
    """[CELLS, NFREQ] float32 file with an int32 [CELLS, NFREQ] header."""
    raw = np.fromfile(path, np.float32)
    cells, nfreq = raw[:2].view(np.int32)
    return raw[2:].reshape(int(cells), int(nfreq))


def read_map_file(path):
    """map_dir_XX.bin: int32 [NX, NY] header, float32 [NF, NY, NX]."""
    raw = np.fromfile(path, np.float32)
    nx, ny = raw[:2].view(np.int32)
    return raw[2:].reshape(-1, int(ny), int(nx))


def timed(fn, reps):
    """(mean ms of ``reps`` calls after a warm-up call, CUDA events; the
    last output)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def max_rel(got, ref):
    """Largest relative error over the entries above 1e-6 of the maximum."""
    import torch
    sel = ref > 1e-6 * ref.max()
    return float((torch.abs(got - ref)[sel] / ref[sel]).max())


def kernel_phase(dev, work, rng, report):
    """Phase 3; returns {NE: (solver, frequencies)}, copies of the solvers
    taken before any A2E preparation was cached on them."""
    import torch
    from soc_tpu_torch.example_model import gset_solver, synthetic_absorbed
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 3: TF32 off for both (torch.backends.cuda.matmul."
          "allow_tf32 = %s, cudnn.allow_tf32 = %s)"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32), flush=True)
    ncmp = 4096
    fresh = {}
    for ne in (16, 48, 128, 256):
        sol, freq = gset_solver(work, nfreq=44, nsize=24, ne=ne)
        fresh[ne] = (copy.deepcopy(sol), freq)
        if not stochastic.fused_weights_nonneg(sol):
            fail("NE %d: negative heating weights" % ne)
        stacks = stochastic.get_fused_stacks(sol, dev, plain=True)
        ab = torch.as_tensor(synthetic_absorbed(rng, sol, freq, ncmp),
                             device=dev)
        align = torch.as_tensor(
            rng.uniform(0.0, 1.0, (sol.nsize, ncmp)).astype(np.float32),
            device=dev)
        tot_k, ptot_k = a2e_kernel.solve_all_sizes(stacks, ab, align)
        tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
        torch.cuda.synchronize()
        errs = []
        for k, p in ((tot_k, tot_p), (ptot_k, ptot_p)):
            if not bool(torch.isfinite(k).all()):
                fail("NE %d: kernel output not finite" % ne)
            errs.append(max_rel(k, p))
        print("phase 3: NE %3d  S %d  cells %d  max rel err tot %.3e  "
              "ptot %.3e  (tolerance %.0e)"
              % (ne, sol.nsize, ncmp, errs[0], errs[1], REL_TOL),
              flush=True)
        if max(errs) > REL_TOL:
            fail("NE %d: kernel differs from the plain twin" % ne)
        if ne == 128:
            full_sol, full_stacks = sol, stacks

    # the kernel's layout at the pipeline's shape
    tile, lc, warps = a2e_kernel.pick_fold_config(a2e_kernel._lib(), 44, 128,
                                                  dev.index or 0)
    c4 = -(-44 // 4)
    print("phase 3: a2e_all_sizes at NE 128, NFREQ 44: tile %d cells, %d "
          "columns staged at a time, %d resident warps per SM (at least "
          "%d); %d FMAs per %d shared loads a step over l (%.2f)"
          % (tile, lc, warps, a2e_kernel.MIN_WARPS, 4 * c4, c4 + 1,
             4 * c4 / (c4 + 1)), flush=True)
    if warps < a2e_kernel.MIN_WARPS:
        fail("a2e_all_sizes keeps %d warps per SM at the pipeline's shape"
             % warps)
    lib, index = a2e_kernel._lib(), dev.index or 0
    for kernel, name in (("fold", "a2e_all_sizes"), ("clamp", "a2e_clamp")):
        print("phase 3: %s takes, in %d bytes of shared memory a block: NE "
              "<= %d at NFREQ 1000; NFREQ <= %d at NE 256, <= %d at NE 32"
              % (name, a2e_kernel._smem_cap(lib, index),
                 a2e_kernel.shape_ceiling(lib, kernel, index, nfreq=1000),
                 a2e_kernel.shape_ceiling(lib, kernel, index, ne=256),
                 a2e_kernel.shape_ceiling(lib, kernel, index, ne=32)),
              flush=True)

    # timing at the pipeline's shape
    cells = 64 ** 3
    ab = torch.as_tensor(synthetic_absorbed(rng, full_sol, freq, cells),
                         device=dev)
    ms_k, (tot_k, _) = timed(
        lambda: a2e_kernel.solve_all_sizes(full_stacks, ab), 3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(full_stacks, ab), 1)
    rel = max_rel(tot_k, tot_p)
    abs_err = float(torch.abs(tot_k - tot_p).max())
    if rel > REL_TOL:
        fail("pipeline shape: kernel differs from the plain twin (%.3e)"
             % rel)
    b_ms, b_by = bound(*a2e_work(cells, full_sol.nsize, 128, 44, False,
                                 False))
    report["a2e_all_sizes"] = dict(ms=ms_k, plain_ms=ms_p,
                                   max_abs_err=abs_err, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None)
    print("phase 3: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " kernel %.2f ms, plain %.2f ms, bound %.2f ms (%s), max rel err "
          "%.3e, max abs err %.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, b_ms, b_by, rel, abs_err,
             float(tot_p.max()), report["card"]), flush=True)
    return fresh


def pipeline_phase(dev, work, args, report):
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.solve import a2e_kernel
    from soc_tpu_torch.pipeline import driver
    from soc_tpu_torch.transport import march_kernel
    from soc_tpu_torch.utils import trace
    n, lanes = N, driver.DEFAULT_LANES
    if args.bgpackets < FULL_BGPACKETS:
        print("phase 4: bgpackets cut from %d to %d"
              % (FULL_BGPACKETS, args.bgpackets), flush=True)
    ini = write_model(work, n, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets, map_dx=n / 64.0)
    results = {}
    a2e_kernel.launches = march_kernel.launches = 0
    t0 = time.time()
    trace.start()
    try:
        rc = cli.main(["pipeline", ini, "--device", str(dev)], results)
        torch.cuda.synchronize()
    finally:
        counters = trace.stop()["counters"]
    wall = time.time() - t0
    launches = a2e_kernel.launches
    if rc != 0:
        fail("pipeline verb returned %d" % rc)
    # one march_block a refill body, whether issued or a graph's replay
    marches = march_kernel.launches
    fused = counters.get("transport.blocks_fused", 0)
    eager = counters.get("transport.blocks_eager", 0)
    print("phase 4: march_block launches %d; refill bodies %d fused, %d "
          "eager" % (marches, fused, eager), flush=True)
    if marches != fused or fused < 1 or eager:
        fail("phase 4: %d march_block launches for %d fused and %d eager "
             "bodies" % (marches, fused, eager))
    report["march_block"] = dict(launches=marches)
    res_rt, res_map = results["absorption"], results["map"]
    report["a2e_all_sizes"]["launches"] = launches
    if launches < 1:
        fail("the pipeline did not launch the A2E kernel")
    cells = n ** 3
    absorbed = read_cell_frequency_array(os.path.join(work,
                                                      "absorbed.data"))
    emitted_f = read_cell_frequency_array(os.path.join(work, "emitted.data"))
    for name, a in (("absorbed.data", absorbed), ("emitted.data",
                                                  emitted_f)):
        if a.shape != (cells, 44):
            fail("%s has shape %s" % (name, a.shape))
        if not np.isfinite(a).all():
            fail("%s is not finite" % name)
    heated = absorbed.sum(1) > 0
    if not (emitted_f[heated].sum(1) > 0).all():
        fail("emitted is 0 in a cell with absorptions")
    maps = read_map_file(os.path.join(work, "map_dir_00.bin"))
    if not np.isfinite(maps).all() or maps.max() <= 0:
        fail("map_dir_00.bin is not finite with a positive peak")
    bal = (res_rt.absorbed_photons + res_rt.escaped) / res_rt.injected - 1
    print("phase 4: energy balance (absorbed+escaped)/injected-1 per "
          "frequency: max |.| = %.3e (tolerance %.1e)"
          % (np.abs(bal).max(), BALANCE_TOL), flush=True)
    if np.abs(bal).max() > BALANCE_TOL:
        fail("energy balance off")
    t_rt = res_rt.timings["constant_sources"]
    t_a2e = res_map.timings["a2e"]
    card = report["card"]
    print("phase 4: pipeline %d^3 cells, %d packets, lanes %d: absorption "
          "%.2f s (%.0f packets/s), A2E prep %.2f s, A2E solve %.2f s "
          "(%.0f cells/s), %d A2E launches, maps %.2f s, total %.2f s [%s]"
          % (n, res_rt.packets, lanes, t_rt, res_rt.packets / t_rt,
             res_map.timings["a2e_prep"], t_a2e, cells / t_a2e, launches,
             res_map.timings["maps"], wall, card), flush=True)
    report["stages"] = dict(absorption_s=t_rt, a2e_s=t_a2e,
                            maps_s=res_map.timings["maps"], total_s=wall,
                            packets=res_rt.packets)
    absorption_spread(dev, work, res_rt, lanes)
    return {"absorbed.data": absorbed, "emitted.data": emitted_f,
            "map_dir_00.bin": maps}


def absorption_spread(dev, work, first, lanes):
    """Phase 4: the pipeline's absorption stage run again on the same ini,
    seed and lane pool (no files written), its tallies held to the first
    run's ``first``: the same packets on the same streams, the card's
    atomic adds in another order."""
    import torch
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.pipeline import driver, full
    orig = os.getcwd()
    os.chdir(work)
    try:
        cfg = full.absorption_config(RunConfig("run.ini").validate())
        t0 = time.time()
        res = driver.run(cfg=cfg, device=dev, lanes=lanes, write_files=False,
                         workdir=work)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.chdir(orig)
    a = np.asarray(first.absorbed, np.float64)
    b = np.asarray(res.absorbed, np.float64)
    if b.shape != a.shape or res.packets != first.packets:
        fail("phase 4: the rerun traced %d packets into %s, the first %d "
             "into %s" % (res.packets, b.shape, first.packets, a.shape))
    peak = np.abs(a).max()
    diff = np.abs(b - a)
    big = np.abs(a) > 1e-3 * peak
    esc = np.abs(res.escaped - first.escaped) \
        / np.maximum(np.abs(first.escaped), 1e-300)
    ok = bool(np.isfinite(b).all()) and np.allclose(
        b, a, rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL * peak) \
        and np.allclose(res.escaped, first.escaped, rtol=PRODUCT_RTOL,
                        atol=0.0)
    print("phase 4: same-seed rerun of the absorption stage (%d packets, "
          "%d lanes) %.2f s: absorbed max |diff| / max = %.3e; largest "
          "relative difference over the entries above 1e-3 of the max = "
          "%.3e; entries that differ: %.4f%% of %d; escape totals "
          "(float64) largest relative difference %.3e; within rtol %.0e or "
          "%.0e of the max: %s"
          % (res.packets, lanes, wall, diff.max() / peak,
             (diff[big] / np.abs(a[big])).max(), 100 * (diff > 0).mean(),
             a.size, esc.max(), PRODUCT_RTOL, PRODUCT_ATOL, ok), flush=True)
    if not ok:
        fail("phase 4: the same-seed rerun of the absorption stage differs "
             "beyond the bound")


def rt_phase(dev, work):
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.io.cloud import read_hierarchy
    with open(os.path.join(work, "run.ini")) as fp:
        text = fp.read()
    text = text.replace("gs_TST.dust", "TST_simple.dust")
    ini = os.path.join(work, "rt.ini")
    with open(ini, "w") as fp:
        fp.write(text)
    for f in ("tmp.T", "map_dir_00.bin"):
        if os.path.exists(os.path.join(work, f)):
            os.remove(os.path.join(work, f))
    t0 = time.time()
    rc = cli.main(["rt", ini, "--device", str(dev)])
    torch.cuda.synchronize()
    if rc != 0:
        fail("rt verb returned %d" % rc)
    _, _, _, _, vals = read_hierarchy(os.path.join(work, "tmp.T"))
    t = np.concatenate(vals)
    if not (np.isfinite(t).all() and (t > 0).all()):
        fail("tmp.T is not finite and positive")
    maps = read_map_file(os.path.join(work, "map_dir_00.bin"))
    if not np.isfinite(maps).all():
        fail("rt map is not finite")
    print("phase 5: rt verb %.2f s, T %.2f-%.2f K (median %.2f), map peak "
          "%.3e" % (time.time() - t0, t.min(), t.max(), np.median(t),
                    maps.max()), flush=True)


def clamp_effect(stacks, fold_stacks, ab, ref):
    """(negative heating entries sum_f ABS W over all sizes, largest
    relative change of ``ref`` when the clamp is left out): the pre-folded
    kernel folds the weights before the product, so it cannot clamp."""
    import torch
    from soc_tpu_torch.solve import a2e_kernel
    nneg = sum(int((ab @ stacks.w_flat[s].T < 0).sum())
               for s in range(stacks.nsize))
    unclamped, _ = a2e_kernel.solve_all_sizes(fold_stacks, ab)
    return nneg, max_rel(torch.nan_to_num(unclamped, nan=float("inf")), ref)


def clamp_phase(dev, solvers, rng, report):
    """Phase 6: the exact (clamp) A2E kernel on inputs with a negative
    weight and negative absorbed values; ``solvers`` as phase 3 returns
    them."""
    import torch
    from soc_tpu_torch.example_model import (negate_one_weight,
                                             synthetic_absorbed,
                                             with_negative_entries)
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    ncmp = 4096
    for ne in (16, 48, 128, 256):
        sol, freq = solvers[ne]
        negate_one_weight(sol)
        if stochastic.fused_weights_nonneg(sol):
            fail("phase 6: NE %d: the negated weight was not seen" % ne)
        stacks = stochastic.get_fused_stacks(sol, dev, plain=True,
                                             clamp=True)
        ab_h = with_negative_entries(
            rng, synthetic_absorbed(rng, sol, freq, ncmp))
        ab = torch.as_tensor(ab_h, device=dev)
        align = torch.as_tensor(
            rng.uniform(0.0, 1.0, (sol.nsize, ncmp)).astype(np.float32),
            device=dev)
        tot_k, ptot_k = a2e_kernel.solve_all_sizes_clamp(stacks, ab, align)
        tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab, align)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(tot_k).all())
                and bool(torch.isfinite(ptot_k).all())):
            fail("phase 6: NE %d: clamp kernel output not finite" % ne)
        errs = [max_rel(tot_k, tot_p), max_rel(ptot_k, ptot_p)]
        nneg, effect = clamp_effect(
            stacks, stochastic.get_fused_stacks(sol, dev), ab, tot_p)
        print("phase 6: NE %3d  S %d  cells %d  (%.1f%% of absorbed < 0, "
              "%d heating entries < 0, unclamped differs by %.3e, at least "
              "%.0e) clamp kernel max rel err tot %.3e  ptot %.3e  "
              "(tolerance %.0e)" % (ne, sol.nsize, ncmp,
                                    100 * (ab_h < 0).mean(), nneg, effect,
                                    CLAMP_EFFECT, errs[0], errs[1], REL_TOL),
              flush=True)
        if nneg == 0 or not effect > CLAMP_EFFECT:
            fail("phase 6: NE %d: the clamp takes no effect on these inputs"
                 % ne)
        if max(errs) > REL_TOL:
            fail("phase 6: NE %d: clamp kernel differs from the plain twin"
                 % ne)
        if ne == 128:
            full_sol, full_freq = sol, freq

    # the path: solve_emission routes these inputs to the clamp kernel
    cells = 64 ** 3
    ab_h = with_negative_entries(
        rng, synthetic_absorbed(rng, full_sol, full_freq, cells))
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    t0 = time.time()
    emitted = stochastic.solve_emission(full_sol, ab_h, dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, folded = a2e_kernel.clamp_launches, a2e_kernel.launches
    if launches < 1 or folded != 0:
        fail("phase 6: solve_emission with negative inputs launched the "
             "clamp kernel %d and the pre-folded kernel %d times"
             % (launches, folded))
    if emitted.shape != (cells, 44) or not np.isfinite(emitted).all():
        fail("phase 6: solve_emission output not finite of shape %s"
             % (emitted.shape,))
    print("phase 6: solve_emission, %d cells with negative entries: %.2f s,"
          " %d clamp kernel launch(es), 0 pre-folded" % (cells, wall,
                                                        launches), flush=True)

    # the kernel's layout at the pipeline's shape
    tile, lr, warps = a2e_kernel.pick_clamp_config(a2e_kernel._lib(), 44, 128,
                                                   dev.index or 0)
    print("phase 6: a2e_clamp at NE 128, NFREQ 44: tile %d cells, %d rows "
          "staged at a time, %d resident warps per SM (at least %d)"
          % (tile, lr, warps, a2e_kernel.MIN_WARPS), flush=True)
    if warps < a2e_kernel.MIN_WARPS:
        fail("a2e_clamp keeps %d warps per SM at the pipeline's shape"
             % warps)

    # timing at the pipeline's shape
    stacks = stochastic.get_fused_stacks(full_sol, dev, plain=True,
                                         clamp=True)
    ab = torch.as_tensor(ab_h, device=dev)
    ms_k, (tot_k, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_clamp(stacks, ab), 3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, ab), 1)
    rel = max_rel(tot_k, tot_p)
    abs_err = float(torch.abs(tot_k - tot_p).max())
    if rel > REL_TOL:
        fail("phase 6: pipeline shape: clamp kernel differs from the plain "
             "twin (%.3e)" % rel)
    b_ms, b_by = bound(*a2e_work(cells, full_sol.nsize, 128, 44, True,
                                 False))
    report["a2e_clamp"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err,
                               launches=launches, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    print("phase 6: pipeline shape %d cells x %d sizes x NE 128 x NFREQ 44:"
          " clamp kernel %.2f ms, plain %.2f ms, bound %.2f ms (%s), max rel "
          "err %.3e, max abs err %.3e (max %.3e) [%s]"
          % (cells, full_sol.nsize, ms_k, ms_p, b_ms, b_by, rel, abs_err,
             float(tot_p.max()), report["card"]), flush=True)


def sharded_a2e_phase(dev, fold_sol, clamp_sol, freq, rng, report):
    """Phase 8: solve_emission split over shards against the one-launch
    solve, bit for bit, on both routes; fold_sol has non-negative weights,
    clamp_sol a negated one (phase 6's)."""
    import torch
    from soc_tpu_torch.example_model import (synthetic_absorbed,
                                             with_negative_entries)
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    cells = N ** 3
    card = report["card"]
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    shard_sets = [visible, [dev] * 2, [dev] * 3]
    ab_fold = synthetic_absorbed(rng, fold_sol, freq, cells)
    ab_clamp = with_negative_entries(
        rng, synthetic_absorbed(rng, clamp_sol, freq, cells))
    a = fold_sol.size_a
    aalg = rng.uniform(a.min(), a.max(), cells).astype(np.float32)
    for route, sol, ab in (("pre-folded", fold_sol, ab_fold),
                           ("clamp", clamp_sol, ab_clamp)):
        count = "clamp_launches" if route == "clamp" else "launches"
        t0 = time.time()
        one = stochastic.solve_emission(sol, ab, dev, aalg=aalg,
                                        devices=[dev])
        torch.cuda.synchronize()
        print("phase 8: %s route, one launch: solve_emission %.2f s [%s]"
              % (route, time.time() - t0, card), flush=True)
        for shards in shard_sets:
            a2e_kernel.launches = a2e_kernel.clamp_launches = 0
            t0 = time.time()
            got = stochastic.solve_emission(sol, ab, dev, aalg=aalg,
                                            devices=shards)
            torch.cuda.synchronize()
            wall = time.time() - t0
            n_sh = len(shards)
            # (this route's launches, the other route's)
            launched = (getattr(a2e_kernel, count),
                        a2e_kernel.launches + a2e_kernel.clamp_launches
                        - getattr(a2e_kernel, count))
            print("phase 8: %s route over %s: solve_emission %.2f s, %d "
                  "launches (%d shards), bit-equal to one launch: %s [%s]"
                  % (route, ",".join(str(d) for d in shards), wall,
                     launched[0], n_sh,
                     all(np.array_equal(x, y) for x, y in zip(got, one)),
                     card), flush=True)
            if launched != (n_sh, 0):
                fail("phase 8: %s route over %d shards launched %s"
                     % (route, n_sh, launched))
            if not all(np.array_equal(x, y) for x, y in zip(got, one)):
                fail("phase 8: %s route over %d shards differs from one "
                     "launch" % (route, n_sh))
            if not np.isfinite(got[0]).all():
                fail("phase 8: %s route: output not finite" % route)

    # the sharded kernel wrapper itself over phase 9's six shards, timed
    # beside the plain twin on the same inputs
    shards = [dev] * PRODUCT_SHARDS
    stacks = stochastic.get_fused_stacks(fold_sol, dev, plain=True)
    ab = torch.as_tensor(ab_fold, device=dev)
    align = torch.as_tensor(np.stack(
        [stochastic.alignment_weights(fold_sol, i, aalg)
         for i in range(fold_sol.nsize)]), device=dev)
    ms_k, (tot_k, ptot_k) = timed(
        lambda: a2e_kernel.solve_all_sizes_sharded(
            {dev: stacks}, ab, align, shards, False), 3)
    ms_p, (tot_p, ptot_p) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, ab, align), 1)
    rel = max(max_rel(tot_k, tot_p), max_rel(ptot_k, ptot_p))
    abs_err = float(max(torch.abs(tot_k - tot_p).max(),
                        torch.abs(ptot_k - ptot_p).max()))
    if rel > REL_TOL:
        fail("phase 8: the sharded solve differs from the plain twin (%.3e)"
             % rel)
    b_ms, b_by = bound(*a2e_work(cells, fold_sol.nsize, 128, 44, False,
                                 True))
    report["a2e_sharded"] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=abs_err,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None, shards=len(shards))
    print("phase 8: solve_all_sizes_sharded over cuda:0 x%d, %d cells x %d "
          "sizes x NE 128 x NFREQ 44 with the polarised sum: %.2f ms, plain "
          "%.2f ms, bound %.2f ms (%s), max rel err %.3e, max abs err %.3e "
          "[%s]" % (len(shards), cells, fold_sol.nsize, ms_k, ms_p, b_ms,
                    b_by, rel, abs_err, card), flush=True)


def product_phase(dev, work, args, report, ref):
    """Phase 9: the `devices N` path over cuda:0 six times (dp 3 x freq
    2), held to phase 4's one-device outputs ``ref``."""
    import torch
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.pipeline import driver, full
    from soc_tpu_torch.io.cloud import read_hierarchy
    from soc_tpu_torch.solve import a2e_kernel
    card = report["card"]
    sub = os.path.join(work, "devices")
    ini = write_model(sub, N, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets, map_dx=N / 64.0)
    # phase 4's A2E_pre output for the same dust, frequencies and NE: the
    # pipeline reuses a matching .solver file, as it would in phase 4's
    # directory
    shutil.copy(os.path.join(work, "gs_TST.solver"), sub)
    devices = [dev] * PRODUCT_SHARDS
    names = "%s x%d" % (dev, PRODUCT_SHARDS)
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    t0 = time.time()
    res_rt, _, res_map = full.run_pipeline(ini, dev, devices=devices)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    print("phase 9: pipeline over %s: absorption %.2f s (%d packets, %.0f "
          "packets/s), A2E solve %.2f s, maps %.2f s, total %.2f s; A2E "
          "launches: %d a2e_all_sizes, %d a2e_clamp [%s]"
          % (names, res_rt.timings["constant_sources"], res_rt.packets,
             res_rt.packets / res_rt.timings["constant_sources"],
             res_map.timings["a2e"], res_map.timings["maps"], wall,
             launches[0], launches[1], card), flush=True)
    from soc_tpu_torch.parallel.product import ProductMesh
    pm = ProductMesh(PRODUCT_SHARDS, 44, [dev] * PRODUCT_SHARDS)
    print("phase 9: mesh dp %d x freq %d; the 64-row map is %s"
          % (pm.n_dp, pm.n_freq, "split over the mesh" if 64 % pm.n_dp == 0
             else "rendered on one device (soc_tpu's rule splits rows only "
             "when dp divides them)"), flush=True)
    if launches != (PRODUCT_SHARDS, 0):
        fail("phase 9: expected one A2E launch per shard, got %s"
             % (launches,))
    report["a2e_sharded"]["launches"] = launches[0]
    report["stages_devices"] = dict(
        absorption_s=res_rt.timings["constant_sources"],
        a2e_s=res_map.timings["a2e"], maps_s=res_map.timings["maps"],
        total_s=wall)
    bal = (res_rt.absorbed_photons + res_rt.escaped) / res_rt.injected - 1
    print("phase 9: energy balance per frequency: max |.| = %.3e "
          "(tolerance %.1e)" % (np.abs(bal).max(), BALANCE_TOL), flush=True)
    if np.abs(bal).max() > BALANCE_TOL:
        fail("phase 9: energy balance off")
    readers = {"absorbed.data": read_cell_frequency_array,
               "emitted.data": read_cell_frequency_array,
               "map_dir_00.bin": read_map_file}
    for name, read in readers.items():
        got, want = read(os.path.join(sub, name)), ref[name]
        ok = got.shape == want.shape and np.isfinite(got).all() and \
            np.allclose(got, want, rtol=PRODUCT_RTOL,
                        atol=PRODUCT_ATOL * np.abs(want).max())
        err = float(np.abs(got - want).max() / np.abs(want).max()) \
            if got.shape == want.shape else float("inf")
        print("phase 9: %s against phase 4: max |diff| / max = %.3e, "
              "allclose(rtol %.0e, atol %.0e of the max): %s"
              % (name, err, PRODUCT_RTOL, PRODUCT_ATOL, ok), flush=True)
        if not ok:
            fail("phase 9: %s differs from the one-device run" % name)

    # the rt verb's path over the same mesh, one packet batch per surface
    # element
    with open(ini) as fp:
        text = fp.read()
    batch = 8 * 6 * N * N
    text = re.sub(r"(?m)^bgpackets\s+\d+", "bgpackets %d" % batch,
                  text.replace("gs_TST.dust", "TST_simple.dust"))
    rt_ini = os.path.join(sub, "rt.ini")
    with open(rt_ini, "w") as fp:
        fp.write(text)
    print("phase 9: rt: bgpackets cut from %d to %d (one batch per "
          "surface element)" % (args.bgpackets, batch), flush=True)
    t0 = time.time()
    res = driver.run(rt_ini, device=dev, devices=devices)
    torch.cuda.synchronize()
    _, _, _, _, vals = read_hierarchy(os.path.join(sub, "tmp.T"))
    t = np.concatenate(vals)
    bal = (res.absorbed_photons + res.escaped) / res.injected - 1
    if not (np.isfinite(t).all() and (t > 0).all()) \
            or np.abs(bal).max() > BALANCE_TOL:
        fail("phase 9: rt over the mesh: T not finite and positive, or "
             "energy balance off")
    print("phase 9: rt over %s: %.2f s, %d packets, T %.2f-%.2f K, "
          "energy balance %.3e [%s]"
          % (names, time.time() - t0, res.packets, t.min(), t.max(),
             np.abs(bal).max(), card), flush=True)


def print_passes(tag, res, card):
    """Phase 10: each cell pass of an rt run: its seconds, packets/s and
    energy balance; fails beyond BALANCE_TOL."""
    from soc_tpu_torch.pipeline import driver
    for st in res.cell_passes:
        bal = np.abs(driver.pass_balance(st)).max()
        print("phase 10: (%s) iteration %d cell pass, %s route: %d packets "
              "in %d pool(s), %.2f s (%.0f packets/s), energy balance per "
              "channel (signed sums) max |.| = %.3e (tolerance %.1e) [%s]"
              % (tag, st["iteration"], st["route"], st["packets"],
                 st["pools"], st["seconds"], st["packets"] / st["seconds"],
                 bal, BALANCE_TOL, card), flush=True)
        if not bal <= BALANCE_TOL:
            fail("phase 10: (%s) cell pass of iteration %d: energy balance "
                 "off" % (tag, st["iteration"]))


def octree_rt_phase(dev, work, args, report):
    """Phase 10: the rt verb on the octree at full width, three runs, then
    one cell pass without and with ALI. Returns the three runs' RunResults
    by tag."""
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.pipeline import driver
    card = report["card"]
    runs = {"a": ("", 3, CELLPACKETS),
            "b": ("ali 1\nreference 1\n", 3, CELLPACKETS),
            "c": ("emweight 1\n", 2, EMWEI_PACKETS)}
    # (a) keeps its constant-source heating (phase 14 (c) loads it too);
    # (b) and (c) load it: the same packets, not traced again
    ctabs = os.path.join(work, "octree_rt_a", "ctabs.save")
    out = {}
    for tag, (extra, iters, clpac) in runs.items():
        d = os.path.join(work, "octree_rt_" + tag)
        ini = write_model(d, N, kind="eqdust", nfreq=44, npix=64,
                          bgpac=args.bgpackets, map_dx=N / 64.0,
                          octree=OCTREE, cellpackets=clpac,
                          iterations=iters,
                          extra=extra + ("csave ctabs.save\n" if tag == "a"
                                         else "cload %s\n" % ctabs))
        results = {}
        t0 = time.time()
        rc = cli.main(["rt", ini, "--device", str(dev)], results)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if rc != 0:
            fail("phase 10: (%s) rt verb returned %d" % (tag, rc))
        res = out[tag] = results["rt"]
        if res.devices is not None or any(st["mesh"]
                                          for st in res.cell_passes):
            fail("phase 10: (%s) ran over a mesh, not on one card" % tag)
        if res.grid.cells != OCTREE_CELLS or res.grid.levels != 3:
            fail("phase 10: (%s) the grid has %d cells on %d levels"
                 % (tag, res.grid.cells, res.grid.levels))
        for name in ("absorbed", "temperature", "emitted"):
            if not np.isfinite(getattr(res, name)).all():
                fail("phase 10: (%s) %s is not finite" % (tag, name))
        if not (np.isfinite(res.maps[0]).all() and res.maps[0].max() > 0):
            fail("phase 10: (%s) the map is not finite with a positive peak"
                 % tag)
        if len(res.cell_passes) != iters - 1:
            fail("phase 10: (%s) %d cell passes for %d iterations"
                 % (tag, len(res.cell_passes), iters))
        tm = res.timings
        bg = ("background %.2f (%d packets, %.0f packets/s)"
              % (tm["constant_sources"], res.packets,
                 res.packets / tm["constant_sources"]) if tag == "a"
              else "background loaded from (a)'s csave")
        print("phase 10: (%s) rt on the octree (%d cells, %s, iterations %d"
              ", cellpackets %d): %.2f s: input %.2f, %s, iterations "
              "%.2f, outputs %.2f, maps %.2f; T %.2f-%.2f K [%s]"
              % (tag, res.grid.cells, extra.strip().replace("\n", ", ")
                 or "plain", iters, clpac, wall, tm["input"], bg,
                 tm["solve"], tm["outputs"], tm["maps"],
                 res.temperature.min(), res.temperature.max(), card),
              flush=True)
        print_passes(tag, res, card)
    leaf = out["a"].grid.dens.cpu().numpy() > 0
    rel = (np.abs(out["b"].temperature - out["a"].temperature)
           / out["a"].temperature)[leaf]
    beyond = int((rel > ITER_RTOL).sum())
    print("phase 10: (b) ali + reference against (a): temperatures' "
          "relative difference over the %d leaf cells: max %.3e, 99.9th "
          "percentile %.3e, %d cells beyond %.0e (at most %.0e of them, "
          "%d), none beyond %.0e"
          % (rel.size, rel.max(), np.percentile(rel, 99.9), beyond,
             ITER_RTOL, ITER_SHARE, int(ITER_SHARE * rel.size), ITER_MAX),
          flush=True)
    if beyond > ITER_SHARE * rel.size or not rel.max() <= ITER_MAX:
        fail("phase 10: (b)'s temperatures differ from (a)'s")
    report["octree_rt"] = {tag: dict(
        seconds=r.timings["total"],
        passes=[(st["route"], st["packets"], st["seconds"])
                for st in r.cell_passes]) for tag, r in out.items()}

    # one cell pass without and with ALI: the same packets, so the ALI
    # split must add up to the plain tally; one packet a cell and channel
    # (the gate does not depend on the count)
    res = out["a"]
    orig = os.getcwd()
    os.chdir(os.path.join(work, "octree_rt_a"))
    try:
        cfg = RunConfig("run.ini").validate()
    finally:
        os.chdir(orig)
    cfg.clpac = OCTREE_CELLS
    emitted = torch.as_tensor(res.emitted, device=dev)
    tabs = {}
    for ali in (0, 1):
        cfg.with_ali = ali
        t, _, _, xab, st = driver.simulate_cell_emission(
            res.grid, res.medium, cfg, emitted,
            torch.zeros(res.grid.cells, device=dev),
            torch.zeros((res.grid.cells, 44), device=dev), res.seed,
            per_freq_tally=True, iteration=9)
        torch.cuda.synchronize()
        tabs[ali] = (t.cpu().numpy().astype(np.float64), xab)
        print("phase 10: cell pass %s ALI: %s route, %d packets in %d "
              "pool(s), %.2f s (%.0f packets/s) [%s]"
              % ("with" if ali else "without", st["route"], st["packets"],
                 st["pools"], st["seconds"], st["packets"] / st["seconds"],
                 card), flush=True)
    plain, (t_ali, xab) = tabs[0][0], tabs[1]
    both = t_ali + xab.astype(np.float64)
    share = xab.sum() / plain.sum()
    ok = np.allclose(both, plain, rtol=PRODUCT_RTOL,
                     atol=PRODUCT_ATOL * np.abs(plain).max())
    print("phase 10: tabs_ali + xab against tabs_noali: max |diff| / max = "
          "%.3e, within rtol %.0e or %.0e of the max: %s; xab share of the "
          "absorbed %.4f" % (np.abs(both - plain).max() / np.abs(plain).max(),
                             PRODUCT_RTOL, PRODUCT_ATOL, ok, share),
          flush=True)
    if not ok or not 0.0 < share < 1.0:
        fail("phase 10: the ALI split does not add up to the plain pass")
    return out


def octree_pipeline_phase(dev, work, args, report):
    """Phase 11: the pipeline verb on the octree with the GSET dust, then
    the A2E kernel on its absorptions against the plain twin."""
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    from soc_tpu_torch.solve.solver_file import read_solver
    card = report["card"]
    sub = os.path.join(work, "octree_pipeline")
    # a quarter of the background's packets since phase 16 runs: every
    # gate here (the balance, the launch, the parents' rows, the kernel
    # against its twin) holds for any count
    ini = write_model(sub, N, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets // 4, map_dx=N / 64.0,
                      octree=OCTREE)
    # phase 4's A2E_pre output for the same dust, channels and NE
    shutil.copy(os.path.join(work, "gs_TST.solver"), sub)
    results = {}
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    t0 = time.time()
    rc = cli.main(["pipeline", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    if rc != 0:
        fail("phase 11: pipeline verb returned %d" % rc)
    res_rt, res_map = results["absorption"], results["map"]
    if launches != (torch.cuda.device_count(), 0):
        fail("phase 11: A2E launches %s, expected one a card" % (launches,))
    absorbed = read_cell_frequency_array(os.path.join(sub, "absorbed.data"))
    emitted = read_cell_frequency_array(os.path.join(sub, "emitted.data"))
    maps = read_map_file(os.path.join(sub, "map_dir_00.bin"))
    parents = absorbed[:, 0] < -1e19
    if absorbed.shape != (OCTREE_CELLS, 44) or \
            int(parents.sum()) != OCTREE_PARENTS:
        fail("phase 11: absorbed.data has shape %s with %d parent rows"
             % (absorbed.shape, int(parents.sum())))
    if not (np.isfinite(emitted).all() and (emitted[parents] == 0).all()
            and emitted[~parents].max() > 0):
        fail("phase 11: emitted.data not finite, or not zero on the parents")
    if not (np.isfinite(maps).all() and maps.max() > 0):
        fail("phase 11: the map is not finite with a positive peak")
    bal = (res_rt.absorbed_photons + res_rt.escaped) / res_rt.injected - 1
    if np.abs(bal).max() > BALANCE_TOL:
        fail("phase 11: energy balance off")
    t_rt = res_rt.timings["constant_sources"]
    print("phase 11: pipeline on the octree (%d cells, %d parents): "
          "absorption %.2f s (%d packets, %.0f packets/s), A2E prep %.2f s "
          "(.solver reused), A2E solve %.2f s, %d A2E launch(es), maps %.2f "
          "s, total %.2f s; energy balance %.3e; emitted zero on the "
          "parents [%s]" % (OCTREE_CELLS, OCTREE_PARENTS, t_rt,
                            res_rt.packets, res_rt.packets / t_rt,
                            res_map.timings["a2e_prep"],
                            res_map.timings["a2e"], launches[0],
                            res_map.timings["maps"], wall, np.abs(bal).max(),
                            card), flush=True)
    report["stages_octree"] = dict(absorption_s=t_rt,
                                   a2e_s=res_map.timings["a2e"],
                                   maps_s=res_map.timings["maps"],
                                   total_s=wall, packets=res_rt.packets)

    # the kernel at this shape: the run's absorptions, parent rows zero
    sol = read_solver(os.path.join(sub, "gs_TST.solver"))
    stacks = stochastic.get_fused_stacks(sol, dev, plain=True)
    ab = torch.as_tensor(np.where(parents[:, None], 0.0, absorbed)
                         .astype(np.float32), device=dev)
    ms_k, (tot_k, _) = timed(lambda: a2e_kernel.solve_all_sizes(stacks, ab),
                             3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, ab), 1)
    rel = max_rel(tot_k, tot_p)
    if rel > REL_TOL:
        fail("phase 11: the A2E kernel differs from the plain twin (%.3e)"
             % rel)
    b_ms, b_by = bound(*a2e_work(OCTREE_CELLS - OCTREE_PARENTS, sol.nsize,
                                 sol.ne, 44, False, False))
    report["a2e_all_sizes"].update(
        octree_launches=launches[0], octree_ms=ms_k, octree_plain_ms=ms_p,
        octree_bound_ms=b_ms, octree_max_abs_err=float(
            torch.abs(tot_k - tot_p).max()))
    print("phase 11: a2e_all_sizes on the octree's absorptions (%d cells, "
          "%d of them parents with zero rows; bound over the %d leaves): "
          "kernel %.2f ms, plain %.2f ms, bound %.2f ms (%s), max rel err "
          "%.3e [%s]" % (OCTREE_CELLS, OCTREE_PARENTS,
                         OCTREE_CELLS - OCTREE_PARENTS, ms_k, ms_p, b_ms,
                         b_by, rel, card), flush=True)


def source_balance(tag, res, card, phase="phase 12"):
    """Phase 12 (and 13): each phase-1 source's packets, seconds and
    clones, and the run's energy balance per channel, (absorbed + escaped
    + born outside) / launched - 1, over the channels that launched
    anything; fails beyond BALANCE_TOL. Returns the balance."""
    for st in res.source_passes:
        print(phase + ": (%s) %s: %d packets in %d pool(s), %.2f s (%.0f "
              "packets/s), %d clones served, absorbed energy %.4e [%s]"
              % (tag, st["source"], st["packets"], st["pools"],
                 st["seconds"], st["packets"] / max(st["seconds"], 1e-9),
                 st["clones"], st["absorbed_energy"], card), flush=True)
    on = res.launched > 0
    bal = np.zeros_like(res.launched)
    bal[on] = (res.absorbed_photons + res.escaped + res.missed)[on] \
        / res.launched[on] - 1
    print(phase + ": (%s) energy balance per channel over %d channels, "
          "(absorbed + escaped + born outside) / launched - 1: max |.| = "
          "%.3e (tolerance %.1e); born outside %.3e of the launched weight"
          % (tag, int(on.sum()), np.abs(bal).max(), BALANCE_TOL,
             res.missed.sum() / res.launched.sum()), flush=True)
    if not np.abs(bal).max() <= BALANCE_TOL:
        fail(phase + ": (%s) energy balance off" % tag)
    return bal


def sources_phase(dev, work, args, report, plain_bg):
    """Phase 12: the constant sources on the octree; ``plain_bg`` is
    phase 10 (a)'s run (its background without splitting)."""
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.constants import FACTOR, PARSEC, PLANCK
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.solve import a2e_kernel, equilibrium, stochastic
    from soc_tpu_torch.solve.solver_file import read_solver
    card = report["card"]
    common = dict(npix=64, bgpac=args.bgpackets, map_dx=N / 64.0,
                  octree=OCTREE)

    # (a) config 2 whole: split background + two point sources, rt
    d = os.path.join(work, "sources_rt")
    ini = write_model(d, N, kind="eqdust", nfreq=44,
                      point_sources=POINT_SOURCES, ps_method=PS_METHOD,
                      pspackets=PSPACKETS, split=SPLIT, **common)
    results = {}
    t0 = time.time()
    rc = cli.main(["rt", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if rc != 0:
        fail("phase 12: (a) rt verb returned %d" % rc)
    res = results["rt"]
    for name in ("absorbed", "temperature", "emitted"):
        if not np.isfinite(getattr(res, name)).all():
            fail("phase 12: (a) %s is not finite" % name)
    if not (np.isfinite(res.maps[0]).all() and res.maps[0].max() > 0):
        fail("phase 12: (a) the map is not finite with a positive peak")
    passes = {st["source"]: st for st in res.source_passes}
    if sorted(passes) != ["bg", "ps"]:
        fail("phase 12: (a) sources run: %s" % sorted(passes))
    tm = res.timings
    print("phase 12: (a) rt on the octree with the split background and %d "
          "point sources (PS_METHOD %d): %.2f s: input %.2f, constant "
          "sources %.2f (%d packets), solve %.2f, maps %.2f; T %.2f-%.2f K "
          "[%s]" % (len(POINT_SOURCES), PS_METHOD, wall, tm["input"],
                    tm["constant_sources"], res.packets, tm["solve"],
                    tm["maps"], res.temperature.min(),
                    res.temperature.max(), card), flush=True)
    source_balance("a", res, card)
    bg, ps = passes["bg"], passes["ps"]
    if bg["clones"] < 1:
        fail("phase 12: (a) the split background served no clone")
    inj_bg = np.abs(bg["launched"] / bg["injected"] - 1).max()
    share = ps["absorbed_energy"] / float(res.ctabs.astype(np.float64).sum())
    print("phase 12: (a) background launched against its injected weight: "
          "max |.| = %.3e; point sources' share of the absorbed energy %.4f"
          % (inj_bg, share), flush=True)
    if inj_bg > 1e-6 or not 0.0 < share < 1.0:
        fail("phase 12: (a) the sources' weights are off")
    # the refined leaves' absorption from the background, with and
    # without splitting: the same packet streams, so the difference is
    # the clones' sampling noise; its bound is taken from the spread of
    # the differences over 64 groups of cells
    lev = equilibrium.cell_levels(res.grid).cpu().numpy()
    leaf = res.grid.dens.cpu().numpy() > 0
    refined = np.nonzero((lev > 0) & leaf)[0]
    diff = bg["tabs"][refined].astype(np.float64) \
        - plain_bg.ctabs[refined].astype(np.float64)
    groups = np.array([g.sum() for g in np.array_split(diff, 64)])
    sigma = np.sqrt(np.sum(groups ** 2))
    ref = plain_bg.ctabs[refined].astype(np.float64).sum()
    print("phase 12: (a) the %d refined leaves' absorbed energy from the "
          "background, split against phase 10 (a)'s unsplit: %.6e against "
          "%.6e, difference %.3e of it; bound %.1f sigma = %.3e of it "
          "(sigma from 64 groups of cells)"
          % (len(refined), ref + diff.sum(), ref, diff.sum() / ref,
             SPLIT_SIGMAS, SPLIT_SIGMAS * sigma / ref), flush=True)
    if not abs(diff.sum()) <= SPLIT_SIGMAS * sigma:
        fail("phase 12: (a) the split background's refined cells disagree "
             "with the unsplit run beyond the statistical bound")
    report["sources_rt"] = dict(
        seconds=wall, clones=bg["clones"],
        passes={k: (v["packets"], v["seconds"]) for k, v in passes.items()})

    # (b) the pipeline with the split background, the weighted sky, a
    # diffuse field and saveint 2
    sub = os.path.join(work, "sources_pipeline")
    # a fifth of the background's packets and a quarter of the sky's:
    # the gates (balance, the intensity identity, the parents, the A2E
    # launch) hold for any count, and the cut keeps the smoke under 800 s
    # now that phase 15 runs
    ini = write_model(sub, N, kind="gset", nfreq=44, nsize=24,
                      hpbg=SKY_NSIDE, hpbg_weighted=True,
                      diffuse=DIFFUSE_SHARE, dfpackets=OCTREE_CELLS,
                      split=SPLIT, saveint=2,
                      **dict(common, bgpac=args.bgpackets // 4))
    shutil.copy(os.path.join(work, "gs_TST.solver"), sub)
    results = {}
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    t0 = time.time()
    rc = cli.main(["pipeline", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    if rc != 0:
        fail("phase 12: (b) pipeline verb returned %d" % rc)
    if launches != (torch.cuda.device_count(), 0):
        fail("phase 12: (b) A2E launches %s, expected one a card"
             % (launches,))
    res_rt, res_map = results["absorption"], results["map"]
    passes = {st["source"]: st for st in res_rt.source_passes}
    if sorted(passes) != ["bg", "diffuse", "hpbg"]:
        fail("phase 12: (b) sources run: %s" % sorted(passes))
    source_balance("b", res_rt, card)
    if passes["bg"]["clones"] < 1 or passes["hpbg"]["clones"] < 1:
        fail("phase 12: (b) a split source served no clone")
    absorbed = read_cell_frequency_array(os.path.join(sub, "absorbed.data"))
    emitted = read_cell_frequency_array(os.path.join(sub, "emitted.data"))
    maps = read_map_file(os.path.join(sub, "map_dir_00.bin"))
    with open(os.path.join(sub, "ISRF.DAT"), "rb") as fp:
        shape = tuple(np.fromfile(fp, np.int32, 3))
        inten = np.fromfile(fp, np.float32)
    parents = absorbed[:, 0] < -1e19
    if shape != (OCTREE_CELLS, 44, 4) or inten.size != np.prod(shape) \
            or not np.isfinite(inten).all():
        fail("phase 12: (b) the intensity file has shape %s and is not "
             "finite" % (shape,))
    inten = inten.reshape(shape)
    # I = (PLANCK f / ABS_f) 8^level INT / DENS and absorbed = FACTOR /
    # gl_cm 8^level INT / DENS: their ratio is PLANCK f gl_cm / (ABS_f
    # FACTOR) on every leaf
    gl_cm = 0.01 * PARSEC
    absf = res_rt.medium.abs_gl.cpu().numpy().astype(np.float64)
    ratio = PLANCK * res_rt.freq * gl_cm / (absf * FACTOR)
    live = ~parents[:, None] & (absorbed > 1e-30 * absorbed.max())
    got = inten[:, :, 0].astype(np.float64) / np.where(live, absorbed, 1.0)
    irel = np.abs(got / ratio[None, :] - 1)[live].max()
    if not irel <= 1e-5:
        fail("phase 12: (b) the intensity's I is not the absorbed file's "
             "scaling (%.3e)" % irel)
    if not (np.isfinite(emitted).all() and (emitted[parents] == 0).all()
            and emitted[~parents].max() > 0):
        fail("phase 12: (b) emitted.data not finite, or not zero on the "
             "parents")
    if not (np.isfinite(maps).all() and maps.max() > 0):
        fail("phase 12: (b) the map is not finite with a positive peak")
    t_rt = res_rt.timings["constant_sources"]
    print("phase 12: (b) pipeline on the octree with the split background, "
          "the weighted sky (nside %d), a diffuse field and saveint 2: "
          "absorption %.2f s (%d packets, %.0f packets/s), A2E solve %.2f "
          "s, %d A2E launch(es), maps %.2f s, total %.2f s; intensity I "
          "against the absorbed file's scaling %.3e; emitted zero on the "
          "parents [%s]" % (SKY_NSIDE, t_rt, res_rt.packets,
                            res_rt.packets / t_rt, res_map.timings["a2e"],
                            launches[0], res_map.timings["maps"], wall, irel,
                            card), flush=True)
    sol = read_solver(os.path.join(sub, "gs_TST.solver"))
    stacks = stochastic.get_fused_stacks(sol, dev, plain=True)
    ab = torch.as_tensor(np.where(parents[:, None], 0.0, absorbed)
                         .astype(np.float32), device=dev)
    ms_k, (tot_k, _) = timed(lambda: a2e_kernel.solve_all_sizes(stacks, ab),
                             3)
    ms_p, (tot_p, _) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, ab), 1)
    rel = max_rel(tot_k, tot_p)
    if rel > REL_TOL:
        fail("phase 12: (b) the A2E kernel differs from the plain twin "
             "(%.3e)" % rel)
    b_ms, b_by = bound(*a2e_work(OCTREE_CELLS - OCTREE_PARENTS, sol.nsize,
                                 sol.ne, 44, False, False))
    report["a2e_all_sizes"].update(
        sources_launches=launches[0], sources_ms=ms_k,
        sources_plain_ms=ms_p, sources_bound_ms=b_ms,
        sources_max_abs_err=float(torch.abs(tot_k - tot_p).max()))
    print("phase 12: (b) a2e_all_sizes on these absorptions (%d cells): "
          "kernel %.2f ms, plain %.2f ms, bound %.2f ms (%s), max rel err "
          "%.3e [%s]" % (OCTREE_CELLS, ms_k, ms_p, b_ms, b_by, rel, card),
          flush=True)
    report["sources_pipeline"] = dict(
        seconds=wall, absorption_s=t_rt, packets=res_rt.packets,
        passes={k: (v["packets"], v["seconds"], v["clones"])
                for k, v in passes.items()})

    # (c) two dusts with per-cell abundances and MSF, half the channels, at
    # three batches of the background (three fifths of the packets): both
    # runs trace the same packets, so their 1% bound holds with room (2.8e-3
    # at five batches), and the cut keeps the smoke under 800 s
    temps = {}
    for half in (False, True):
        d = os.path.join(work, "sources_abu_%d" % half)
        ini = write_model(d, N, kind="eqdust", nfreq=44, abundance=True,
                          simum=SIMUM, optishalf=half,
                          **dict(common, bgpac=args.bgpackets // 2))
        results = {}
        t0 = time.time()
        rc = cli.main(["rt", ini, "--device", str(dev)], results)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if rc != 0:
            fail("phase 12: (c) rt verb returned %d" % rc)
        res = results["rt"]
        masked = res.launched == 0
        if not (np.isfinite(res.temperature).all()
                and np.isfinite(res.maps[0]).all()):
            fail("phase 12: (c) the temperatures or the map are not finite")
        if masked.sum() < 10 or (~masked).sum() < 10 \
                or (res.absorbed_photons[masked] != 0).any() \
                or (res.absorbed[:, masked] > 0).any():
            fail("phase 12: (c) a channel outside `simum` absorbed energy, "
                 "or the band is not about half the channels")
        tag = "c, optishalf" if half else "c"
        source_balance(tag, res, card)
        print("phase 12: (%s) rt with two dusts, abundances and MSF over %d "
              "of 44 channels: %.2f s (%d packets, constant sources %.2f "
              "s), T %.2f-%.2f K [%s]"
              % (tag, int((~masked).sum()), wall, res.packets,
                 res.timings["constant_sources"], res.temperature.min(),
                 res.temperature.max(), card), flush=True)
        temps[half] = res.temperature
    trel = np.abs(temps[True] / temps[False] - 1).max()
    print("phase 12: (c) optishalf against float32 cross sections: "
          "temperatures' largest relative difference %.3e (bound %.0e)"
          % (trel, OPTISHALF_TOL), flush=True)
    if not trel <= OPTISHALF_TOL:
        fail("phase 12: (c) optishalf moves the temperatures too far")
    report["sources_abu"] = dict(optishalf_rel=trel)


def weight_readings(t, ref, absorbed, absorbed_ref, leaf, lev, lit,
                    rtol=0.05):
    """Phase 13 (c1)'s readings of a run (temperatures t, absorbed file)
    against a reference run: dict of the largest |relative difference| of
    a lit channel's absorption over the leaf cells (``channel``), the leaf
    cells' mean |relative temperature difference| (``mean_abs``), the
    largest |signed mean| of one level's leaf cells (``level_mean``, with
    each level's in ``levels``) and the share of leaf cells beyond rtol
    (``beyond``)."""
    rel = (np.asarray(t, np.float64) / ref - 1.0)
    wa = np.asarray(absorbed, np.float64)[leaf].sum(0)
    aa = np.asarray(absorbed_ref, np.float64)[leaf].sum(0)
    levels = [float(rel[leaf & (lev == k)].mean())
              for k in range(int(lev.max()) + 1) if (leaf & (lev == k)).any()]
    r = rel[leaf]
    return dict(channel=float(np.abs(wa[lit] / aa[lit] - 1.0).max()),
                mean_abs=float(np.abs(r).mean()),
                level_mean=float(np.abs(levels).max()), levels=levels,
                beyond=float((np.abs(r) > rtol).mean()))


def _variant(ini, name, subs=(), add=""):
    """A second ini beside ``ini`` (the same model files), named name.ini,
    with the (old, new) line substitutions ``subs`` and the lines ``add``;
    its output files carry the name, so runs in one directory keep theirs
    apart. Returns its path."""
    with open(ini) as fp:
        text = fp.read()
    for old, new in subs:
        if old not in text:
            fail("%r is not in %s" % (old, ini))
        text = text.replace(old, new)
    for old, new in (("absorbed.data", ".absorbed"),
                     ("emitted.data", ".emitted"), ("tmp.T", ".T")):
        text = text.replace(old, name + new)
    path = os.path.join(os.path.dirname(ini), name + ".ini")
    with open(path, "w") as fp:
        fp.write(text + add)
    return path


def _rt(dev, ini, tag, card, phase="phase 13"):
    """The rt verb (cli.main) on ini: (RunResult, wall seconds)."""
    import torch
    from soc_tpu_torch import cli
    results = {}
    t0 = time.time()
    rc = cli.main(["rt", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if rc != 0:
        fail(phase + ": (%s) rt verb returned %d" % (tag, rc))
    res = results["rt"]
    tm = res.timings
    print(phase + ": (%s) rt %.2f s: constant sources %.2f s (%d packets, "
          "%.0f packets/s), solve %.2f s, maps %.2f s [%s]"
          % (tag, wall, tm.get("constant_sources", 0.0), res.packets,
             res.packets / max(tm.get("constant_sources", 0.0), 1e-9),
             tm.get("solve", 0.0), tm.get("maps", 0.0), card), flush=True)
    for st in res.source_passes:
        print(phase + ": (%s) %s: %d packets in %d pool(s), %.2f s (%.0f "
              "packets/s), %d clones [%s]"
              % (tag, st["source"], st["packets"], st["pools"],
                 st["seconds"], st["packets"] / max(st["seconds"], 1e-9),
                 st["clones"], card), flush=True)
    for rp in res.render_passes:
        print(phase + ": (%s) render %s: %.3f s, %d rays, %d march steps "
              "[%s]" % (tag, rp["render"], rp["seconds"], rp["rays"],
                        rp["steps"], card), flush=True)
    return res, wall


def slice_phase(dev, work, args, report, plain_bg=None):
    """Phase 13: ROI save and load, mmapabs, the weighting, mirrored faces
    and the render suite on BASELINE config 2's octree (see the module
    docstring); ``plain_bg``, phase 10 (a)'s run, gives the background's
    time without the ROI save."""
    from soc_tpu_torch.example_model import (frequencies, write_model,
                                             write_point_sources)
    from soc_tpu_torch.io.fits import read_fits_image
    from soc_tpu_torch.pipeline import driver
    from soc_tpu_torch.solve import equilibrium
    from soc_tpu_torch.transport.roi import read_roi_file, roi_cell_mask
    card = report["card"]
    out = report["slice"] = {}
    d = os.path.join(work, "slice")
    box = "roi %d %d %d %d %d %d\n" % ROI_BOX
    base = write_model(d, N, kind="eqdust", nfreq=44, npix=64,
                       bgpac=args.bgpackets, map_dx=N / 64.0, octree=OCTREE)
    ps_lines = write_point_sources(d, frequencies(44), 0.01, 6 * N * N,
                                   POINT_SOURCES)

    # (a) the ROI save with mmapabs, four device blocks of 11 channels
    ini_a = _variant(base, "a", add=box + "roisave roi.bin 1\nroinside %d\n"
                     "mmapabs\n" % ROI_NSIDE)
    os.environ["SOC_TPU_TALLY_BYTES"] = str(OCTREE_CELLS * 4 * MMAP_BLOCK)
    try:
        res_a, wall = _rt(dev, ini_a, "a", card)
    finally:
        del os.environ["SOC_TPU_TALLY_BYTES"]
    out["a"] = wall
    blocks = [st["pools"] for st in res_a.source_passes]
    if blocks != [-(-44 // MMAP_BLOCK)]:
        fail("phase 13: (a) mmapabs ran %s pools, expected one a block of "
             "%d channels" % (blocks, MMAP_BLOCK))
    rnx, rny, rnz, nside, tally = read_roi_file(os.path.join(d, "roi.bin"))
    inj = res_a.launched > 0
    dims = tuple(ROI_BOX[k + 1] - ROI_BOX[k] + 1 for k in (0, 2, 4))
    if (rnx, rny, rnz, nside) != dims + (ROI_NSIDE,) \
            or not np.isfinite(tally).all() or (tally < 0).any() \
            or not (tally.sum(1)[inj] > 0).all():
        fail("phase 13: (a) the ROI file is not a finite, non-negative "
             "tally with a positive total in every lit channel")
    print("phase 13: (a) ROI file %dx%dx%d elements x %d pixels x 44 "
          "channels, %.4e photons entered the box (%.4e of those launched)"
          % (rnx, rny, rnz, 12 * nside * nside, tally.sum(),
             tally.sum() / res_a.launched.sum()), flush=True)
    # the same run in memory: the absorbed file and the ROI tally within
    # the rerun bound
    res_m, wall = _rt(dev, _variant(base, "a_mem", add=box + "roisave "
                                    "roi_mem.bin 1\nroinside %d\n"
                                    % ROI_NSIDE), "a, in memory", card)
    out["a_mem"] = wall
    pairs = ((read_cell_frequency_array(os.path.join(d, "a.absorbed")),
              read_cell_frequency_array(os.path.join(d, "a_mem.absorbed")),
              "absorbed.data"),
             (tally, read_roi_file(os.path.join(d, "roi_mem.bin"))[4],
              "ROI tally"))
    for fa, fm, name in pairs:
        live = fm > -1e19
        diff = np.abs(fa - fm)[live].max() / np.abs(fm[live]).max()
        ok = np.array_equal(fa > -1e19, live) and np.allclose(
            fa[live], fm[live], rtol=PRODUCT_RTOL,
            atol=PRODUCT_ATOL * np.abs(fm[live]).max())
        print("phase 13: (a) mmapabs %s against the in-memory rerun: max "
              "|diff| / max = %.3e, within rtol %.0e or %.0e of the max: %s"
              % (name, diff, PRODUCT_RTOL, PRODUCT_ATOL, ok), flush=True)
        if not ok:
            fail("phase 13: (a) the mmapabs run's %s differs from the "
                 "in-memory run's" % name)
    t_a = res_a.timings["constant_sources"]
    t_m = res_m.timings["constant_sources"]
    print("phase 13: (a) the background %.2f s with the ROI save in %d "
          "blocks, %.2f s in memory (the blocks' cost %.2f s)%s [%s]"
          % (t_a, blocks[0], t_m, t_a - t_m, "" if plain_bg is None else
             ", %.2f s without the ROI save (phase 10 (a); its cost %.2f s)"
             % (plain_bg.timings["constant_sources"],
                t_m - plain_bg.timings["constant_sources"]), card),
          flush=True)

    # (b) the ROI load on the box's 8^3 sub-model
    sub = os.path.join(work, "slice_sub")
    ini_b = write_model(sub, N, kind="eqdust", nfreq=44, npix=8,
                        octree=OCTREE, roi_box=ROI_BOX, bgpac=0,
                        extra="roiload %s\nroipackets %d\n"
                        % (os.path.join(d, "roi.bin"), ROI_PACKETS))
    res_b, wall = _rt(dev, ini_b, "b", card)
    out["b"] = wall
    on = res_b.injected > 0
    bal = (res_b.absorbed_photons + res_b.escaped)[on] / res_b.injected[on] \
        - 1
    mask = roi_cell_mask(res_a.grid, ROI_BOX)
    direct = res_a.ctabs[mask].astype(np.float64).sum()
    got = res_b.ctabs.astype(np.float64).sum()
    print("phase 13: (b) ROI load, %d packets on the %d-cell sub-model: "
          "(absorbed + escaped) / injected - 1 per channel max |.| = %.3e "
          "(tolerance %.1e); absorbed energy %.6e against (a)'s %.6e inside "
          "the box: %.3e (bound %.2f)"
          % (res_b.packets, res_b.grid.cells, np.abs(bal).max(),
             BALANCE_TOL, got, direct, got / direct - 1, ROI_RTOL),
          flush=True)
    if not (np.abs(bal).max() <= BALANCE_TOL
            and abs(got / direct - 1) <= ROI_RTOL):
        fail("phase 13: (b) the ROI load does not reproduce the box")

    # (c1) step and direction weighting; `split` asked, and refused
    res_w, wall = _rt(dev, _variant(base, "c1", add="stepweight 2 1.3 0.4\n"
                                    "direweight 1 0.5\nsplit 4\n"), "c1",
                      card)
    out["c1"] = wall
    clones = sum(st["clones"] for st in res_w.source_passes)
    leaf = res_a.grid.dens.cpu().numpy() > 0
    lev = equilibrium.cell_levels(res_a.grid).cpu().numpy()
    # the weights change the variance: STEP_WEIGHT 2 at A 1.3 shortens the
    # free paths and weights a packet by up to e^(0.3 tau), so the densest
    # cells' temperatures scatter by several per cent; a bias shows in a
    # level's mean
    r = weight_readings(res_w.temperature, res_a.temperature,
                        res_w.absorbed, res_a.absorbed, leaf, lev, inj,
                        rtol=WEIGHT_RTOL)
    print("phase 13: (c1) stepweight 2 + direweight against (a): %d clones;"
          " each lit channel's absorption over the leaf cells: max |rel "
          "diff| %.3e (bound %.0e); temperatures' relative difference over "
          "the %d leaf cells: beyond %.0e %.3e of them (bound %.0e), mean "
          "|.| %.3e (bound %.0e), signed mean by level %s (bounds %s)"
          % (clones, r["channel"], WEIGHT_CHANNEL, int(leaf.sum()),
             WEIGHT_RTOL, r["beyond"], WEIGHT_SHARE, r["mean_abs"],
             WEIGHT_MEAN_ABS, ", ".join("%.3e" % m for m in r["levels"]),
             ", ".join("%.0e" % m for m in WEIGHT_LEVEL)), flush=True)
    if clones or len(r["levels"]) != len(WEIGHT_LEVEL) or not (
            r["channel"] <= WEIGHT_CHANNEL and r["beyond"] <= WEIGHT_SHARE
            and r["mean_abs"] <= WEIGHT_MEAN_ABS
            and all(abs(m) <= t for m, t in zip(r["levels"],
                                                WEIGHT_LEVEL))):
        fail("phase 13: (c1) the weighted run split, or it is biased or "
             "scattered against (a)")

    # (c2) mirrored low faces: an octant of a symmetric cloud, one batch of
    # the background (a fifth of (a)'s packets, the same injected weight):
    # the mirrors add 4-74% a channel, far above the sampling noise, and
    # the cut keeps the smoke under 800 s with phase 15
    one_batch = (("bgpackets       %d" % args.bgpackets,
                  "bgpackets       %d" % (args.bgpackets // 4)),)
    res_r, wall = _rt(dev, _variant(base, "c2", subs=one_batch,
                                    add="mirror %s\n" % MIRROR), "c2", card)
    out["c2"] = wall
    source_balance("c2", res_r, card, "phase 13")
    more = res_r.absorbed_photons / res_a.absorbed_photons
    print("phase 13: (c2) mirror %s: absorbed against (a)'s per channel "
          "%.4f-%.4f" % (MIRROR, more[inj].min(), more[inj].max()),
          flush=True)
    if not (res_r.absorbed_photons[inj] >= res_a.absorbed_photons[inj]).all():
        fail("phase 13: (c2) a channel absorbs less with the mirrors")

    # (d) the maps from (a)'s temperatures (loadtemp; roimap map-only)
    t0 = time.time()
    emit = read_cell_frequency_array(os.path.join(d, "a.emitted"))
    outside = np.nonzero(~mask)[0]
    emit[outside[len(outside) // 3]] = np.nan
    with open(os.path.join(d, "nan.emitted"), "wb") as fp:
        np.asarray(emit.shape, np.int32).tofile(fp)
        emit.astype(np.float32).tofile(fp)
    lt = [("iterations      1", "iterations      0"),
          ("temperature     tmp.T", "temperature     a.T")]
    # the orthographic maps look from theta 70 deg: a sheared ray leaves
    # through a Z face after at most ~2.9 box lengths (`maxlos` has no ini
    # keyword of its own, only polmap's arguments)
    view = [("directions      0.0 0.0", "directions      70.0 10.0")]
    runs = {
        "ortho": (view, "FITS 1\nsavetau tau.bin 100.0 850.0 -1\n"
                  + ps_lines + "pssavetau pstau 250.0\n"),
        "ortho_hier": (view, "mapping 64 64 %r 999\n" % (N / 64.0)),
        "mapint": (view, "mapint 2\n"),
        "yshear": (view, "yshear 2.0\n"),
        "healpix_i3": ([], "mapping %d 0 1.0\ninterpolate 3\n" % HP_NSIDE),
        "healpix": ([], "mapping %d 0 1.0\n" % HP_NSIDE),
        "healpix_hier": ([], "mapping %d -1 1.0 999\n" % HP_NSIDE),
        "perspective": ([], "perspective %r %r %r\nmapping 256 128 1.0\n"
                        % ((N / 2.0,) * 3))}
    maps, colden = {}, {}
    for name, (subs, add) in runs.items():
        ini = _variant(base, name, lt + subs, "loadtemp\n" + add)
        res, _ = _rt(dev, ini, "d, " + name, card)
        key = {"ortho_hier": ("hier", 0),
               "healpix_hier": ("hier_hp", 0)}.get(name, 0)
        maps[name] = res.maps[key]
        if not (np.isfinite(maps[name]).all() and maps[name].max() > 0):
            fail("phase 13: (d) the %s map is not finite with a positive "
                 "peak" % name)
        if ("colden", 0) in res.maps:
            colden[name] = float(res.maps[("colden", 0)].sum())
        if name == "ortho":
            ortho = res
    res, _ = _rt(dev, _variant(
        base, "roimap", [("iterations      1", "iterations      0"),
                         ("emitted         emitted.data",
                          "emitted         nan.emitted")],
        box + "roimap\n"), "d, roimap", card)
    if not (np.isfinite(res.maps[0]).all() and res.maps[0].max() > 0):
        fail("phase 13: (d) the roimap map is not finite with a positive "
             "peak under a NaN emission outside the box")
    sums = {"ortho_hier": (maps["ortho_hier"].sum(1), maps["ortho"]),
            "healpix_hier": (maps["healpix_hier"].sum(1), maps["healpix"])}
    for name, (got, ref) in sums.items():
        err = np.abs(got - ref).max() / ref.max()
        print("phase 13: (d) %s planes summed against the plain map: max "
              "|diff| / peak = %.3e (bound %.0e)" % (name, err, HIER_TOL),
              flush=True)
        if not err <= HIER_TOL:
            fail("phase 13: (d) the %s planes do not sum to the plain map"
                 % name)
    low = (maps["yshear"] < maps["ortho"] * (1 - 1e-6)).sum()
    print("phase 13: (d) yshear against the plain map: %d pixels below it; "
          "the sheared column %.3f times the plain one"
          % (low, colden["yshear"] / colden["ortho"]), flush=True)
    if low:
        fail("phase 13: (d) the sheared map is below the plain map")
    fits = sorted(f for f in os.listdir(d) if f.endswith(".fits"))
    bad = []
    for k, f in enumerate(fits):
        data, _ = read_fits_image(os.path.join(d, f))
        if f.startswith("map_"):
            if not any(np.array_equal(data, m) for m in ortho.maps[0]):
                bad.append(f)
        elif not any(np.array_equal(data, np.asarray(v, np.float32))
                     for kk, v in ortho.maps.items()
                     if isinstance(kk, tuple) and kk[0] == "savetau"):
            bad.append(f)
    nmaps = sum(f.startswith("map_") for f in fits)
    print("phase 13: (d) %d FITS files (%d map planes, %d savetau), read "
          "back bit for bit equal to their planes: %s; pssavetau: %s"
          % (len(fits), nmaps, len(fits) - nmaps, not bad,
             open(os.path.join(d, "pstau_0.dat")).read().strip()
             .replace("\n", "; ")), flush=True)
    if bad or nmaps != 44 or len(fits) != 47:
        fail("phase 13: (d) FITS files differ from their planes: %s" % bad)
    out["d"] = time.time() - t0


def _pol_fraction(tag, i, q, u, p0):
    """Phase 14 (b): the polarized fraction sqrt(Q^2 + U^2) / I of every
    pixel with I > 0 at most p0 / (1 - p0/3) (1e-5 relative); returns its
    largest value."""
    lit = i > 0
    frac = np.sqrt(q.astype(np.float64) ** 2 + u.astype(np.float64) ** 2)
    frac = float((frac[lit] / i[lit]).max()) if lit.any() else 0.0
    if not frac <= p0 / (1.0 - p0 / 3.0) * (1.0 + POL_RTOL):
        fail("phase 14: (b) %s: polarized fraction %.6f above p0 / (1 - "
             "p0/3) = %.6f" % (tag, frac, p0 / (1.0 - p0 / 3.0)))
    return frac


def _pol_intensity(tag, i, plain, p0):
    """Phase 14 (b): I of the polarization map within [1 - p0/3,
    1 + 2 p0/3] times the plain map of the same emission (1e-5 relative
    slack) where the plain map exceeds 1e-6 of its peak; returns the
    ratio's range."""
    sel = plain > 1e-6 * plain.max()
    r = i[sel].astype(np.float64) / plain[sel]
    lo, hi = (1.0 - p0 / 3.0) * (1.0 - POL_RTOL), \
        (1.0 + 2.0 * p0 / 3.0) * (1.0 + POL_RTOL)
    if not (r.min() >= lo and r.max() <= hi):
        fail("phase 14: (b) %s: I / plain map in [%.6f, %.6f], outside "
             "[%.6f, %.6f]" % (tag, r.min(), r.max(), lo, hi))
    return float(r.min()), float(r.max())


def _fits_planes(d, tag, planes):
    """Phase 14 (b): every FITS file the run wrote (removed before the
    next run) read back bit for bit equal to one of ``planes``; returns
    their number."""
    from soc_tpu_torch.io.fits import read_fits_image, read_healpix_map
    names = sorted(f for f in os.listdir(d) if ".fits" in f)
    for f in names:
        path = os.path.join(d, f)
        data = read_healpix_map(path)[0] if f.startswith("pol_healpix") \
            else read_fits_image(path)[0]
        if not any(np.array_equal(data, np.asarray(pl, np.float32))
                   for pl in planes):
            fail("phase 14: (b) %s: %s differs from its planes" % (tag, f))
        os.remove(path)
    return len(names)


def _pol_healpix_file(d, shape):
    """pol_healpix.bin's [4, NF, NPIX] planes; fails unless its int32
    header is [NSIDE, NF] for ``shape`` (NF, NPIX)."""
    raw = np.fromfile(os.path.join(d, "pol_healpix.bin"), np.float32)
    head = raw[:2].view(np.int32).tolist()
    if head != [HP_NSIDE, shape[0]] or raw.size != 2 + 4 * np.prod(shape):
        fail("phase 14: (b) pol_healpix.bin has header %s and %d values"
             % (head, raw.size - 2))
    return raw[2:].reshape((4,) + tuple(shape))


def polarization_phase(dev, work, args, report, plain_a):
    """Phase 14: polarized dust emission on BASELINE config 2's octree
    (see the module docstring); ``plain_a``, phase 10 (a)'s run, gives the
    temperatures (c) is held against and its saved heating."""
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.constants import PARSEC, f2um
    from soc_tpu_torch.example_model import (octree_cloud, write_bfield,
                                             write_model)
    from soc_tpu_torch.pipeline import driver
    from soc_tpu_torch.render.mapping import observer_basis
    from soc_tpu_torch.solve import a2e_kernel, stochastic
    from soc_tpu_torch.solve.solver_file import read_solver
    card = report["card"]
    out = report["pol"] = {}
    d = os.path.join(work, "pol")
    t0 = time.time()

    # (a) the pipeline with `polarisation` and `polmap`, a quarter of the
    # background's packets since phase 16 runs (the gates of (a), (b) and
    # phase 15 (d) on its emission hold for any count)
    ini = write_model(d, N, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets // 4, map_dx=N / 64.0,
                      octree=OCTREE,
                      bfield="tangled", polarisation=True,
                      extra="polmap          Bx.bin By.bin Bz.bin\n")
    shutil.copy(os.path.join(work, "gs_TST.solver"), d)
    results = {}
    a2e_kernel.launches = a2e_kernel.align_launches = 0
    a2e_kernel.clamp_launches = 0
    t1 = time.time()
    rc = cli.main(["pipeline", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t1
    launches = (a2e_kernel.launches, a2e_kernel.align_launches,
                a2e_kernel.clamp_launches)
    if rc != 0:
        fail("phase 14: (a) pipeline verb returned %d" % rc)
    ncard = torch.cuda.device_count()
    if launches != (ncard, ncard, 0):
        fail("phase 14: (a) A2E launches (all, with align, clamp) %s, "
             "expected one a card with align" % (launches,))
    res_rt, emitted, res_map = (results[k] for k in ("absorption", "emitted",
                                                     "map"))
    pem = res_map.pemitted
    pfile = read_cell_frequency_array(os.path.join(d, "emitted.data.P"))
    absorbed = read_cell_frequency_array(os.path.join(d, "absorbed.data"))
    parents = absorbed[:, 0] < -1e19
    if pem is None or pfile.shape != (OCTREE_CELLS, 44) \
            or not np.array_equal(pfile, pem):
        fail("phase 14: (a) emitted.data.P differs from the returned "
             "PEMITTED")
    if not (np.isfinite(pem).all() and int(parents.sum()) == OCTREE_PARENTS
            and (pem[parents] == 0).all()
            and (pem <= emitted * (1.0 + POL_RTOL)).all()):
        fail("phase 14: (a) PEMITTED not finite, not zero on the %d parents "
             "or above EMITTED" % OCTREE_PARENTS)
    sol = read_solver(os.path.join(d, "gs_TST.solver"))
    aalg = np.fromfile(os.path.join(d, "aalg.bin"), np.float32)[1:]
    below = (aalg < sol.size_a[0]) & ~parents
    above = (aalg > sol.size_a[-1]) & ~parents
    rel_below = float((np.abs(pem[below] - emitted[below])
                       / np.maximum(emitted[below], 1e-30)).max())
    # write_aalg puts about an eighth of the cells on either side
    if min(below.sum(), above.sum()) < (~parents).sum() // 20 \
            or not rel_below <= POL_RTOL or (pem[above] != 0).any():
        fail("phase 14: (a) PEMITTED is not EMITTED where aalg lies below "
             "the smallest grain size (%d cells, %.3e) or not zero above the "
             "largest (%d cells)" % (below.sum(), rel_below, above.sum()))
    # the plain twin with the align weights on 16,384 leaf cells, the
    # pipeline's clip of the last channel applied as solve_emission does
    leaves = np.nonzero(~parents)[0]
    pick = leaves[::len(leaves) // POL_CHECK_CELLS][:POL_CHECK_CELLS]
    ab = np.where(parents[:, None], 0.0, absorbed).astype(np.float32)
    ab[:, -1] = np.clip(ab[:, -1], 0.0, 0.2 * ab[:, -2])
    align_all = np.stack([stochastic.alignment_weights(sol, i, aalg)
                          for i in range(sol.nsize)])
    stacks = stochastic.get_fused_stacks(sol, dev, plain=True)
    _, ptwin = a2e_kernel.solve_all_sizes_plain(
        stacks, torch.as_tensor(ab[pick], device=dev),
        torch.as_tensor(align_all[:, pick], device=dev))
    rel = max_rel(torch.as_tensor(pem[pick], device=dev), ptwin)
    if not rel <= REL_TOL:
        fail("phase 14: (a) PEMITTED differs from the plain twin on %d "
             "cells (%.3e)" % (len(pick), rel))
    tm = res_map.timings
    print("phase 14: (a) pipeline with `polarisation` on the octree: %.2f s "
          "(absorption %.2f s, A2E %.2f s, maps %.2f s); %d a2e_all_sizes "
          "launch(es), all with align; PEMITTED against the plain twin on "
          "%d cells: max rel err %.3e; EMITTED where aalg < a_min (%d cells, "
          "max rel diff %.3e), zero where aalg > a_max (%d cells), zero on "
          "the %d parents; PEMITTED / EMITTED summed %.4f [%s]"
          % (wall, res_rt.timings["constant_sources"], tm["a2e"],
             tm["maps"], launches[0], len(pick), rel, below.sum(), rel_below,
             above.sum(), OCTREE_PARENTS, pem.sum() / emitted.sum(), card),
          flush=True)
    for rp in res_map.render_passes:
        print("phase 14: (a) render %s: %.3f s, %d rays, %d march steps [%s]"
              % (rp["render"], rp["seconds"], rp["rays"], rp["steps"], card),
              flush=True)
    # the kernel with align at this shape, against the plain twin, timed
    abt = torch.as_tensor(ab, device=dev)
    alt = torch.as_tensor(align_all, device=dev)
    ms_k, (_, pk) = timed(lambda: a2e_kernel.solve_all_sizes(stacks, abt,
                                                             alt), 3)
    ms_p, (_, pp) = timed(
        lambda: a2e_kernel.solve_all_sizes_plain(stacks, abt, alt), 1)
    rel = max_rel(pk, pp)
    if rel > REL_TOL:
        fail("phase 14: (a) a2e_all_sizes with align differs from the plain "
             "twin (%.3e)" % rel)
    b_ms, b_by = bound(*a2e_work(OCTREE_CELLS - OCTREE_PARENTS, sol.nsize,
                                 sol.ne, 44, False, True))
    report["a2e_all_sizes"].update(
        pol_launches=launches[1], pol_ms=ms_k, pol_plain_ms=ms_p,
        pol_bound_ms=b_ms, pol_max_abs_err=float(torch.abs(pk - pp).max()))
    print("phase 14: (a) a2e_all_sizes with align on the octree's "
          "absorptions (%d cells; bound over the %d leaves, with the align "
          "read and the PEMIT write): kernel %.2f ms, plain %.2f ms, bound "
          "%.2f ms (%s), PEMIT max rel err %.3e [%s]"
          % (OCTREE_CELLS, OCTREE_CELLS - OCTREE_PARENTS, ms_k, ms_p, b_ms,
             b_by, rel, card), flush=True)
    out["a"] = time.time() - t0

    # (b) map-only runs from (a)'s emission
    t0 = time.time()
    shutil.copy(os.path.join(d, "emitted.data"),
                os.path.join(d, "pol14.emitted"))
    lcells = octree_cloud(N, *OCTREE)[0]
    odir, ra, de = observer_basis(np.radians(70.0), np.radians(10.0))
    write_bfield(d, (N, N, N), lcells, tuple(0.6 * ra + 0.8 * de),
                 prefix="U")
    write_bfield(d, (N, N, N), lcells, (0.0, 0.0, 1.0), prefix="Z")
    mo = [("iterations      1", "iterations      0"),
          ("optical         gs_TST.dust", "optical         TST_simple.dust"),
          ("emitted         emitted.data", "emitted         pol14.emitted")]
    view = [("directions      0.0 0.0", "directions      70.0 10.0")]
    tangled = "polmap          Bx.bin By.bin Bz.bin"
    field = {"U": [(tangled, "polmap          Ux.bin Uy.bin Uz.bin")],
             "Z": [(tangled, "polmap          Zx.bin Zy.bin Zz.bin")],
             "T": []}
    runs = {
        "ortho": (view, "T", ""),
        "polstat1_tangled": (view, "T", "polstat 1\n"),
        "polstat1_uniform": (view, "U", "polstat 1\n"),
        "polstat3_tangled": (view, "T", "polstat 3\n"),
        "polstat3_uniform": (view, "U", "polstat 3\n"),
        "polstat2": (view + [(tangled, tangled + " 0.0 %r"
                              % (2.0 * N))], "T", "polstat 2\nyshear 2.0\n"),
        "healpix_i3": ([], "T", "mapping %d 0 1.0\ninterpolate 3\n"
                       % HP_NSIDE),
        "healpix": ([], "T", "mapping %d 0 1.0\n" % HP_NSIDE),
        "healpix_stat": ([], "Z", "mapping %d -1 1.0\npolstat 1\n"
                         % HP_NSIDE)}
    for f in os.listdir(d):
        if ".fits" in f:
            os.remove(os.path.join(d, f))
    cfg = RunConfig(ini)
    p0 = cfg.p0
    fsel = driver.map_freq_mask(cfg, res_rt.freq)
    res_b, nfits = {}, 0
    for name, (subs, fld, add) in runs.items():
        run_ini = _variant(ini, "pol_" + name, mo + subs + field[fld], add)
        res, _ = _rt(dev, run_ini, "b, " + name, card, phase="phase 14")
        res_b[name] = res
        pol = [np.asarray(a) for k, v in res.maps.items()
               if isinstance(k, tuple) and str(k[0]).startswith("pol")
               for a in (v if isinstance(v, tuple) else (v,))]
        if not pol or not all(np.isfinite(v).all() for v in pol):
            fail("phase 14: (b) %s: a polarization plane is not finite, or "
                 "none was rendered" % name)
        planes = []
        if ("pol", 0) in res.maps or ("pol_hp", 0) in res.maps:
            key = ("pol", 0) if ("pol", 0) in res.maps else ("pol_hp", 0)
            i, q, u, colden = res.maps[key]
            frac = _pol_fraction(name, i, q, u, p0)
            ratio = (float("nan"),) * 2
            if name != "polstat2":
                ratio = _pol_intensity(name, i[fsel], res.maps[0], p0)
            print("phase 14: (b) %s: I peak %.4e, largest polarized "
                  "fraction %.5f (bound %.5f), I / plain map %.5f-%.5f"
                  % (name, i.max(), frac, p0 / (1 - p0 / 3.0), *ratio),
                  flush=True)
            stack = np.fromfile(os.path.join(d, "polmap_dir_00.bin"),
                                np.float32).reshape((4,) + i.shape) \
                if key == ("pol", 0) else _pol_healpix_file(d, i.shape)
            if not all(np.array_equal(stack[k], v)
                       for k, v in enumerate((i, q, u))):
                fail("phase 14: (b) %s: the map file differs from the "
                     "returned planes" % name)
            planes = [stack[:, f] for f in range(stack.shape[1])]
        if ("polstat", 0) in res.maps:
            st = res.maps[("polstat", 0)]
            rt_, ri_, b, blos, bpos = st[:5]
            if (blos > b * (1 + 1e-6)).any() or (bpos > b * (1 + 1e-6)).any():
                fail("phase 14: (b) %s: B_LOS or B_POS above B" % name)
            four = res.maps[("polstat4", 0)]
            planes = [four[:, f] for f in range(four.shape[1])]
            print("phase 14: (b) %s: rT %.4f-%.4f rad, rI %.4f-%.4f rad, "
                  "jT %.4f-%.4f rad, <|B|> %.4f-%.4f" % (
                      name, rt_.min(), rt_.max(), ri_.min(), ri_.max(),
                      four[2].min(), four[2].max(), b.min(), b.max()),
                  flush=True)
            if name.endswith("uniform") and not (
                    rt_.max() < 1e-3 and four[2].max() < 1e-3):
                fail("phase 14: (b) %s: the uniform field's rT or jT reaches "
                     "1e-3 rad" % name)
            if name.startswith("polstat3"):
                plain_n = res.maps[("colden", 0)] * (cfg.gl * PARSEC)
                err = np.abs(st[6] - plain_n).max() / plain_n.max()
                if not err <= POL_RTOL:
                    fail("phase 14: (b) %s: colden differs from the plain "
                         "map's (%.3e of the peak)" % (name, err))
        if ("polstat_hp", 0) in res.maps:
            hp4 = res.maps[("polstat_hp", 0)]
            if not np.array_equal(_pol_healpix_file(d, hp4.shape[1:]), hp4):
                fail("phase 14: (b) %s: pol_healpix.bin differs from the "
                     "returned planes" % name)
            planes = [hp4[:, f] for f in range(hp4.shape[1])]
            poles = hp4[1, 0, [0, -1]]
            print("phase 14: (b) %s: rI at the poles %.4f, %.4f rad; rT "
                  "max %.3e rad" % (name, poles[0], poles[1],
                                    hp4[0, 0].max()), flush=True)
            if not (poles > 1.3).all():
                fail("phase 14: (b) %s: the polar pixels' rI is not above "
                     "1.3 rad for a field along the line of sight" % name)
        nfits += _fits_planes(d, name, planes)
    low = (res_b["polstat2"].maps[("pol", 0)][0]
           < res_b["ortho"].maps[("pol", 0)][0] * (1 - 1e-6)).sum()
    print("phase 14: (b) polstat 2 against the unsheared map: %d pixels "
          "below it; the sheared column %.3f times the plain one; %d FITS "
          "files read back bit for bit" % (
              low, res_b["polstat2"].maps[("pol", 0)][3].sum()
              / res_b["ortho"].maps[("pol", 0)][3].sum(), nfits), flush=True)
    if low:
        fail("phase 14: (b) the sheared I is below the unsheared one")
    # one a map-band channel for the three Healpix runs; for the four
    # orthographic runs of POLSTAT 0-2 one a distinct 'polmap_%.1f_00'
    # name (channels that print alike share a file, the last one wins)
    names = {"%.1f" % f2um(f) for f in res_rt.freq[fsel]}
    if nfits != 3 * int(fsel.sum()) + 4 * len(names):
        fail("phase 14: (b) %d FITS files, expected %d" % (
            nfits, 3 * int(fsel.sum()) + 4 * len(names)))
    out["b"] = time.time() - t0

    # (c) rt with CR_HEATING from (a)'s saved constant-source heating
    t0 = time.time()
    base_a = os.path.join(work, "octree_rt_a", "run.ini")
    res_c, _ = _rt(dev, _variant(base_a, "cr", [("csave ctabs.save",
                                                 "cload ctabs.save")],
                                 "CR_HEATING 1.0\n"), "c", card,
                   phase="phase 14")
    if res_c.packets != 0 or not np.isfinite(res_c.temperature).all():
        fail("phase 14: (c) the cload run traced constant-source packets, "
             "or its temperatures are not finite")
    leaf = res_c.grid.dens.cpu().numpy() > 0
    ta, tc = plain_a.temperature[leaf], res_c.temperature[leaf]
    cold = ta <= np.percentile(ta, 10)
    rise = tc[cold] / ta[cold] - 1
    low = int((tc < ta * (1 - PRODUCT_RTOL)).sum())
    print("phase 14: (c) rt with CR_HEATING 1.0 from phase 10 (a)'s saved "
          "heating: %d of %d leaf cells below (a)'s by more than %.0e "
          "relative; the coldest decile (%d cells, %.3f-%.3f K) raised by "
          "%.3e on average (%.3e-%.3e), %.4f of them raised [%s]"
          % (low, leaf.sum(), PRODUCT_RTOL, cold.sum(), ta[cold].min(),
             ta[cold].max(), rise.mean(), rise.min(), rise.max(),
             (rise > 0).mean(), card), flush=True)
    if low or not rise.mean() > 0:
        fail("phase 14: (c) CR_HEATING lowered a leaf cell's temperature or "
             "did not raise the coldest decile")
    out["c"] = time.time() - t0


def _sca_check(tag, maps, passes, ndir, card):
    """Phase 15's gates on one `sca` run: every map finite and
    non-negative with light in it, every source pass's events all peeled
    (rays = events x observers: none dropped); prints each pass's seconds,
    packets, events and the lane steps of the transport and of the
    peel-off."""
    if not (np.isfinite(maps).all() and (maps >= 0).all()
            and maps.max() > 0):
        fail("phase 15: (%s) the maps are not finite and non-negative with "
             "a positive peak" % tag)
    for p in passes:
        print("phase 15: (%s) %s: %d channels, %d pool(s), %d packets, "
              "%.2f s (%.0f packets/s), %d events, %d peel-off rays, %d "
              "transport lane steps (%d bodies), %d peel-off lane steps "
              "(%d bodies) [%s]"
              % (tag, p["source"], p["channels"], p["pools"], p["packets"],
                 p["seconds"], p["packets"] / max(p["seconds"], 1e-9),
                 p["events"], p["rays"], p["lane_steps"], p["sca_iters"],
                 p["peel_lane_steps"], p["peel_iters"], card), flush=True)
        if p["rays"] != p["events"] * ndir or p["events"] < 1:
            fail("phase 15: (%s) %s: %d rays for %d events x %d observers"
                 % (tag, p["source"], p["rays"], p["events"], ndir))


def _sca_verb(dev, ini, tag, card):
    """The `sca` verb (cli.main) on ini: (maps, source passes, wall s)."""
    import torch
    from soc_tpu_torch import cli
    results = {}
    t0 = time.time()
    rc = cli.main(["sca", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if rc != 0:
        fail("phase 15: (%s) sca verb returned %d" % (tag, rc))
    print("phase 15: (%s) sca verb %.2f s, maps %s [%s]"
          % (tag, wall, results["sca"].shape, card), flush=True)
    return results["sca"], results["sca_passes"], wall


def _sca_container(d, maps, head):
    """outcoming.socs read back: its int32 header, its frequencies (the
    dust file's) and its maps, equal to the returned array."""
    from soc_tpu_torch.io.dust import read_simple_dust
    raw = np.fromfile(os.path.join(d, "outcoming.socs"), np.uint8)
    nh = 4 * len(head)
    got = raw[:nh].view(np.int32).tolist()
    ffreq = raw[nh:nh + 4 * 44].view(np.float32)
    body = raw[nh + 4 * 44:].view(np.float32)
    freq = read_simple_dust(os.path.join(d, "tst.dust"), 0.01).freq
    if got != list(head) or not np.array_equal(
            ffreq, np.asarray(freq, np.float32)) \
            or not np.array_equal(body, maps.reshape(-1)):
        fail("phase 15: %s/outcoming.socs does not read back (header %s)"
             % (os.path.basename(d), got))


def _within(got, ref, rtol, atol_share):
    """max |got - ref| beyond rtol |ref| + atol_share max|ref| (0 when
    within)."""
    excess = np.abs(got - ref) - (rtol * np.abs(ref)
                                  + atol_share * np.abs(ref).max())
    return float(max(excess.max(), 0.0))


def _beyond_ceiling(dev, report):
    """Phase 15 (e): both A2E kernels' global form beyond the shared
    form's ceiling, on seeded stacks of one size and 512 cells with the
    align weights (example_model.seeded_a2e_stacks): the solve through the
    wrappers with the counts zeroed (the global form must launch), then
    against the plain twin at REL_TOL and timed."""
    import torch
    from soc_tpu_torch.example_model import (seeded_a2e_stacks,
                                             with_negative_entries)
    from soc_tpu_torch.solve import a2e_kernel
    card = report["card"]
    lib = a2e_kernel._lib()
    for kernel, name in (("fold", "a2e_all_sizes_global"),
                         ("clamp", "a2e_clamp_global")):
        clamp = kernel == "clamp"
        solve = a2e_kernel.solve_all_sizes_clamp if clamp \
            else a2e_kernel.solve_all_sizes
        pick = a2e_kernel.pick_clamp_config if clamp \
            else a2e_kernel.pick_fold_config
        count = "clamp_global_launches" if clamp else "global_launches"
        entry = report[name] = dict(library_ms=None)
        cases = []
        for nf, ne in A2E_BEYOND:
            stacks, ab = seeded_a2e_stacks(ne + nf, ne, nf, dev, clamp=clamp,
                                           negate=clamp)
            rng = np.random.default_rng(ne + nf)
            if clamp:
                ab = with_negative_entries(rng, ab)
            ab = torch.as_tensor(ab, device=dev)
            align = torch.as_tensor(rng.uniform(0, 1, (1, ab.shape[0]))
                                    .astype(np.float32), device=dev)
            cases.append((nf, ne, stacks, ab, align,
                          pick(lib, nf, ne, dev.index or 0)))
        # the path: the wrappers the solve calls, counts zeroed
        setattr(a2e_kernel, count, 0)
        for nf, ne, stacks, ab, align, config in cases:
            solve(stacks, ab, align)
        torch.cuda.synchronize()
        launches = getattr(a2e_kernel, count)
        if launches != len(cases) or any(c[5].form != "global"
                                         for c in cases):
            fail("phase 15: (e) %s: %d global-form launches for %d shapes "
                 "beyond the ceiling" % (name, launches, len(cases)))
        entry["launches"] = launches
        for k, (nf, ne, stacks, ab, align, config) in enumerate(cases):
            ms_k, (tot_k, ptot_k) = timed(lambda: solve(stacks, ab, align), 3)
            # the plain twin once, no warm-up: it runs its solve after the
            # kernel's on the same stacks (1.5-2.2 s a call at NE 1856)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            tot_p, ptot_p = a2e_kernel.solve_all_sizes_plain(stacks, ab,
                                                             align, batch=64)
            e1.record()
            torch.cuda.synchronize()
            ms_p = e0.elapsed_time(e1)
            rel = max(max_rel(tot_k, tot_p), max_rel(ptot_k, ptot_p))
            abs_err = float(torch.abs(tot_k - tot_p).max())
            b_ms, b_by = bound(*a2e_work(ab.shape[0], 1, ne, nf, clamp,
                                         True))
            print("phase 15: (e) %s at NE %d, NFREQ %d (%d cells, one "
                  "size, align): global form, %d cells a block, staged run "
                  "%d, %d warps per SM; kernel %.2f ms, plain %.2f ms, "
                  "bound %.3f ms (%s); max rel err %.3e, max abs err %.3e "
                  "[%s]" % (name, ne, nf, ab.shape[0], config.tile,
                            config.run, config[2], ms_k, ms_p, b_ms, b_by,
                            rel, abs_err, card), flush=True)
            if not rel <= REL_TOL:
                fail("phase 15: (e) %s at NE %d, NFREQ %d differs from the "
                     "plain twin (%.3e)" % (name, ne, nf, rel))
            pre = "" if k == 0 else "nf%d_" % nf
            entry.update({pre + "ms": ms_k, pre + "plain_ms": ms_p,
                          pre + "bound_ms": b_ms, pre + "bound_by": b_by,
                          pre + "max_abs_err": abs_err})


def scattering_phase(dev, work, args, report):
    """Phase 15: scattered light (the `sca` verb) on BASELINE config 4's
    model, phase 10's octree, and the A2E kernels beyond their shared-form
    ceiling (see the module docstring)."""
    import torch
    from soc_tpu_torch.example_model import write_sca_model
    from soc_tpu_torch.grid import uniform_grid
    from soc_tpu_torch.io.dust import hg_scattering_function
    from soc_tpu_torch.io.fits import read_fits_image
    from soc_tpu_torch.pipeline import scattering
    from soc_tpu_torch.render import scattered
    from soc_tpu_torch.render.mapping import observer_basis
    card = report["card"]
    out = report["sca"] = {}
    common = dict(nfreq=44, npix=64, map_dx=N / 64.0, octree=OCTREE)

    def model(tag, subs=(), **kw):
        d = os.path.join(work, "sca_" + tag)
        ini = write_sca_model(d, N, **common, **kw)
        with open(ini) as fp:
            text = fp.read()
        for old, new in subs:
            text = text.replace(old, new)
        with open(ini, "w") as fp:
            fp.write(text)
        return d, ini

    # (a) config 4: the background, two point sources and the sky, ffs 1,
    # three directions
    t0 = time.time()
    dirs = (("directions      0.0 0.0",
             "directions      " + " ".join("%r %r" % v for v in SCA_DIRS)),)
    src = dict(bgpac=SCA_BGPACKETS, point_sources=POINT_SOURCES,
               pspackets=SCA_PSPACKETS, hpbg=SKY_NSIDE, ffs=1)
    d, ini = model("a", dirs, simum=SCA_SIMUM, **src)
    maps, passes, wall = _sca_verb(dev, ini, "a", card)
    _sca_check("a", maps, passes, len(SCA_DIRS), card)
    if maps.shape != (44, len(SCA_DIRS), 64, 64) \
            or sorted(p["source"] for p in passes) \
            != ["sca_bg", "sca_hpbg", "sca_ps"]:
        fail("phase 15: (a) maps %s, sources %s" % (
            maps.shape, [p["source"] for p in passes]))
    _sca_container(d, maps, (64, 64, 44))
    lit = np.nonzero(maps.reshape(44, -1).max(1) > 0)[0]
    print("phase 15: (a) %d channels lit (%s) [%s]"
          % (len(lit), lit.tolist(), card), flush=True)
    out["a"] = wall

    # (a)'s background on two channels: the mixed pool, a pool a channel,
    # devices 2 (the background alone: its pools' cost is what this
    # measures, and the three runs of all three sources took 133 s)
    d2, ini2 = model("a2", dirs, simum=SCA_SIMUM_2, bgpac=SCA_BGPACKETS,
                     ffs=1)
    times = {}
    runs = {}
    for how, kw in (("mixed", {}), ("channel", dict(per_channel=True)),
                    ("devices 2", dict(devices=[dev, dev]))):
        ps2 = []
        t1 = time.time()
        runs[how] = scattering.run(ini2, device=dev, passes=ps2, **kw)
        torch.cuda.synchronize()
        times[how] = time.time() - t1
        _sca_check("a, 2 channels, " + how, runs[how], ps2, len(SCA_DIRS),
                   card)
    ex_ch = _within(runs["channel"], runs["mixed"], PRODUCT_RTOL,
                    PRODUCT_ATOL)
    ex_dev = _within(runs["devices 2"], runs["mixed"], 2e-4, 1e-6)
    print("phase 15: (a) 2 channels: one mixed pool a source %.2f s, a pool "
          "a channel and source %.2f s, devices 2 on this card %.2f s; a "
          "pool a channel against the mixed pool: excess over 1e-4 "
          "relative or 1e-6 of the peak %.3e; devices 2 over 2e-4: %.3e "
          "[%s]" % (times["mixed"], times["channel"], times["devices 2"],
                    ex_ch, ex_dev, card), flush=True)
    if ex_ch > 0 or ex_dev > 0:
        fail("phase 15: (a) the pools a channel or devices 2 differ from "
             "the mixed pool")
    out["a_2ch"] = sum(times.values())

    # a thin uniform cloud: single-scattering normalisation (soc_tpu's
    # tests/test_scattered.py), on the card at 64^3
    t1 = time.time()
    grid = uniform_grid(N, N, N, dev, 1.0)
    dsc, csc = hg_scattering_function([0.0], 256)
    ksca = 2.0e-3 * 8 / N
    phys = dict(kabs=torch.zeros(1, device=dev),
                ksca=torch.full((1,), ksca, device=dev),
                csc=torch.as_tensor(csc, device=dev),
                dsc=torch.as_tensor(dsc, device=dev))
    n = 8 * int(grid.area)
    odir, ra, de = observer_basis(0.0, 0.0)
    thin, st = scattered.simulate_scattering(
        grid, phys, dict(photons=torch.ones(1, device=dev), ifreq=0,
                         per_freq=n, hi_base=0), n, odir, ra, de,
        (N / 2,) * 3, 1.0, (N + 16, N + 16), 5, nlanes=1 << 18,
        return_stats=True)
    got = float(thin.sum())
    expect = n * ksca * 4.0 * N ** 3 / (6 * N ** 2) / (4.0 * np.pi)
    print("phase 15: thin %d^3 cloud, %d packets: peel-off sum %.6e against "
          "the single-scattering %.6e (%.4f), %d events, %.2f s [%s]"
          % (N, n, got, expect, got / expect, st["events"], time.time() - t1,
             card), flush=True)
    if not abs(got / expect - 1) < 0.04:
        fail("phase 15: the thin cloud's single-scattering normalisation is "
             "off by %.4f" % (got / expect - 1))

    # (b) the internal observer at the centre: background + diffuse field
    d, ini = model("b", simum=SCA_SIMUM_B, bgpac=SCA_BGPACKETS,
                   intobs=(N / 2,) * 3, outnside=HP_NSIDE,
                   diffuse=DIFFUSE_SHARE, dfpackets=OCTREE_CELLS)
    maps, passes, out["b"] = _sca_verb(dev, ini, "b", card)
    _sca_check("b", maps, passes, 1, card)
    if maps.shape != (44, 12 * HP_NSIDE ** 2) \
            or [p["source"] for p in passes] != ["sca_bg", "diffuse"]:
        fail("phase 15: (b) maps %s" % (maps.shape,))
    _sca_container(d, maps, (HP_NSIDE, 44))

    # (c) two dusts with abundances (MSF), one direction, FITS
    d, ini = model("c", simum=SCA_SIMUM_C, bgpac=SCA_BGPACKETS,
                   abundance=True, fits=True)
    maps, passes, out["c"] = _sca_verb(dev, ini, "c", card)
    _sca_check("c", maps, passes, 1, card)
    data, _ = read_fits_image(os.path.join(d, "scattering.fits"))
    if os.path.exists(os.path.join(d, "outcoming.socs")) \
            or not np.array_equal(data, maps[:, 0]):
        fail("phase 15: (c) scattering.fits does not read back as the "
             "returned maps")

    # (d) cell emission from phase 14 (a)'s emitted file, FFS on and off
    emitted = os.path.join(work, "pol", "emitted.data")
    d, ini = model("d", simum=SCA_SIMUM_D, bgpac=0,
                   cellpackets=OCTREE_CELLS, ffs=1)
    shutil.copy(emitted, d)
    ini0 = os.path.join(d, "ffs0.ini")
    with open(ini) as fp:
        text = fp.read()
    with open(ini0, "w") as fp:
        fp.write(text.replace("ffs             1", "ffs             0"))
    flux = {}
    for tag, path in (("d, ffs 1", ini), ("d, ffs 0", ini0)):
        maps, passes, wall = _sca_verb(dev, path, tag, card)
        _sca_check(tag, maps, passes, 1, card)
        out[tag] = wall
        flux[tag] = (maps.reshape(44, -1).sum(1, dtype=np.float64),
                     passes[0])
    (f1, p1), (f0, p0) = flux["d, ffs 1"], flux["d, ffs 0"]
    # the thin channels: scattering depth below 0.1 across the cloud
    from soc_tpu_torch.io.dust import read_simple_dust
    dust = read_simple_dust(os.path.join(d, "tst.dust"), 0.01)
    sel = np.nonzero((f0 > 0) | (f1 > 0))[0]
    thin_ch = [i for i in sel if dust.sca_gl[i] * 3.0e4 * N < 0.1]
    slack = 5.0 * np.sqrt(2.0 / max(p0["events"], 1))
    ratio = f1[thin_ch].sum() / max(f0[thin_ch].sum(), 1e-300)
    print("phase 15: (d) thin channels %s: flux with FFS / without %.4f "
          "(bound 1 - %.4f: five of the ffs 0 run's standard errors); "
          "events %d with FFS for %d packets, %d without [%s]"
          % ([int(i) for i in thin_ch], ratio, slack, p1["events"],
             p1["packets"],
             p0["events"], card), flush=True)
    if not thin_ch or not (f1[thin_ch] > 0).all() or ratio < 1.0 - slack \
            or p1["events"] < 0.99 * p1["packets"]:
        fail("phase 15: (d) FFS lost flux or packets in the thin channels")

    # (e) A1: the A2E kernels beyond the shared form's ceiling
    t1 = time.time()
    _beyond_ceiling(dev, report)
    out["e"] = time.time() - t1
    out["total"] = time.time() - t0


def probes_phase(dev, report):
    """Phase 7: the three probe modules, each row through its kernel."""
    import torch
    from soc_tpu_torch.probes import (gather_probe, kernels, probe_gather,
                                      probe_gather2)
    for name in kernels.launches:
        kernels.launches[name] = 0
    t0 = time.time()
    results = (probe_gather.run(dev) + probe_gather2.run(dev)
               + gather_probe.run(dev))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print("phase 7: probes ran in %.2f s [%s]" % (time.time() - t0,
                                                  report["card"]), flush=True)
    bad = [r.name for r in results if not r.ok]
    if bad:
        fail("phase 7: kernels that fail their checks: %s" % ", ".join(bad))
    for r in results:
        if r.kernel == "probe_row_gather":
            other = (r.reference_device_seconds, r.reference_device_spread,
                     r.reference_span)
            label = "no one-call library call; two calls (embedding_bag, sum)"
        elif r.kernel in ("probe_gather", "probe_scatter"):
            other = (r.library_device_seconds, r.library_device_spread,
                     r.library_span)
            label = "embedding_bag" if r.kernel == "probe_gather" \
                else "index_add_"
        else:
            continue
        if r.device_seconds is None:
            fail("phase 7: %s: device time not measured" % r.name)
        if other[0] is None:
            fail("phase 7: %s: %s: device time not measured"
                 % (r.name, label))
        print("phase 7: %s: device time per call (best of 3) kernel %.4f ms "
              "(spread %.4f; span %.4f ms%s), plain %s, %s %.4f ms (spread "
              "%.4f; span %.4f ms), %.2fx [%s]"
              % (r.name, 1e3 * r.device_seconds, 1e3 * r.device_spread,
                 1e3 * r.device_span,
                 "" if len(r.device_intervals) < 2 else ": " + ", ".join(
                     "%s %.4f" % (n, 1e3 * t) for n, t in r.device_intervals),
                 "not measured" if r.plain_device_seconds is None
                 else "%.4f ms" % (1e3 * r.plain_device_seconds), label,
                 1e3 * other[0], 1e3 * other[1], 1e3 * other[2],
                 other[0] / r.device_seconds, report["card"]), flush=True)
    for r in results:
        if r.kernel != "probe_onehot":
            continue
        if r.device_seconds is None or r.library_device_seconds is None:
            fail("phase 7: %s: device time not measured" % r.name)
        print("phase 7: %s: %d deposits: %.4e deposits/s of device time "
              "(%.4f ms), index_add_ %.4e deposits/s (%.4f ms) [%s]"
              % (r.name, r.elems,
                 r.elems / r.device_seconds, 1e3 * r.device_seconds,
                 r.elems / r.library_device_seconds,
                 1e3 * r.library_device_seconds, report["card"]),
              flush=True)
    for name in PROBE_KERNELS:
        rows = [r for r in results if r.kernel == name]
        if launches[name] < 1 or not rows:
            fail("phase 7: %s was not launched" % name)
        # device time per call where the profiler saw the device, else
        # the call's event-timed time (which holds the launch overhead)
        dev_ms = 1e3 * sum(r.seconds if r.device_seconds is None
                           else r.device_seconds for r in rows)
        plain_ms = 1e3 * sum(r.plain_seconds if r.plain_device_seconds is
                             None else r.plain_device_seconds for r in rows)
        bound_ms = 1e3 * sum(r.bound_seconds for r in rows)
        by_bytes = sum(r.bound_seconds for r in rows if r.bound_by == "bytes")
        lib = [r.library_seconds if r.library_device_seconds is None
               else r.library_device_seconds for r in rows]
        report[name] = dict(
            launches=launches[name], max_abs_err=max(r.abs_err for r in rows),
            ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if 2 * by_bytes >= bound_ms / 1e3
            else "operations",
            library_ms=None if None in lib else 1e3 * sum(lib))
        print("phase 7: %s: %d rows, %d launches; summed over its rows, "
              "device time per call: kernel %.4f ms, plain %.4f ms, "
              "library call %s, bound %.4f ms (%s); call time (best of 3): "
              "kernel %.4f ms, plain %.4f ms%s"
              % (name, len(rows), launches[name], dev_ms, plain_ms,
                 "none" if report[name]["library_ms"] is None
                 else "%.4f ms" % report[name]["library_ms"], bound_ms,
                 report[name]["bound_by"],
                 1e3 * sum(r.seconds for r in rows),
                 1e3 * sum(r.plain_seconds for r in rows),
                 "" if all(r.device_seconds is not None
                           and r.plain_device_seconds is not None
                           for r in rows)
                 else " (device time not measured for every row: call "
                      "times stand in)"), flush=True)
    random_atomics(dev, report["card"])


def random_atomics(dev, card):
    """Phase 7: the rate of random float atomics into a table in L2, the
    floor of a fused march's deposits (one atomic a deposit, into the
    cells a packet crosses): the scatter kernel's FLAT LCG_BEFORE form
    over S1's inputs, 2^17 lanes x 4 steps into 262,144 cells, each step
    an atomicAdd at an LCG index; held to the plain version. S1 itself
    folds three quarters of its adds into a stencil, since the ADD rule
    puts a lane's steps on consecutive cells. These launches come after
    the counted run."""
    from soc_tpu_torch.probes import common, kernels, probe_gather
    _, idx, vals = probe_gather.inputs(0, dev)
    args = (idx, vals, kernels.LCG_BEFORE, kernels.FLAT, probe_gather.CELLS,
            4)
    err = common.error(kernels.scatter(*args), kernels.scatter_plain(*args),
                       common.REL_OF_MAX)
    best, spread, call = common.device_seconds(lambda: kernels.scatter(*args))
    if best is None:
        fail("phase 7: random atomics: device time not measured")
    atomics = 4 * idx.numel()
    deposit = max(t for n, t in common.intervals(call) if "flat_lcg" in n)
    print("phase 7: random atomics (FLAT LCG_BEFORE over S1's inputs, %d "
          "atomicAdds into %d cells): device time per call (best of 3) "
          "%.4f ms (spread %.4f), %.4e atomics/s; the atomic kernel alone "
          "%.4f ms, %.4e atomics/s; against plain %.3e (limit %.0e) [%s]"
          % (atomics, probe_gather.CELLS, 1e3 * best, 1e3 * spread,
             atomics / best, 1e3 * deposit, atomics / deposit, err,
             common.LIMITS[common.REL_OF_MAX], card), flush=True)
    if err > common.LIMITS[common.REL_OF_MAX]:
        fail("phase 7: random atomics differ from the plain version")


def config5_phase(dev, work, args, report):
    """Phase 16: BASELINE config 5 on phase 10's octree with two GSET
    dusts, per-cell abundances and 44 channels (see the module
    docstring): (a) the `pipeline` verb's makelib mode, (b) its uselib
    mode, (c) nnmake then nnsolve through the `mabu` verb, (d) the host
    verbs on (a)'s files.
    The background runs a quarter of `bgpackets`, as phase 12 (b)'s:
    every gate holds for any count."""
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.config import RunConfig
    from soc_tpu_torch.constants import f2um
    from soc_tpu_torch.example_model import (GRAIN_LINE, _dustem_files,
                                             frequencies, write_model)
    from soc_tpu_torch.io.fields import write_cell_frequency_array
    from soc_tpu_torch.pipeline import mabu
    from soc_tpu_torch.pipeline.full import build_components, \
        read_abundances
    from soc_tpu_torch.solve import a2e_kernel, library, stochastic
    card = report["card"]
    out = report["config5"] = {}
    ncard = torch.cuda.device_count()
    sub = os.path.join(work, "config5")
    ini = write_model(sub, N, kind="gset", nfreq=44, nsize=24, npix=64,
                      bgpac=args.bgpackets // 4, map_dx=N / 64.0,
                      octree=OCTREE, abundance=True)
    with open(ini) as fp:
        base_ini = fp.read()
    # phase 4's A2E_pre output for the first dust (same channels, NE 128)
    shutil.copy(os.path.join(work, "gs_TST.solver"), sub)

    def pipeline(tag, mode=None, extra=""):
        with open(ini, "w") as fp:
            fp.write(base_ini + extra)
        results = {}
        a2e_kernel.launches = a2e_kernel.clamp_launches = 0
        t0 = time.time()
        rc = cli.main(["pipeline", ini] + ([mode] if mode else [])
                      + ["--device", str(dev)], results)
        torch.cuda.synchronize()
        out[tag] = time.time() - t0
        if rc != 0:
            fail("phase 16: (%s) pipeline verb returned %d" % (tag, rc))
        return results, (a2e_kernel.launches, a2e_kernel.clamp_launches)

    def verb(argv, results=None):
        t0 = time.time()
        rc = cli.main(argv, results)
        if rc != 0:
            fail("phase 16: %s returned %d" % (" ".join(argv), rc))
        return time.time() - t0

    # ---- (a) makelib: the full solve, then the library
    res, launches = pipeline("a", "makelib")
    res_rt, tm = res["absorption"], res["map"].timings
    freq = res_rt.freq
    if launches != (2 * ncard, 0):
        fail("phase 16: (a) A2E launches %s, expected one a dust and card"
             % (launches,))
    bal = (res_rt.absorbed_photons + res_rt.escaped) / res_rt.injected - 1
    if np.abs(bal).max() > BALANCE_TOL:
        fail("phase 16: (a) energy balance off (%.3e)" % np.abs(bal).max())
    os.chdir(sub)
    try:
        absorbed = read_cell_frequency_array("absorbed.data")
        e_a = read_cell_frequency_array("emitted.data")
        parents = absorbed[:, 0] < -1e19
        if absorbed.shape != (OCTREE_CELLS, 44) or \
                int(parents.sum()) != OCTREE_PARENTS:
            fail("phase 16: (a) absorbed.data has shape %s with %d parent "
                 "rows" % (absorbed.shape, int(parents.sum())))
        if not (np.isfinite(e_a).all() and (e_a[parents] == 0).all()
                and e_a[~parents].max() > 0):
            fail("phase 16: (a) emitted.data not finite, or not zero on "
                 "the parents")
        lib = library.load_library("gs_TST.lib")
        if not 0.0 < lib["occupancy"] <= 1.0:
            fail("phase 16: (a) library occupancy %r" % lib["occupancy"])
        shutil.copy("absorbed.data", "absorbed_full.data")
        print("phase 16: (a) pipeline makelib on the octree (%d cells, two "
              "GSET dusts with abundances, 44 channels): absorption %.2f s "
              "(%d packets), A2E prep %.2f s, emission stage %.2f s (A2E "
              "gs_TST %.2f s, gs_TST2 %.2f s; %d launches), build_library "
              "%.2f s (host NumPy; 64 bins an axis, occupancy %.4f), maps "
              "%.2f s, total %.2f s; energy balance %.3e [%s]"
              % (OCTREE_CELLS, res_rt.timings["constant_sources"],
                 res_rt.packets, tm["a2e_prep"], tm["a2e"], tm["a2e_gs_TST"],
                 tm["a2e_gs_TST2"], launches[0], tm["library_build"],
                 lib["occupancy"], tm["maps"], out["a"], np.abs(bal).max(),
                 card), flush=True)

        # the kernel at this shape: dust gs_TST's share of the absorptions
        cfg = RunConfig(ini).validate()
        cfg.freq = freq
        comps = build_components(cfg, freq)
        abu = read_abundances(cfg, OCTREE_CELLS, len(comps))
        clean = np.where(parents[:, None], 0.0, absorbed).astype(np.float32)
        abs_tst = mabu.split_absorbed(
            clean, mabu.relative_cross_sections(comps, 44), abu,
            0).astype(np.float32)
        sol = comps[0].solver
        clipped = abs_tst.copy()
        clipped[:, -1] = np.clip(clipped[:, -1], 0.0, 0.2 * clipped[:, -2])
        stacks = stochastic.get_fused_stacks(sol, dev, plain=True)
        ab = torch.as_tensor(clipped, device=dev)
        ms_k, _ = timed(lambda: a2e_kernel.solve_all_sizes(stacks, ab), 3)
        leaves = np.nonzero(~parents)[0]
        pick = torch.as_tensor(leaves[::len(leaves) // POL_CHECK_CELLS]
                               [:POL_CHECK_CELLS], device=dev)
        abp = ab[pick]
        ms_kc, (tot_k, _) = timed(
            lambda: a2e_kernel.solve_all_sizes(stacks, abp), 3)
        ms_pc, (tot_p, _) = timed(
            lambda: a2e_kernel.solve_all_sizes_plain(stacks, abp), 1)
        rel = max_rel(tot_k, tot_p)
        if rel > REL_TOL:
            fail("phase 16: a2e_all_sizes differs from the plain twin "
                 "(%.3e)" % rel)
        b_ms, b_by = bound(*a2e_work(len(leaves), sol.nsize, sol.ne, 44,
                                     False, False))
        report["a2e_all_sizes"].update(
            config5_launches=launches[0], config5_ms=ms_k,
            config5_bound_ms=b_ms, config5_check_cells=POL_CHECK_CELLS,
            config5_check_ms=ms_kc, config5_check_plain_ms=ms_pc,
            config5_max_abs_err=float(torch.abs(tot_k - tot_p).max()))
        print("phase 16: a2e_all_sizes on gs_TST's share (%d cells, bound "
              "over the %d leaves): kernel %.2f ms, bound %.2f ms (%s); on "
              "%d leaves kernel %.2f ms, plain %.2f ms, max rel err %.3e "
              "[%s]" % (OCTREE_CELLS, len(leaves), ms_k, b_ms, b_by,
                        POL_CHECK_CELLS, ms_kc, ms_pc, rel, card), flush=True)
        del stacks, ab, abp
        torch.cuda.empty_cache()

        # ---- (b) uselib: the 3 FSELECT channels, the library's lookup
        res, launches = pipeline("b", "uselib")
        res_rt = res["absorption"]
        ab3 = read_cell_frequency_array("absorbed.data")
        e_b = read_cell_frequency_array("emitted.data")
        maps = read_map_file("map_dir_00.bin")
        if launches != (0, 0) or np.count_nonzero(res_rt.injected) != 3 \
                or ab3.shape != (OCTREE_CELLS, 3):
            fail("phase 16: (b) A2E launches %s, %d channels simulated, "
                 "absorbed.data of shape %s" % (
                     launches, np.count_nonzero(res_rt.injected),
                     ab3.shape))
        if not (np.isfinite(maps).all() and maps.max() > 0):
            fail("phase 16: (b) the map is not finite with a positive peak")
        fir = f2um(freq) >= 100.0
        t, p = e_a[:, fir], e_b[:, fir]
        m = t > 1e-3 * t.max()
        rel = np.abs(p[m] / t[m] - 1.0)
        med, p90 = float(np.median(rel)), float(np.percentile(rel, 90))
        lib3 = dict(lib, ref_indices=[0, 1, 2])
        clean3 = np.where(parents[:, None], 0.0, ab3).astype(np.float32)
        table, lo, span = library.device_table(lib3, dev)
        aref = torch.as_tensor(clean3, device=dev)
        ms_l, got = timed(lambda: library.lookup_torch(
            table, lo, span, aref, lib["nbins"]), 10)
        same = float(np.mean(np.all(got.cpu().numpy()
                                    == library.lookup_numpy(lib3, clean3),
                                    axis=1)))
        # uselib's emission is the library's lookup of (a)'s absorptions:
        # the same packets in the 3 channels, added in another order
        same_a = float(np.mean(np.all(
            e_b[~parents] == library.lookup_numpy(lib, clean)[~parents],
            axis=1)))
        print("phase 16: (b) pipeline uselib: absorption %.2f s (%d packets "
              "over 3 channels), lookup in the pipeline %.3f s, maps %.2f s, "
              "total %.2f s; the lookup on the card %.4f ms for %d cells "
              "(CUDA events, mean of 10): %.4e cells/s; the same bin as the "
              "NumPy twin in %.6f of the cells; emitted.data the twin's "
              "lookup of (a)'s absorptions in %.6f of the leaves; against "
              "(a) at >= 100 um "
              "over %d entries above 1e-3 of the peak: median relative "
              "difference %.4f (limit %.2f), 90th percentile %.4f (limit "
              "%.2f) [%s]" % (res_rt.timings["constant_sources"],
                              res_rt.packets, res["map"].timings["lookup"],
                              res["map"].timings["maps"], out["b"], ms_l,
                              OCTREE_CELLS, OCTREE_CELLS / ms_l * 1e3, same,
                              same_a, int(m.sum()), med, LIB_MEDIAN, p90,
                              LIB_P90, card), flush=True)
        out["lookup_cells_per_s"] = OCTREE_CELLS / ms_l * 1e3
        if med >= LIB_MEDIAN or p90 >= LIB_P90 or same < 0.999 \
                or same_a < 0.999:
            fail("phase 16: (b) the library's emission is off")

        # ---- (c) nnmake, then nnsolve: the `mabu` verb (A2E_MABU's NN
        # paths) on (a)'s absorbed.data, which a pipeline run would
        # simulate again
        dv = ["--device", str(dev)]
        emit_ch = np.nonzero(fir)[0][-NN_EMIT_CHANNELS:]
        nn_lines = ("nnabs %s\nnnemit %s\nnnthin 4\nnnnet 13 17 13\n"
                    % (" ".join("%.9g" % u
                                for u in f2um(freq[lib["ref_indices"]])),
                       " ".join("%.9g" % u for u in f2um(freq[emit_ch]))))
        launches = []
        for tag, line in (("c_make", "nnmake surro\n"),
                          ("c_solve", "nnsolve surro\n")):
            with open(ini, "w") as fp:
                fp.write(base_ini + line + nn_lines)
            a2e_kernel.launches = a2e_kernel.clamp_launches = 0
            res = {}
            out[tag] = verb(["mabu", ini, "absorbed_full.data",
                             tag + ".data"] + dv, res)
            launches.append((a2e_kernel.launches, a2e_kernel.clamp_launches))
            tm = dict(tm, **res["mabu"]) if tag == "c_solve" else res["mabu"]
        if launches != [(2 * ncard, 0), (0, 0)] or not all(
                os.path.exists("surro_%s.nn" % c.name) for c in comps):
            fail("phase 16: (c) A2E launches %s, surrogates %s"
                 % (launches, sorted(f for f in os.listdir(".")
                                     if f.endswith(".nn"))))
        e_c = read_cell_frequency_array("c_solve.data")
        others = np.ones(44, bool)
        others[emit_ch] = False
        a, b = e_c[:, emit_ch], e_a[:, emit_ch]
        pos = b > 0
        med_nn = float(np.median(np.abs(a[pos] - b[pos]) / b[pos]))
        out["nn_fit_steps_per_s"] = tm["nn_fit_steps"] / tm["nn_fit"]
        print("phase 16: (c) the mabu verb with nnmake %.2f s (nn_fit %.2f s "
              "on the card: %d Adam steps over both dusts, %.1f steps/s), "
              "with nnsolve %.2f s (nn_solve %.3f s); in the %d nnemit "
              "columns the median relative difference against (a) %.4f "
              "(limit %.2f) [%s]"
              % (out["c_make"], tm["nn_fit"], tm["nn_fit_steps"],
                 out["nn_fit_steps_per_s"], out["c_solve"], tm["nn_solve"],
                 len(emit_ch), med_nn, NN_MEDIAN, card), flush=True)
        if np.abs(e_c[:, others]).max() != 0.0 or med_nn >= NN_MEDIAN:
            fail("phase 16: (c) nnsolve: other columns non-zero or the "
                 "surrogate off")
        with open(ini, "w") as fp:
            fp.write(base_ini)

        # ---- (d) the host verbs on (a)'s files
        t_d = time.time()
        np.savetxt("freq.dat", freq)
        secs = verb(["a2e_pre", "gs_TST2.dust", "freq.dat", "tst2_pre.solver",
                     "128"])
        with open("tst2_pre.solver", "rb") as f1, \
                open("gs_TST2.solver", "rb") as f2:
            if f1.read() != f2.read():
                fail("phase 16: (d) a2e_pre's solver differs from the "
                     "pipeline's")
        print("phase 16: (d) a2e_pre gs_TST2 at NE 128: %.2f s, the .solver "
              "equal bit for bit to the pipeline's" % secs, flush=True)

        write_cell_frequency_array("tst_abs.data", abs_tst)
        ref = stochastic.solve_emission(sol, abs_tst, dev)
        # the profiler's CUDA activity is at times missing from a
        # session: up to 3 tries, as phase 7's device timing takes
        for tries in range(1, 4):
            a2e_kernel.launches = 0
            secs = verb(["a2e", "gs_TST.solver", "tst_abs.data",
                         "tst_emit.data", "--profile=a2e_profile"] + dv)
            n_cli = a2e_kernel.launches
            with open(os.path.join("a2e_profile", "trace_a2e.json")) as fp:
                named = "a2e_all_sizes" in fp.read()
            if named:
                break
        batch = max(1 << 16, (64 << 20) // (44 * 4) // 16384 * 16384)
        got = read_cell_frequency_array("tst_emit.data")
        a2e_kernel.launches = 0
        stochastic.solve_emission_streaming(
            sol, "tst_abs.data", "tst_emit64k.data", dev, batch=1 << 16)
        n_64k = a2e_kernel.launches
        got64 = read_cell_frequency_array("tst_emit64k.data")
        rng = np.random.default_rng(args.seed)
        aalg = np.exp(rng.uniform(np.log(sol.size_a[0] / 3.0),
                                  np.log(3.0 * sol.size_a[-1]),
                                  OCTREE_CELLS)).astype(np.float32)
        with open("aalg_a2e.bin", "wb") as fp:
            np.int32(OCTREE_CELLS).tofile(fp)
            aalg.tofile(fp)
        ifreq = int(emit_ch[0])
        verb(["a2e", "gs_TST.solver", "tst_abs.data", "tst_emit1.data", "0",
              "999", str(ifreq), "aalg_a2e.bin"] + dv)
        one = read_cell_frequency_array("tst_emit1.data")
        pone = read_cell_frequency_array("tst_emit1.data.P")
        errs = (float(np.abs(got - ref).max() / ref.max()),
                float(np.abs(got64 - ref).max() / ref.max()),
                float(np.abs(one[:, 0] - ref[:, ifreq]).max()
                      / ref[:, ifreq].max()))
        chunks = (-(-OCTREE_CELLS // batch), -(-OCTREE_CELLS // (1 << 16)))
        print("phase 16: (d) a2e on gs_TST's share: %.2f s under --profile "
              "(%d launch(es) for %d chunk(s) of %d rows; the trace names "
              "a2e_all_sizes: %s, try %d); in 65,536-row chunks %d launches "
              "for %d; IFREQ %d with aalg: %s and .P %s; max |diff| / max "
              "against the in-memory solve %.3e, %.3e, %.3e" % (
                  secs, n_cli, chunks[0], batch, named, tries, n_64k,
                  chunks[1], ifreq, one.shape, pone.shape, *errs),
              flush=True)
        if (n_cli, n_64k) != chunks or not named or max(errs) > 1e-6 \
                or one.shape != (OCTREE_CELLS, 1) \
                or pone.shape != (OCTREE_CELLS, 1) \
                or not (np.isfinite(pone).all() and pone.min() >= 0.0):
            fail("phase 16: (d) the a2e verb is off")

        ref_idx = list(lib["ref_indices"])
        np.savetxt("lfreq.dat", freq[ref_idx])
        np.savetxt("ofreq.dat", freq[emit_ch[:2]])
        write_cell_frequency_array("tst_abs3.data",
                                   np.ascontiguousarray(abs_tst[:, ref_idx]))
        lib_args = ["a2e_lib", "gs_TST.solver", "tst.lib", "freq.dat",
                    "lfreq.dat"]
        secs = verb(lib_args + ["tst_abs.data", "lib_full.data", "makelib"]
                    + dv)
        secs += verb(lib_args + ["tst_abs.data", "lib_use.data"] + dv)
        secs += verb(lib_args + ["tst_abs3.data", "lib_use3.data"] + dv)
        secs += verb(lib_args + ["tst_abs.data", "lib_sel.data", "ofreq.dat"]
                     + dv)
        full = read_cell_frequency_array("lib_full.data")
        use = read_cell_frequency_array("lib_use.data")
        use3 = read_cell_frequency_array("lib_use3.data")
        lsel = read_cell_frequency_array("lib_sel.data")
        errs = (float(np.abs(full - ref).max() / ref.max()),
                float(np.abs(use3 - use).max() / use.max()),
                float(np.abs(lsel - use[:, emit_ch[:2]]).max() / use.max()))
        print("phase 16: (d) a2e_lib makelib, uselib on the full and on the "
              "3-column file, ofreq: %.2f s; max |diff| / max: makelib "
              "against the solve %.3e, the 3-column file against the full "
              "%.3e, ofreq's columns %.3e" % (secs, *errs), flush=True)
        if max(errs) > 1e-6 or lsel.shape != (OCTREE_CELLS, 2):
            fail("phase 16: (d) the a2e_lib verb is off")

        secs = verb(["mabu", ini, "absorbed_full.data", "mabu_emit.data"]
                    + dv)
        secs += verb(["mabu", ini, "absorbed_full.data", "mabu_sel.data",
                      "ofreq.dat"] + dv)
        e_m = read_cell_frequency_array("mabu_emit.data")
        e_ms = read_cell_frequency_array("mabu_sel.data")
        print("phase 16: (d) mabu, then with an ofreq file: %.2f s; (a)'s "
              "emitted.data equal bit for bit: %s; ofreq's columns: %s"
              % (secs, np.array_equal(e_m, e_a),
                 np.array_equal(e_ms, e_a[:, emit_ch[:2]])), flush=True)
        if not (np.array_equal(e_m, e_a)
                and np.array_equal(e_ms, e_a[:, emit_ch[:2]])):
            fail("phase 16: (d) the mabu verb differs from (a)'s emission")

        write_cell_frequency_array("abs_clean.data", clean)
        secs = verb(["eqsolve", "TST_simple.dust", "abs_clean.data",
                     "eq_emit.data"])
        temp = np.fromfile("TST_simple.dust.T", np.float32)
        e_eq = read_cell_frequency_array("eq_emit.data")
        t_leaf = temp[~parents]
        pct = np.percentile(t_leaf, (1, 50, 99))
        print("phase 16: (d) eqsolve on the equilibrium dust: %.2f s, leaf "
              "temperatures %.2f-%.2f K (1st, 50th, 99th percentiles %.2f, "
              "%.2f, %.2f K)" % (secs, t_leaf.min(), t_leaf.max(), *pct),
              flush=True)
        # the background alone heats these cells (no dust self-heating, as
        # in phase 10's rt): the shielded core falls below phase 10's
        # 3.1 K, to the E<->T table's 1 K floor at worst
        if not (np.isfinite(e_eq).all() and 1.0 <= t_leaf.min()
                and t_leaf.max() <= 200.0 and 3.0 <= pct[1] <= 30.0):
            fail("phase 16: (d) eqsolve's temperatures are off")

        dd = os.path.join(sub, "dustem")
        os.makedirs(dd)
        _dustem_files(dd, np.logspace(np.log10(0.1), np.log10(3000.0), 16))
        with open(os.path.join(dd, "GRAIN.DAT"), "w") as fp:
            fp.write("# a DustEM grain model\n%s\n" % GRAIN_LINE.format(
                nsize=8))
        np.savetxt(os.path.join(dd, "freq.dat"), frequencies(16))
        os.chdir(dd)
        secs = verb(["dust", "GRAIN.DAT", "freq.dat", "32", "0.01"])
        secs += verb(["sampleini", "sample.ini"])
        made = [f for f in ("TST_simple.dust", "TST.dsc", "gs_TST.dust",
                            "TST.solver", "tmp.dust", "tmp.dsc", "sample.ini")
                if os.path.exists(f) and os.path.getsize(f) > 0]
        out["d"] = time.time() - t_d
        print("phase 16: (d) dust and sampleini in a scratch directory: "
              "%.2f s, wrote %s; (d) %.2f s in all" % (secs, made, out["d"]),
              flush=True)
        if len(made) != 7:
            fail("phase 16: (d) dust / sampleini wrote %s" % made)
    finally:
        os.chdir(HERE)


def _ckpt_done(path):
    """The unit keys a checkpoint file lists (none while it is absent);
    os.replace makes a file visible whole, so a read never sees half."""
    if not os.path.exists(path):
        return []
    with np.load(path) as z:
        return [str(k) for k in z["done"]]


def _kill_when(cmd, cwd, ckpt, cond, log, tag, timeout=600.0):
    """Start ``cmd`` and SIGKILL it once cond(units the checkpoint lists)
    holds, polling every 50 ms; the process is waited for in any case.
    Fails when it ends by itself first. Returns (seconds, units)."""
    t0 = time.time()
    with open(log, "wb") as err:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=err, stderr=err)
        try:
            while proc.poll() is None:
                done = _ckpt_done(ckpt)
                if cond(done):
                    proc.kill()
                    proc.wait()
                    return time.time() - t0, done
                if time.time() - t0 > timeout:
                    fail("phase 17: (%s) no unit to kill after within %.0f "
                         "s" % (tag, timeout))
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as fp:
        print(fp.read()[-2000:], flush=True)
    fail("phase 17: (%s) the process ended (code %d) before it was killed"
         % (tag, proc.returncode))


def _flush_lines(tag, text):
    """Each checkpoint flush's units, bytes and seconds out of a run's
    stderr; returns the lines about skipped units."""
    for line in text.splitlines():
        if "flushed" in line:
            print("phase 17: (%s) %s" % (tag, line.strip()), flush=True)
    return [line for line in text.splitlines() if "skipping" in line]


def _held(tag, name, got, want):
    """got within phase 4's rerun bound of want (PRODUCT_RTOL or
    PRODUCT_ATOL of the maximum); fails beyond it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = got.shape == want.shape and np.isfinite(got).all() and np.allclose(
        got, want, rtol=PRODUCT_RTOL, atol=PRODUCT_ATOL * np.abs(want).max())
    err = float(np.abs(got - want).max() / np.abs(want).max()) \
        if got.shape == want.shape else float("inf")
    print("phase 17: (%s) %s: max |diff| / max = %.3e, within %.0e "
          "relative or %.0e of the max: %s"
          % (tag, name, err, PRODUCT_RTOL, PRODUCT_ATOL, ok), flush=True)
    if not ok:
        fail("phase 17: (%s) %s differs" % (tag, name))


def _run_balance(tag, res, phase="phase 17"):
    """The whole run's energy balance per channel, in signed sums as
    driver.pass_balance forms a cell pass's: (absorbed + escaped + born
    outside + the cell passes' escaped - launched - the cell passes'
    injected) over the absolute weight put in (a channel carrying less
    than BALANCE_FLOOR of the largest's over that share); and each cell
    pass's; fails beyond BALANCE_TOL."""
    from soc_tpu_torch.pipeline import driver
    zero = np.zeros_like(res.absorbed_photons)
    # a run that loads its constant-source heating (`cload`) has no source
    # pass: nothing launched or born outside
    launched = zero if res.launched is None else res.launched
    missed = zero if res.missed is None else res.missed
    esc = res.escaped + missed + sum(st["escaped"] for st in res.cell_passes)
    inj = launched + sum(st["injected"] for st in res.cell_passes)
    put = launched + sum(st["injected_abs"] for st in res.cell_passes)
    den = np.maximum(put, driver.BALANCE_FLOOR * put.max())
    bal = (res.absorbed_photons + esc - inj) / den
    cells = [float(np.abs(driver.pass_balance(st)).max())
             for st in res.cell_passes]
    print(phase + ": (%s) energy balance per channel: max |.| = %.3e; cell "
          "passes %s (tolerance %.1e)"
          % (tag, np.abs(bal).max(), ", ".join("%.3e" % b for b in cells),
             BALANCE_TOL), flush=True)
    if not np.abs(bal).max() <= BALANCE_TOL \
            or not all(b <= BALANCE_TOL for b in cells):
        fail(phase + ": (%s) energy balance off" % tag)


def checkpoint_phase(dev, work, args, report, ali_one):
    """Phase 17: checkpoint/resume on one card; over phase 9's six shards
    against one card phase 10 (b)'s iterated ALI run (``ali_one``, its
    RunResult) and the constant sources with every keyword; the pipeline
    verb with both."""
    import contextlib
    import io
    import torch
    from soc_tpu_torch import cli
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.pipeline import driver, full
    from soc_tpu_torch.solve import a2e_kernel
    card = report["card"]
    devices = [dev] * PRODUCT_SHARDS
    times = report["ckpt"] = {}
    common = dict(npix=64, map_dx=N / 64.0, octree=OCTREE,
                  bgpac=args.bgpackets // 4)

    # (a) rt killed twice, then run to its end
    t0 = time.time()
    kw = dict(kind="eqdust", nfreq=44, cellpackets=EMWEI_PACKETS,
              iterations=2, **common)
    d_ref, d_ck = (os.path.join(work, "ckpt_" + s) for s in ("ref", "rt"))
    ini_ref = write_model(d_ref, N, **kw)
    ini = write_model(d_ck, N, extra="checkpoint ck.npz 1\n", **kw)
    ck = os.path.join(d_ck, "ck.npz")
    cmd = [sys.executable, "-m", "soc_tpu_torch", "rt", ini, "--device",
           str(dev)]
    secs, done = _kill_when(cmd, HERE, ck, lambda u: "bg" in u,
                            os.path.join(work, "ckpt_kill1.log"), "a")
    print("phase 17: (a) rt killed after %.2f s, the file listing %s"
          % (secs, done), flush=True)
    first = len(done)
    secs, done = _kill_when(
        cmd, HERE, ck, lambda u: "iter0" in u and len(u) > first,
        os.path.join(work, "ckpt_kill2.log"), "a")
    print("phase 17: (a) rerun killed after %.2f s, the file listing %s"
          % (secs, done), flush=True)
    for k in (1, 2):
        with open(os.path.join(work, "ckpt_kill%d.log" % k)) as fp:
            _flush_lines("a, run %d" % k, fp.read())
    results, err = {}, io.StringIO()
    t1 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["rt", ini, "--device", str(dev)], results)
    torch.cuda.synchronize()
    wall = time.time() - t1
    if rc != 0:
        fail("phase 17: (a) the resumed rt verb returned %d" % rc)
    skipped = _flush_lines("a, resumed", err.getvalue())
    for line in skipped:
        print("phase 17: (a) resumed: %s" % line.strip(), flush=True)
    if not skipped:
        fail("phase 17: (a) the resumed run skipped no unit")
    res = results["rt"]
    t1 = time.time()
    ref = driver.run(ini_ref, device=dev)
    torch.cuda.synchronize()
    print("phase 17: (a) resumed run %.2f s, skipped %d units; the "
          "uninterrupted run %.2f s [%s]"
          % (wall, len(skipped), time.time() - t1, card), flush=True)
    for name in ("absorbed", "emitted", "temperature"):
        _held("a", name, getattr(res, name), getattr(ref, name))
    _held("a", "map", res.maps[0], ref.maps[0])
    _run_balance("a", res)
    fl = res.checkpoint.flushes
    print("phase 17: (a) the resumed run's %d flushes: %s; the file %d "
          "bytes [%s]" % (len(fl), ", ".join("%.3f s" % s for s, _ in fl),
                          os.path.getsize(ck), card), flush=True)
    times["a"] = time.time() - t0

    # (b1) phase 10 (b), ALI with the reference field iterated, over the
    # six shards against phase 10's one-card run: the same packets
    t0 = time.time()
    d = os.path.join(work, "ckpt_b1")
    ini = write_model(
        d, N, kind="eqdust", nfreq=44, npix=64, bgpac=args.bgpackets,
        map_dx=N / 64.0, octree=OCTREE, cellpackets=CELLPACKETS,
        iterations=3, extra="ali 1\nreference 1\ncload %s\n" % os.path.join(
            work, "octree_rt_a", "ctabs.save"))
    res = driver.run(ini, device=dev, devices=devices)
    torch.cuda.synchronize()
    if res.devices != devices or not all(st["mesh"] and st["route"] == "ali"
                                         for st in res.cell_passes):
        fail("phase 17: (b1) the ALI passes did not run over the mesh")
    for st, st1 in zip(res.cell_passes, ali_one.cell_passes):
        print("phase 17: (b1) iteration %d ALI pass over %d shards: %d "
              "packets in %d pools, %.2f s (%.0f packets/s); on one card %d "
              "pool(s), %.2f s (%.0f packets/s) [%s]"
              % (st["iteration"], PRODUCT_SHARDS, st["packets"], st["pools"],
                 st["seconds"], st["packets"] / st["seconds"], st1["pools"],
                 st1["seconds"], st1["packets"] / st1["seconds"], card),
              flush=True)
    for name in ("absorbed", "emitted", "temperature"):
        _held("b1", name, getattr(res, name), getattr(ali_one, name))
    _held("b1", "map", res.maps[0], ali_one.maps[0])
    _run_balance("b1", res)
    times["b1"] = time.time() - t0

    # (b2) the constant sources with `split 4`, two dusts' abundances, the
    # ROI save and mmapabs, (b3) without splitting under the mirrors and
    # the weighting, both over MESH_SIMUM, over the six shards and on one
    # card
    from soc_tpu_torch.solve import equilibrium
    for part, kw in (("b2", dict(split=SPLIT, abundance=True, hpbg=SKY_NSIDE,
                                 hpbg_weighted=True,
                                 point_sources=POINT_SOURCES,
                                 ps_method=PS_METHOD,
                                 pspackets=MESH_PSPACKETS,
                                 diffuse=DIFFUSE_SHARE,
                                 dfpackets=OCTREE_CELLS,
                                 extra="roi %d %d %d %d %d %d\nroisave "
                                 "roi.bin %d\nmmapabs\n"
                                 % (ROI_BOX + (ROI_NSIDE,)))),
                     ("b3", dict(extra="mirror %s\nstepweight 2 1.3 0.4\n"
                                 "direweight 1 0.5\n" % MIRROR))):
        t0 = time.time()
        runs = {}
        for where in ("one", "mesh"):
            ini = write_model(
                os.path.join(work, "ckpt_%s_%s" % (part, where)), N,
                kind="eqdust", nfreq=44, simum=MESH_SIMUM, **kw, **common)
            r = runs[where] = driver.run(
                ini, device=dev, devices=devices if where == "mesh" else None)
            torch.cuda.synchronize()
            if part == "b2":
                source_balance("%s, %s" % (part, where), r, card, "phase 17")
                continue
            # the step and direction weights keep the balance only in
            # expectation (phase 13 (c1) holds their bias)
            for st in r.source_passes:
                print("phase 17: (%s, %s) %s: %d packets in %d pool(s), %.2f "
                      "s (%.0f packets/s) [%s]"
                      % (part, where, st["source"], st["packets"],
                         st["pools"], st["seconds"],
                         st["packets"] / st["seconds"], card), flush=True)
        one, mesh = runs["one"], runs["mesh"]
        if [st["route"] for st in mesh.source_passes] \
                != ["mesh"] * len(one.source_passes):
            fail("phase 17: (%s) a source did not run over the mesh" % part)
        refined = np.nonzero(
            (equilibrium.cell_levels(one.grid).cpu().numpy() > 0)
            & (one.grid.dens.cpu().numpy() > 0))[0]
        for st1, stm in zip(one.source_passes, mesh.source_passes):
            if stm["clones"] == 0:
                # every packet keeps its stream: the pass's own TABS (its
                # deposits alone, whatever the sources before it left)
                _held(part, "%s's absorbed energy a cell" % st1["source"],
                      stm["tabs"], st1["tabs"])
                continue
            # the split sources' refined leaves as phase 12 (a) holds
            # them; where both serve the same clones the difference is
            # the order of the additions, which PRODUCT_RTOL takes
            diff = stm["tabs"][refined].astype(np.float64) \
                - st1["tabs"][refined].astype(np.float64)
            sigma = np.sqrt(np.sum(np.array(
                [g.sum() for g in np.array_split(diff, 64)]) ** 2))
            refsum = st1["tabs"][refined].astype(np.float64).sum()
            bound = SPLIT_SIGMAS * sigma + PRODUCT_RTOL * refsum
            print("phase 17: (%s) %s split over %d shards, its %d refined "
                  "leaves: difference %.3e of the one-card run's, bound %.1f "
                  "sigma + %.0e = %.3e; clones %d over the mesh, %d on one "
                  "card" % (part, st1["source"], PRODUCT_SHARDS, len(refined),
                            diff.sum() / refsum, SPLIT_SIGMAS, PRODUCT_RTOL,
                            bound / refsum, stm["clones"], st1["clones"]),
                  flush=True)
            if st1["clones"] == 0 or not abs(diff.sum()) <= bound:
                fail("phase 17: (%s) the split %s disagrees"
                     % (part, st1["source"]))
        if part == "b2":
            if not any(st["clones"] for st in mesh.source_passes):
                fail("phase 17: (b2) no source split over the mesh")
            roi1, roim = one.roi_tally.sum(), mesh.roi_tally.sum()
            print("phase 17: (b2) the ROI file's photons: %.6e over the "
                  "mesh, %.6e on one card" % (roim, roi1), flush=True)
            if not (np.isfinite(mesh.roi_tally).all()
                    and mesh.roi_tally.min() >= 0
                    and abs(roim / roi1 - 1) <= ROI_MESH_RTOL):
                fail("phase 17: (b2) the ROI file disagrees")
        else:
            for name in ("absorbed", "temperature"):
                _held(part, name, getattr(mesh, name), getattr(one, name))
        times[part] = time.time() - t0

    # (c) phase 11's pipeline (the GSET dust, a quarter of `bgpackets`)
    # over the six shards with `checkpoint`, killed once its absorption
    # stage has recorded its unit, resumed; held to phase 11's one card
    t0 = time.time()
    d_ck = os.path.join(work, "ckpt_pipeline")
    ini = write_model(d_ck, N, kind="gset", nfreq=44, nsize=24,
                      extra="checkpoint ck.npz 1\n", **common)
    shutil.copy(os.path.join(work, "gs_TST.solver"), d_ck)
    ck = os.path.join(d_ck, "ck.npz")
    code = ("import sys; from soc_tpu_torch.pipeline import full; "
            "full.run_pipeline(sys.argv[1], %r, devices=[%r] * %d)"
            % (str(dev), str(dev), PRODUCT_SHARDS))
    secs, done = _kill_when([sys.executable, "-c", code, ini], HERE, ck,
                            lambda u: "bg" in u,
                            os.path.join(work, "ckpt_kill3.log"), "c")
    print("phase 17: (c) pipeline killed after %.2f s, the file listing %s"
          % (secs, done), flush=True)
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    err = io.StringIO()
    t1 = time.time()
    with contextlib.redirect_stderr(err):
        res_rt, _, res_map = full.run_pipeline(ini, dev, devices=devices)
    torch.cuda.synchronize()
    launches = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    skipped = _flush_lines("c, resumed", err.getvalue())
    print("phase 17: (c) resumed pipeline over %d shards %.2f s (A2E %.2f "
          "s): skipped %s; A2E launches %d a2e_all_sizes, %d a2e_clamp [%s]"
          % (PRODUCT_SHARDS, time.time() - t1, res_map.timings["a2e"],
             [line.split()[-1] for line in skipped], *launches, card),
          flush=True)
    if launches != (PRODUCT_SHARDS, 0) or not skipped:
        fail("phase 17: (c) expected one A2E launch a shard and a skipped "
             "unit on the resumed run")
    report["a2e_sharded"]["ckpt_launches"] = launches[0]
    for name in ("emitted.data", "absorbed.data"):
        _held("c", name + " against phase 11's one card",
              read_cell_frequency_array(os.path.join(d_ck, name)),
              read_cell_frequency_array(os.path.join(work, "octree_pipeline",
                                                     name)))
    times["c"] = time.time() - t0


def _domain_rule(tag, name, got, want):
    """Phase 18: got against want by the rule for domain runs (its total
    within DOMAIN_RTOL, DOMAIN_SHARE of the entries within DOMAIN_RTOL
    relative or DOMAIN_ATOL of the maximum); fails beyond it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail("phase 18: (%s) %s: shape %s or not finite" % (tag, name,
                                                           got.shape))
    # the absorbed files mark the parent rows -1e20 (equal in both)
    keep = want > -1e19
    if not (got[~keep] == want[~keep]).all():
        fail("phase 18: (%s) %s: the parents' rows differ" % (tag, name))
    got, want = got[keep], want[keep]
    tot = abs(got.sum() - want.sum()) / abs(want.sum())
    share = np.isclose(got, want, rtol=DOMAIN_RTOL,
                       atol=DOMAIN_ATOL * np.abs(want).max()).mean()
    print("phase 18: (%s) %s: total %.3e off, %.5f of the entries within "
          "%.0e relative or %.0e of the max (at least %.2f)"
          % (tag, name, tot, share, DOMAIN_RTOL, DOMAIN_ATOL, DOMAIN_SHARE),
          flush=True)
    if not (tot <= DOMAIN_RTOL and share >= DOMAIN_SHARE):
        fail("phase 18: (%s) %s differs from one card" % (tag, name))


def _domain_passes(tag, one, dom, card, out):
    """Phase 18: each pass over the slabs beside one card's: seconds,
    packets/s, supersteps, emigrants a superstep, the queue's peak;
    returns the lines' numbers (in ``out`` under the tag)."""
    rows = out.setdefault(tag, [])
    for so, sd in zip(one.source_passes + one.cell_passes,
                      dom.source_passes + dom.cell_passes):
        d = sd.get("domain")
        if sd["slabs"] != DOMAIN_SLABS or d is None:
            fail("phase 18: (%s) a pass did not run over the slabs" % tag)
        name = sd.get("source") or "cell pass %d (%s)" % (sd["iteration"],
                                                          sd["route"])
        print("phase 18: (%s) %s over %d slabs: %d packets, %.2f s (%.0f "
              "packets/s); on one card %.2f s (%.0f packets/s); %d "
              "supersteps of %d lanes a slab, emigrants a superstep mean "
              "%.0f, peak %d, pending queue peak %d of %d [%s]"
              % (tag, name, DOMAIN_SLABS, sd["packets"], sd["seconds"],
                 sd["packets"] / sd["seconds"], so["seconds"],
                 so["packets"] / so["seconds"], d["supersteps"], d["lanes"],
                 d["emigrants_mean"], d["emigrants_peak"], d["queue_peak"],
                 4 * d["lanes"], card), flush=True)
        rows.append((name, sd["seconds"], so["seconds"], d["supersteps"],
                     d["emigrants_mean"], d["emigrants_peak"],
                     d["queue_peak"]))


def domains_phase(dev, work, args, report):
    """Phase 18: `domains 4` over cuda:0 four times on phase 10's octree
    against one card (the docstring's (a)-(c))."""
    import torch
    from soc_tpu_torch.example_model import write_model
    from soc_tpu_torch.pipeline import driver, full
    from soc_tpu_torch.solve import a2e_kernel, equilibrium
    card = report["card"]
    slabs = [dev] * DOMAIN_SLABS
    times = report["domains"] = {}
    rows = {}
    common = dict(npix=64, map_dx=N / 64.0, octree=OCTREE)

    def pair(tag, **kw):
        runs = {}
        for where in ("one", "dom"):
            ini = write_model(os.path.join(work, "dom_%s_%s" % (tag, where)),
                              N, kind="eqdust", nfreq=44, **dict(common, **kw))
            runs[where] = driver.run(
                ini, device=dev, domains=slabs if where == "dom" else None)
            torch.cuda.synchronize()
        if runs["dom"].domains != slabs or runs["one"].domains is not None:
            fail("phase 18: (%s) the runs' slabs: %s" % (tag,
                                                       runs["dom"].domains))
        _domain_passes(tag, runs["one"], runs["dom"], card, rows)
        return runs["one"], runs["dom"]

    # (a) one ALI cell pass, one packet a cell and channel, from phase 10
    # (a)'s background heating: (b) runs the background over the slabs
    t0 = time.time()
    one, dom = pair("a", cellpackets=OCTREE_CELLS, iterations=2,
                    extra="ali 1\ncload %s\n" % os.path.join(
                        work, "octree_rt_a", "ctabs.save"))
    if [st["route"] for st in dom.cell_passes] != ["ali"]:
        fail("phase 18: (a) expected one ALI cell pass")
    for name in ("absorbed", "emitted", "temperature"):
        _domain_rule("a", name, getattr(dom, name), getattr(one, name))
    _domain_rule("a", "map", dom.maps[0], one.maps[0])
    _run_balance("a", dom, "phase 18")
    times["a"] = time.time() - t0

    # (b) phase 11's pipeline with the domains list: one A2E launch on
    # the assembled tallies, emitted.data against phase 11's one card
    t0 = time.time()
    sub = os.path.join(work, "dom_pipeline")
    ini = write_model(sub, N, kind="gset", nfreq=44, nsize=24,
                      bgpac=args.bgpackets // 4, **common)
    shutil.copy(os.path.join(work, "gs_TST.solver"), sub)
    a2e_kernel.launches = a2e_kernel.clamp_launches = 0
    res_rt, _, res_map = full.run_pipeline(ini, dev, domains=slabs)
    torch.cuda.synchronize()
    launches = (a2e_kernel.launches, a2e_kernel.clamp_launches)
    st = res_rt.source_passes[0]
    print("phase 18: (b) pipeline over %d slabs: absorption %.2f s (%d "
          "packets, %.0f packets/s; phase 11's one card %.2f s), %d "
          "supersteps, A2E %.2f s, %d a2e_all_sizes and %d a2e_clamp "
          "launch(es), total %.2f s [%s]"
          % (DOMAIN_SLABS, st["seconds"], st["packets"],
             st["packets"] / st["seconds"],
             report["stages_octree"]["absorption_s"],
             st["domain"]["supersteps"], res_map.timings["a2e"], *launches,
             time.time() - t0, card), flush=True)
    if launches != (1, 0) or res_rt.domains != slabs:
        fail("phase 18: (b) expected one a2e_all_sizes launch after the "
             "slabs' absorption run")
    report["a2e_all_sizes"]["domain_launches"] = launches[0]
    for name in ("emitted.data", "absorbed.data"):
        _domain_rule("b", name + " against phase 11's one card",
                     read_cell_frequency_array(os.path.join(sub, name)),
                     read_cell_frequency_array(os.path.join(
                         work, "octree_pipeline", name)))
    times["b"] = time.time() - t0

    # (c) the constant sources over MESH_SIMUM under the bottom mirror and
    # two dusts' abundances
    t0 = time.time()
    one, dom = pair("c", bgpac=args.bgpackets // 16, simum=MESH_SIMUM,
                    split=SPLIT, abundance=True, hpbg=SKY_NSIDE,
                    hpbg_weighted=True, point_sources=POINT_SOURCES,
                    ps_method=PS_METHOD, pspackets=MESH_PSPACKETS,
                    diffuse=DIFFUSE_SHARE, dfpackets=OCTREE_CELLS // 4,
                    cellpackets=OCTREE_CELLS,
                    extra="mirror %s\nemweight 1 0 100\n" % DOMAIN_MIRROR)
    if [st["route"] for st in one.source_passes if st["source"] == "diffuse"] \
            != ["emweight"]:
        fail("phase 18: (c) the diffuse field did not run EMWEI")
    source_balance("c, slabs", dom, card, "phase 18")
    refined = np.nonzero(
        (equilibrium.cell_levels(one.grid).cpu().numpy() > 0)
        & (one.grid.dens.cpu().numpy() > 0))[0]
    if not any(st["clones"] for st in dom.source_passes):
        fail("phase 18: (c) no source split over the slabs")
    for so, sd in zip(one.source_passes, dom.source_passes):
        if sd["clones"] == 0:
            _domain_rule("c", "%s's absorbed energy a cell" % so["source"],
                         sd["tabs"], so["tabs"])
            continue
        diff = sd["tabs"][refined].astype(np.float64) \
            - so["tabs"][refined].astype(np.float64)
        sigma = np.sqrt(np.sum(np.array(
            [g.sum() for g in np.array_split(diff, 64)]) ** 2))
        refsum = so["tabs"][refined].astype(np.float64).sum()
        print("phase 18: (c) %s split over the slabs, its %d refined "
              "leaves: difference %.3e of one card's, bound %.1f sigma = "
              "%.3e; clones %d over the slabs, %d on one card"
              % (so["source"], len(refined), diff.sum() / refsum,
                 SPLIT_SIGMAS, SPLIT_SIGMAS * sigma / refsum, sd["clones"],
                 so["clones"]), flush=True)
        if so["clones"] == 0 or not abs(diff.sum()) <= SPLIT_SIGMAS * sigma:
            fail("phase 18: (c) the split %s disagrees" % so["source"])
    times["c"] = time.time() - t0
    report["domain_rows"] = rows

def _rank_dirs(work, tag, n, extra, args):
    """One directory a process, each with phase 9's model (`devices` in
    ``extra``): process 0's gets phase 4's .solver (a copy), the others
    links to the files process 0 would have written into a shared
    directory before they read them (the .solver, the simple dust)."""
    from soc_tpu_torch.example_model import write_model
    dirs = []
    for k in range(n):
        d = os.path.join(work, "%s_r%d" % (tag, k))
        write_model(d, N, kind="gset", nfreq=44, nsize=24, npix=64,
                    bgpac=args.bgpackets, map_dx=N / 64.0, extra=extra)
        dirs.append(d)
    shutil.copy(os.path.join(work, "gs_TST.solver"), dirs[0])
    for d in dirs[1:]:
        for name in ("gs_TST.solver", "TST_simple.dust"):
            os.symlink(os.path.join(work, "devices", name),
                       os.path.join(d, name))
    return dirs


def _run_ranks(tag, dirs, cards, card, argv=("pipeline", "run.ini"),
               code=RANK_CODE, env_extra=None, phase="phase 19"):
    """A verb (``argv``, run by ``code``: the `pipeline` verb by default)
    as len(dirs) processes of one group (soc_tpu's variables), process k
    in dirs[k] on card cards[k] (and ``env_extra``); each has MP_TIMEOUT
    seconds, and any failure kills the others and fails the phase with
    their stderr. Returns (RESULT dicts in rank order, wall)."""
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    t0 = time.time()
    for k, d in enumerate(dirs):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(cards[k]),
                   PYTHONPATH=HERE, SOC_TPU_COORDINATOR="127.0.0.1:%d" % port,
                   SOC_TPU_NUM_PROCESSES=str(len(dirs)),
                   SOC_TPU_PROCESS_ID=str(k),
                   SOC_TPU_DIST_TIMEOUT=str(MP_GROUP_TIMEOUT),
                   **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *argv],
            cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out, errs = [None] * len(procs), [""] * len(procs)
    try:
        for k, p in enumerate(procs):
            try:
                stdout, errs[k] = p.communicate(
                    timeout=max(1.0, MP_TIMEOUT - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                errs[k] = "timed out after %d s" % MP_TIMEOUT
                break
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if p.returncode != 0 or not line:
                break
            out[k] = json.loads(line[0][7:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.time() - t0
    if any(r is None for r in out):
        fail("%s %s: a process failed:\n%s" % (phase, tag, "\n".join(
            "--- process %d (rc %s):\n%s" % (k, p.returncode, e[-2500:])
            for k, (p, e) in enumerate(zip(procs, errs)) if e)))
    return out, wall


def _print_ranks(tag, out, card):
    """Phase 19's line a process: its stages, spans and collectives."""
    for r in out:
        print("phase 19 %s: process %d of %d: absorption %.2f s, A2E %.2f "
              "s, maps %.2f s, wall %.2f s; transport passes' device "
              "spans (CUDA events) %s s; in collectives %.3f s; "
              "a2e_all_sizes %d, a2e_clamp %d launches [%s]"
              % (tag, r["rank"], r["size"], r["absorption_s"], r["a2e_s"],
                 r["maps_s"], r["wall_s"],
                 ", ".join("%.3f" % x for x in r["spans"]),
                 r["collectives_s"], r["launches"], r["clamp"], card),
              flush=True)


def _hold_ranks(tag, out, dirs, before, ref):
    """Phase 19's checks: every process's balance, launches and digests;
    process 0's files against ``ref`` within the rerun bound; the other
    processes wrote nothing."""
    for r in out:
        if r["rc"] != 0 or r["foreign"]:
            fail("phase 19 %s: process %d: rc %s, imported %s"
                 % (tag, r["rank"], r["rc"], r["foreign"]))
        if r["balance"] > BALANCE_TOL:
            fail("phase 19 %s: process %d's energy balance %.3e"
                 % (tag, r["rank"], r["balance"]))
        if (r["launches"], r["clamp"]) != (1, 0):
            fail("phase 19 %s: process %d launched a2e_all_sizes %d and "
                 "a2e_clamp %d times (expected 1 and 0)"
                 % (tag, r["rank"], r["launches"], r["clamp"]))
        for key in ("absorbed", "emitted"):
            if r[key] != out[0][key]:
                fail("phase 19 %s: process %d's %s differs from process "
                     "0's" % (tag, r["rank"], key))
    print("phase 19 %s: every process holds the same absorbed and emitted "
          "arrays (sha256 %s, %s); balance max %.3e (tolerance %.1e)"
          % (tag, out[0]["absorbed"], out[0]["emitted"],
             max(r["balance"] for r in out), BALANCE_TOL), flush=True)
    readers = {"absorbed.data": read_cell_frequency_array,
               "emitted.data": read_cell_frequency_array,
               "map_dir_00.bin": read_map_file}
    for name, read in readers.items():
        got, want = read(os.path.join(dirs[0], name)), ref[name]
        ok = got.shape == want.shape and np.isfinite(got).all() and \
            np.allclose(got, want, rtol=PRODUCT_RTOL,
                        atol=PRODUCT_ATOL * np.abs(want).max())
        err = float(np.abs(got - want).max() / np.abs(want).max()) \
            if got.shape == want.shape else float("inf")
        print("phase 19 %s: process 0's %s against the one-process run: "
              "max |diff| / max = %.3e, allclose(rtol %.0e, atol %.0e of "
              "the max): %s" % (tag, name, err, PRODUCT_RTOL, PRODUCT_ATOL,
                                ok), flush=True)
        if not ok:
            fail("phase 19 %s: %s differs from the one-process run"
                 % (tag, name))
    for d, files in zip(dirs[1:], before[1:]):
        if sorted(os.listdir(d)) != files:
            fail("phase 19 %s: a process other than 0 wrote into %s: %s"
                 % (tag, d, sorted(set(os.listdir(d)) - set(files))))


def processes_phase(dev, work, args, report, ref):
    """Phase 19: the `pipeline` verb as several processes (parallel/dist.py
    over torch.distributed): (a) MP_RANKS processes on this card, one shard
    each of phase 9's mesh, held to phase 4's outputs ``ref``; (b) one
    process a card, where two or more are visible."""
    import torch
    card = report["card"]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else \
        [str(i) for i in range(torch.cuda.device_count())]
    here = cards[dev.index or 0]
    dirs = _rank_dirs(work, "mp", MP_RANKS, "devices %d\n" % MP_RANKS,
                      args)
    before = [sorted(os.listdir(d)) for d in dirs]
    out, wall = _run_ranks("(a)", dirs, [here] * MP_RANKS, card)
    _print_ranks("(a)", out, card)
    _hold_ranks("(a)", out, dirs, before, ref)
    report["a2e_all_sizes"]["mp_launches"] = [r["launches"] for r in out]
    report["processes"] = dict(a_wall_s=wall, a_absorption_s=max(
        r["absorption_s"] for r in out))
    print("phase 19 (a): %d processes on %s, one shard each (dp 3 x freq "
          "2): wall %.2f s, the slowest absorption %.2f s (phase 9's one "
          "thread over the same mesh: %.2f s) [%s]"
          % (MP_RANKS, dev, wall, report["processes"]["a_absorption_s"],
             report["stages_devices"]["absorption_s"], card), flush=True)
    if len(cards) < 2:
        print("phase 19 (b): needs two cards or more, saw %d: not run"
              % len(cards), flush=True)
        return
    from soc_tpu_torch.pipeline import full
    n = len(cards)
    dirs = _rank_dirs(work, "mpc", n, "devices %d\n" % n, args)
    before = [sorted(os.listdir(d)) for d in dirs]
    out, wall = _run_ranks("(b)", dirs, cards, card)
    _print_ranks("(b)", out, card)
    _hold_ranks("(b)", out, dirs, before, ref)
    # the same mesh from one host thread in this process, for the
    # comparison within this call
    thread = _rank_dirs(work, "mpc_thread", 1, "", args)[0]
    res_rt, _, _ = full.run_pipeline(
        os.path.join(thread, "run.ini"), dev,
        devices=[torch.device("cuda", i) for i in range(n)])
    report["processes"].update(
        b_wall_s=wall, b_absorption_s=max(r["absorption_s"] for r in out),
        b_thread_absorption_s=res_rt.timings["constant_sources"])
    print("phase 19 (b): %d processes, one a card: wall %.2f s; the "
          "absorption %s s a process (the slowest %.2f s), each card's "
          "transport span %s s; the same mesh from one host thread %.2f "
          "s, one pool on one card (phase 4) %.2f s; PR 3 run 7 on four "
          "H100s: `devices 4` from one host thread %.3f s, one pool %.3f "
          "s [%s]"
          % (n, wall, ", ".join("%.2f" % r["absorption_s"] for r in out),
             report["processes"]["b_absorption_s"],
             ", ".join("%.3f" % sum(r["spans"]) for r in out),
             report["processes"]["b_thread_absorption_s"],
             report["stages"]["absorption_s"], PR3_THREAD_S, PR3_POOL_S,
             card), flush=True)


def sca_processes_phase(dev, work, report):
    """Phase 20: `sca` with `devices 4` over processes (see the module
    docstring)."""
    import torch
    from soc_tpu_torch.example_model import write_sca_model
    from soc_tpu_torch.pipeline import scattering
    card = report["card"]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    here = (visible.split(",") if visible else
            [str(i) for i in range(torch.cuda.device_count())])[dev.index or 0]

    def model(tag):
        d = os.path.join(work, "sca_mp_" + tag)
        ini = write_sca_model(d, N, nfreq=44, npix=64, map_dx=N / 64.0,
                              octree=OCTREE, simum=SCA_SIMUM_20,
                              bgpac=SCA_BGPACKETS, ffs=1,
                              extra="devices %d\n" % SCA_MP_SHARDS)
        return d, ini

    t0 = time.time()
    _, ini = model("one")
    t1 = time.time()
    one = scattering.run(ini, device=dev, devices=[dev] * SCA_MP_SHARDS)
    torch.cuda.synchronize()
    one_s = time.time() - t1
    print("phase 20: one process, devices %d on %s: %.2f s, maps %s [%s]"
          % (SCA_MP_SHARDS, dev, one_s, one.shape, card), flush=True)
    dirs = [model("r%d" % k)[0] for k in range(SCA_MP_RANKS)]
    before = sorted(os.listdir(dirs[1]))
    shards = ",".join(["0"] * (SCA_MP_SHARDS // SCA_MP_RANKS))
    out, wall = _run_ranks("", dirs, [here] * SCA_MP_RANKS, card,
                           argv=("sca", "run.ini"), code=SCA_RANK_CODE,
                           env_extra=dict(SOC_TPU_LOCAL_DEVICE_IDS=shards),
                           phase="phase 20")
    for r in out:
        print("phase 20: process %d of %d (%d shards on %s): wall %.2f s, "
              "passes %s [%s]" % (
                  r["rank"], r["size"], SCA_MP_SHARDS // SCA_MP_RANKS, dev,
                  r["wall_s"], ", ".join("%s %.2f s (%d packets, %d events)"
                                         % tuple(p) for p in r["passes"]),
                  card), flush=True)
        if r["rc"] != 0 or r["foreign"] or r["size"] != SCA_MP_RANKS:
            fail("phase 20: process %d: rc %s, size %s, imported %s"
                 % (r["rank"], r["rc"], r["size"], r["foreign"]))
        if r["maps"] != out[0]["maps"]:
            fail("phase 20: process %d's maps differ from process 0's"
                 % r["rank"])
    raw = np.fromfile(os.path.join(dirs[0], "outcoming.socs"), np.float32)
    got = raw[3 + 44:].reshape(one.shape)
    diff = float(np.abs(got - one).max() / np.abs(one).max())
    ex = _within(got, one, PRODUCT_RTOL, PRODUCT_ATOL)
    print("phase 20: every process's maps equal (sha256 %s); process 0's "
          "outcoming.socs against the one-process run: bit for bit %s, max "
          "|diff| / max %.3e, excess over 1e-4 relative or 1e-6 of the "
          "peak %.3e (the peel-off's atomics add in another order each "
          "run) [%s]" % (out[0]["maps"], bool(np.array_equal(got, one)),
                         diff, ex, card), flush=True)
    if not np.isfinite(got).all() or one.max() <= 0 or ex > 0:
        fail("phase 20: the processes' maps differ from the one-process "
             "run beyond the rerun bound")
    if sorted(os.listdir(dirs[1])) != before:
        fail("phase 20: process 1 wrote into %s: %s" % (
            dirs[1], sorted(set(os.listdir(dirs[1])) - set(before))))
    report["sca_mp"] = dict(one_s=one_s, ranks_wall_s=wall,
                            total_s=time.time() - t0)
    print("phase 20: two processes' wall %.2f s (each reaches the card "
          "first), one process %.2f s; phase 20 %.2f s [%s]"
          % (wall, one_s, time.time() - t0, card), flush=True)


BENCH_KEYS = dict(      # phase 21: the keys each section must return
    sca=("chord_equivalents", "lane_steps_ffs", "peel_lane_steps_ffs",
         "lane_steps_march", "step_parity"),
    link=("up_mbps", "down_mbps", "up_both", "down_both",
          "serial_ceiling_cells_per_sec", "duplex_ceiling_cells_per_sec"),
    large=("cells", "levels", "gather_melem_per_s", "scatter_melem_per_s",
           "stepping_rate_msteps_per_s",
           "stepping_inloop_bound_msteps_per_s",
           "sol_stepping_fraction_vs_random_floor", "bg_transport_pps",
           "bg_transport_s_all", "bg_channels", "a2e_stream_cells_per_sec",
           "a2e_stream_rows", "a2e_link", "a2e_link_efficiency",
           "a2e_link_efficiency_duplex", "driver_e2e_s",
           "driver_e2e_phases", "driver_e2e_t_range",
           "map_render_s_512x512x44", "sane"),
    xl=("cells", "upload_s", "gather_melem_per_s", "bg_transport_pps",
        "bg_transport_s", "map_render_s_256x256x1", "sane"))


def bench_phase(dev, work, report):
    """Phase 21: the `bench` verb's module (see the module docstring)."""
    import torch
    from soc_tpu_torch import bench
    from soc_tpu_torch.ops import traverse
    from soc_tpu_torch.pipeline import driver
    from soc_tpu_torch.solve import a2e_kernel
    from soc_tpu_torch.transport.sources import background_entry
    card = report["card"]
    t0 = time.time()
    bw = os.path.join(work, "bench")
    bench.prepare_workdir(bw)
    # (a) the march's block form, one CUDA graph a block, against the
    # step-by-step form on the soc_example grid
    grid, _ = bench.load_workload(bw, dev)
    rng = np.random.default_rng(7)
    stream = torch.as_tensor(rng.integers(0, 2**31, 1 << 17,
                                          dtype=np.int64), device=dev)
    pos, d = background_entry(grid.nx, grid.ny, grid.nz, stream, 1, 99)
    lengths, ms = {}, {}
    for block in (1, traverse.MARCH_BLOCK):
        march = traverse.PathMarch(grid, block)
        march(pos, d)                    # warm (and capture the block)
        torch.cuda.synchronize()
        t1 = time.time()
        for _ in range(3):
            lengths[block] = march(pos, d)
        torch.cuda.synchronize()
        ms[block] = (time.time() - t1) / 3 * 1e3
    same = bool(torch.equal(lengths[1], lengths[traverse.MARCH_BLOCK]))
    print("phase 21: (a) march_path_lengths of 131,072 rays on the %d^3 "
          "grid: %s %.3f ms, %s %.3f ms (host clock, synchronised, mean of "
          "3 after a warm-up); bit for bit %s [%s]"
          % (grid.nx, traverse.march_form(dev, 1), ms[1],
             traverse.march_form(dev), ms[traverse.MARCH_BLOCK], same,
             card), flush=True)
    if not same:
        fail("phase 21: (a) the march's block form differs from the "
             "step-by-step form")
    # (b) the sections at cut sizes
    saved = {k: os.environ.get(k) for k in list(BENCH_KNOBS) +
             ["SOC_BENCH_DIR"]}
    os.environ.update(BENCH_KNOBS, SOC_BENCH_DIR=bw)
    try:
        lanes = driver.DEFAULT_LANES
        a2e_kernel.launches = 0
        rates, secs = {}, {}

        def timed_section(name, fn, *args, **kw):
            t1 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] = time.time() - t1
            return out
        tr = timed_section("transport", bench.bench_transport, bw, lanes,
                           repeats=1, device=dev)
        tgrid, medium = tr.pop("grid"), tr.pop("medium")
        rates["bg_transport_pps"] = tr["pps"]
        rates["speed_of_light_pps"] = timed_section(
            "speed_of_light", bench.bench_speed_of_light, tgrid,
            tr["packets"], repeats=1)
        rates["stepping_rate"], rates["stepping_bound"] = timed_section(
            "sol_stepping", bench.bench_sol_stepping, lanes, iters=20,
            device=dev)
        rates["octree3_pps"] = timed_section(
            "octree3", bench.bench_octree, medium, lanes,
            total_packets=1 << 20, repeats=1)
        rates["octree6_pps"] = timed_section(
            "octree6", bench.bench_octree, medium, lanes,
            total_packets=1 << 20, repeats=1, depth=6)
        (rates["sca_peeloff_pps"], rates["sca_march_pps"],
         sca) = timed_section("sca", bench.bench_sca, lanes,
                              total_packets=1 << 16, repeats=1, device=dev)
        (rates["a2e_cells_per_sec"], rates["a2e_device_cells_per_sec"],
         link) = timed_section("a2e", bench.bench_a2e, bw, cells=1 << 14,
                               device=dev)
        scaling = timed_section("scaling", bench.bench_scaling, lanes,
                                total=1 << 14, device=dev)
        rates["map_render_s"] = timed_section(
            "map", bench.bench_map, tgrid, medium,
            np.loadtxt(os.path.join(bw, "freq.dat")), npix=128)
        large = timed_section("large", bench.bench_large, bw,
                              BENCH_CUT_LANES, repeats=1, device=dev)
        xl = timed_section("xl", bench.bench_xl, bw, BENCH_CUT_LANES,
                           device=dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = a2e_kernel.launches
    report["a2e_all_sizes"]["bench_launches"] = launches
    print("phase 21: (b) sections at cut sizes (lanes %d; 16^3 and 32^3 "
          "models at %d): %s; seconds %s; large %s; xl %s; scaling %s; "
          "a2e_all_sizes launched %d times [%s]"
          % (lanes, BENCH_CUT_LANES, json.dumps(rates),
             json.dumps({k: round(v, 2) for k, v in secs.items()}),
             json.dumps(large), json.dumps(xl), json.dumps(scaling),
             launches, card), flush=True)
    missing = [(name, k) for name, got in (("sca", sca), ("link", link),
                                          ("large", large), ("xl", xl))
               for k in BENCH_KEYS[name] if k not in got]
    bad = [k for k, v in rates.items()
           if v is None or not np.isfinite(v) or v <= 0]
    bad += ["large " + k for k in BENCH_KEYS["large"][2:6]
            + ("bg_transport_pps", "a2e_stream_cells_per_sec",
               "driver_e2e_s", "map_render_s_512x512x44")
            if not (np.isfinite(large[k]) and large[k] > 0)]
    # a 16^3 table's gather floor may round the fraction to 0.0
    if not large["sol_stepping_fraction_vs_random_floor"] >= 0:
        bad.append("large sol_stepping_fraction_vs_random_floor")
    bad += ["xl " + k for k in ("gather_melem_per_s", "bg_transport_pps",
                                "map_render_s_256x256x1")
            if not (np.isfinite(xl[k]) and xl[k] > 0)]
    sane = tr["sane"] and large["sane"] and xl["sane"]
    if missing or bad or not sane or launches < 1 \
            or large["cells"] != 16 ** 3 + 8 * 4096 + 8 * 512 \
            or xl["cells"] != 32 ** 3 \
            or not (scaling is None or scaling["efficiency"] > 0):
        fail("phase 21: (b) missing %s, not finite and positive %s, sane "
             "%s, %d a2e_all_sizes launches, cells %s / %s"
             % (missing, bad, sane, launches, large.get("cells"),
                xl.get("cells")))
    report["bench"] = dict(secs, total_s=time.time() - t0)
    print("phase 21: %.2f s [%s]" % (time.time() - t0, card), flush=True)


MARCH_CASES = {"plain": dict(per_freq=False), "tally": dict(per_freq=True),
               "ali": dict(per_freq=True, ali=True),
               "col0": dict(per_freq=True, col0=20, ncol=8)}


def _march_model(dev):
    """Phase 22's root grid (N^3, uneven density) and 44 channels of
    cross sections (a cell's optical depth 3 in the UV down to 1e-4 in
    the FIR), weights and HG phase functions on 2500 bins."""
    import torch
    from soc_tpu_torch.grid import grid_from_arrays
    from soc_tpu_torch.io.dust import hg_scattering_function
    rs = np.random.default_rng(1)
    nfreq = 44
    grid = grid_from_arrays(N, N, N, [N ** 3],
                            [rs.uniform(0.5, 1.5, N ** 3)], dev)
    _, csc = hg_scattering_function(np.linspace(0.0, 0.6, nfreq), 2500)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=dev)
    tau_cell = np.logspace(np.log10(3.0), -4, nfreq)
    return grid, dict(kabs=f32(0.6 * tau_cell), ksca=f32(0.4 * tau_cell),
                      tw=f32(np.ones(nfreq)), csc=f32(csc))


def _march_pool(dev, grid, phys, case, lanes, per, graphs):
    """A PoolRun of phase 22's ``case`` (MARCH_CASES) on ``lanes`` lanes
    of ``per`` background packets a channel, its pool after one eager
    body (with ALI, half the lanes then sit in their emitting cell).
    ``graphs``: the pool keeps its GraphedBlock."""
    import torch
    from soc_tpu_torch.transport import propagate
    from soc_tpu_torch.transport.sources import GENERATORS
    nfreq = int(phys["kabs"].numel())
    ncol = case.get("ncol", nfreq)
    kit = propagate.StepKit(grid, phys, 4051234567, case["per_freq"],
                            with_ali=case.get("ali", False), ncol=ncol,
                            col0=case.get("col0", 0))
    if not kit.fused:
        fail("phase 22: the root-grid kit does not fuse on %s" % dev)
    st = propagate.new_pool(
        lanes, grid, torch.zeros(grid.cells, device=dev),
        torch.zeros((grid.cells, ncol), device=dev),
        torch.zeros(grid.cells, device=dev) if kit.with_ali else None)
    run = propagate.PoolRun(kit, st, GENERATORS["bg"],
                            dict(photons=torch.ones(nfreq, device=dev),
                                 per_freq=per, hi_base=0), nfreq * per)
    if not graphs:
        run.block = None
    kit.fused = False
    run.body()
    kit.fused = True
    if kit.with_ali:
        half = torch.arange(lanes, device=dev) % 2 == 0
        st.b.e_cell = torch.where(half, st.b.ind.clamp_min(0), -1)
    return run


def _march_compare(tag, run, dev):
    """One block fused and one eager from run's pool as it stands; fails
    beyond test_fused_block_matches_eager_block's tolerances, else returns
    the largest absolute difference of tabs."""
    import torch
    from soc_tpu_torch.transport import propagate
    kit, st = run.kit, run.st
    lanes = st.b.lanes
    ind = st.b.ind
    served = st.pending & (ind >= 0)
    if not (bool((ind < 0).any()) and bool(served.any())
            and bool(((ind >= 0) & ~st.pending).any())):
        fail("phase 22: %s: the snapshot lacks dead, frozen or live lanes"
             % tag)
    snap = {k: v.clone() for k, v in propagate._pool_tensors(st).items()}
    out = {}
    for fused in (True, False):
        kit.fused = fused
        work = propagate.PoolState(**{f: getattr(st, f) for f in (
            "b", "pending", "free_path", "tau", "esc_pending",
            "spare_cell")}, tabs=None, intf=None, absd=None)
        propagate._set_pool_tensors(
            work, {k: v.clone() for k, v in snap.items()})
        work.tabs = torch.zeros_like(st.tabs)
        work.intf = torch.zeros_like(st.intf)
        work.xab = None if st.xab is None else torch.zeros_like(st.xab)
        run._marches(work, () if fused else kit.lane_const_of(work.b))
        out[fused] = work
    kit.fused = True
    torch.cuda.synchronize()
    got, want = out[True], out[False]
    agree = torch.ones(lanes, dtype=torch.bool, device=dev)
    for f in ("ind", "scatterings", "counter"):
        agree &= getattr(got.b, f) == getattr(want.b, f)
    agree &= got.pending == want.pending
    same = agree.clone()
    worst_lane = 0.0
    for a, b in ((got.b.pos, want.b.pos), (got.b.dir, want.b.dir),
                 (got.b.photons, want.b.photons),
                 (got.free_path, want.free_path), (got.tau, want.tau),
                 (got.esc_pending, want.esc_pending)):
        eq = a == b
        same &= eq if eq.ndim == 1 else eq.all(-1)
        rel = ((a - b).abs() / b.abs().clamp_min(1e-30))[agree]
        worst_lane = max(worst_lane, float(rel.max()) if rel.numel() else 0)
    turned = torch.isclose(got.b.dir[served], want.b.dir[served],
                           rtol=1e-6, atol=0).all(-1)
    counted = all(torch.equal(o.b.counter[served],
                              snap["b.counter"][served] + 1)
                  for o in (got, want))
    pairs = [("tabs", got.tabs, want.tabs), ("absd", got.absd, want.absd)]
    if kit.per_freq_tally:
        pairs.append(("intf", got.intf, want.intf))
    if kit.with_ali:
        pairs.append(("xab", got.xab, want.xab))
    worst_tally, tallies_ok = {}, True
    for name, a, b in pairs:
        if name != "absd" and not float(b.sum()) > 0:
            fail("phase 22: %s: the eager block deposited nothing in %s"
                 % (tag, name))
        worst_tally[name] = float(((a - b).abs()
                                   / b.abs().clamp_min(1e-30)).max())
        tallies_ok &= bool(torch.allclose(a, b, rtol=1e-5, atol=1e-30))
    share, bits = float(agree.float().mean()), float(same.float().mean())
    share_turned = float(turned.float().mean())
    abs_err = float((got.tabs - want.tabs).abs().max())
    ok = (share >= 0.999 and worst_lane <= 1e-6 and share_turned >= 0.999
          and counted and tallies_ok)
    print("phase 22: %s: lanes agreeing %.6f of %d (bit for bit %.6f), "
          "largest relative difference of their float state %.3e; served "
          "lanes %d, one step counted each: %s, directions alike %.6f; "
          "tallies' largest relative difference %s: %s"
          % (tag, share, lanes, bits, worst_lane, int(served.sum()),
             counted, share_turned,
             ", ".join("%s %.3e" % kv for kv in worst_tally.items()),
             "ok" if ok else "FAILED"), flush=True)
    if not ok:
        fail("phase 22: %s: the fused block departs from the eager block"
             % tag)
    return abs_err


def _march_times(run, fused):
    """Milliseconds of run's march block from one snapshot of its pool
    (CUDA events): 5 replays of the pool's graph (its input copies
    included), then 3 calls issued eagerly; the kit ``fused`` or not."""
    import torch
    from soc_tpu_torch.transport import propagate
    run.kit.fused = fused
    run.body()                     # the graph's capture, then a replay
    snap = {k: v.clone() for k, v in propagate._pool_tensors(run.st).items()}
    lane_c = () if fused else run.kit.lane_const_of(run.st.b)
    times = {}
    for form, reps in (("graph", 5), ("issued", 3)):
        times[form] = []
        for _ in range(reps):
            propagate._set_pool_tensors(
                run.st, {k: v.clone() for k, v in snap.items()})
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            a.record()
            if form == "graph":
                run._replay(lane_c)
            else:
                run._marches(run.st, lane_c)
            b.record()
            torch.cuda.synchronize()
            times[form].append(a.elapsed_time(b))
    run.kit.fused = True
    return times


def march_phase(dev, report):
    """Phase 22 (the module docstring)."""
    from soc_tpu_torch.pipeline import driver
    t0 = time.time()
    lanes = driver.DEFAULT_LANES
    grid, phys = _march_model(dev)
    nfreq = int(phys["kabs"].numel())
    abs_err = 0.0
    for name, case in MARCH_CASES.items():
        # every channel in the first body's lanes
        run = _march_pool(dev, grid, phys, case, lanes, lanes // nfreq,
                          graphs=False)
        abs_err = max(abs_err, _march_compare(name, run, dev))
        del run
    times = {}
    for fused in (True, False):
        # the main path's background budget (driver.simulate_background:
        # 8 * area * batch a channel): the first channels fill the pool
        area = int(grid.area)
        per = 8 * area * max(1, round(FULL_BGPACKETS / (8.0 * area)))
        run = _march_pool(dev, grid, phys, MARCH_CASES["tally"], lanes, per,
                          graphs=True)
        times[fused] = _march_times(run, fused)
        del run
    # a lane's state read once (97 bytes) and what the block changes
    # written once (65); the tallies' atomics are not counted
    b_ms, b_by = bound(0, (97 + 65) * lanes)
    ms = float(np.median(times[True]["graph"]))
    plain_ms = float(np.median(times[False]["graph"]))
    print("phase 22: one block at %d^3, %d channels, %d lanes, with the "
          "tally: march_block %.3f ms a graph replay %s, issued %s; the "
          "eager block %.3f ms a graph replay %s, issued %s; bound %.3f ms "
          "(%s); phase %.2f s [%s]"
          % (N, int(phys["kabs"].numel()), lanes, ms,
             ["%.3f" % t for t in times[True]["graph"]],
             ["%.3f" % t for t in times[True]["issued"]], plain_ms,
             ["%.3f" % t for t in times[False]["graph"]],
             ["%.3f" % t for t in times[False]["issued"]], b_ms, b_by,
             time.time() - t0, report["card"]), flush=True)
    report.setdefault("march_block", {}).update(
        ms=ms, plain_ms=plain_ms, max_abs_err=abs_err, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bgpackets", type=int, default=FULL_BGPACKETS)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()

    # ---- phase 1: device
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a "
             "CUDA device")
    if not os.path.exists(os.path.join(HERE, "soc_tpu_torch", "csrc",
                                       "a2e.cu")):
        fail("run from a checkout of the repository (soc_tpu_torch/ is "
             "missing next to this script)")
    sys.path.insert(0, HERE)
    from soc_tpu_torch import _build
    dev = torch.device("cuda", 0)
    card = card_line()
    print("phase 1: %s (torch %s, CUDA %s, %d device(s))"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()), flush=True)
    report = dict(card=card)

    # ---- phase 2: build, one nvcc per source, all started together
    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.library, SOURCES))
    print("phase 2: built %d sources in %.2f s" % (len(SOURCES),
                                                   time.time() - t0),
          flush=True)
    for name in SOURCES:
        secs, log = _build.build_log.get(name, (0.0, "cached"))
        print("phase 2: csrc/%s.cu in %.2f s; nvcc says:\n%s"
              % (name, secs, log.strip()), flush=True)
        for kernel, regs, spills in ptxas_kernels(log):
            print("phase 2: %s: %d registers, %d bytes spilled (stores + "
                  "loads)" % (kernel, regs, spills), flush=True)
            for name in ("a2e_all_sizes", "a2e_clamp"):
                if name in kernel and spills:
                    fail("%s spills registers" % name)

    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    try:
        solvers = kernel_phase(dev, work, rng, report)
        fold_sol, freq = copy.deepcopy(solvers[128])
        ref = pipeline_phase(dev, work, args, report)
        rt_phase(dev, work)
        clamp_phase(dev, solvers, rng, report)
        probes_phase(dev, report)
        sharded_a2e_phase(dev, fold_sol, solvers[128][0], freq, rng, report)
        product_phase(dev, work, args, report, ref)
        t0 = time.time()
        plain = octree_rt_phase(dev, work, args, report)
        t1 = time.time()
        octree_pipeline_phase(dev, work, args, report)
        t2 = time.time()
        sources_phase(dev, work, args, report, plain["a"])
        t3 = time.time()
        slice_phase(dev, work, args, report, plain["a"])
        t4 = time.time()
        polarization_phase(dev, work, args, report, plain["a"])
        t5 = time.time()
        scattering_phase(dev, work, args, report)
        t6 = time.time()
        config5_phase(dev, work, args, report)
        t7 = time.time()
        checkpoint_phase(dev, work, args, report, plain["b"])
        t8 = time.time()
        domains_phase(dev, work, args, report)
        t9 = time.time()
        processes_phase(dev, work, args, report, ref)
        t10 = time.time()
        sca_processes_phase(dev, work, report)
        t11 = time.time()
        bench_phase(dev, work, report)
        march_phase(dev, report)
        print("phase 10: %.2f s; phase 11: %.2f s; phase 12: %.2f s; phase "
              "13: %.2f s (%s); phase 14: %.2f s (%s); phase 15: %.2f s "
              "(%s); phase 16: %.2f s (%s); phase 17: %.2f s (%s); phase "
              "18: %.2f s (%s); phase 19: %.2f s (%s); phase 20: %.2f s "
              "(%s); phase 21: %.2f s (%s); the smoke so far "
              "%.2f s, phase 10 %.2f s of it [%s]"
              % (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["slice"].items()),
                 t5 - t4,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["pol"].items()),
                 t6 - t5,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["sca"].items()),
                 t7 - t6,
                 ", ".join("%s %.4g" % kv
                           for kv in report["config5"].items()),
                 t8 - t7,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["ckpt"].items()),
                 t9 - t8,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["domains"].items()),
                 t10 - t9,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["processes"].items()),
                 t11 - t10,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["sca_mp"].items()),
                 time.time() - t11,
                 ", ".join("%s %.2f s" % kv
                           for kv in report["bench"].items()),
                 time.time() - T_START, t1 - t0, card), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = dict(PROBE_KERNELS, a2e_all_sizes=(
        "soc_tpu_torch/csrc/a2e.cu", "soc_tpu/solve/pallas_a2e.py:111"),
        a2e_clamp=("soc_tpu_torch/csrc/a2e.cu",
                   "soc_tpu/solve/stochastic.py:100 (exact path, XLA)"),
        a2e_sharded=("soc_tpu_torch/csrc/a2e.cu",
                     "soc_tpu/solve/pallas_a2e.py:193"),
        a2e_all_sizes_global=(
            "soc_tpu_torch/csrc/a2e.cu",
            "soc_tpu/solve/pallas_a2e.py:111 (beyond the shared form's "
            "ceiling)"),
        a2e_clamp_global=(
            "soc_tpu_torch/csrc/a2e.cu",
            "soc_tpu/solve/stochastic.py:100 (exact path, XLA; beyond the "
            "shared form's ceiling)"),
        march_block=("soc_tpu_torch/csrc/march.cu",
                     "none: soc_tpu/transport/propagate.py transport_run's "
                     "service and march steps (JAX, XLA-fused)"))
    order = ["a2e_all_sizes", "a2e_clamp", *PROBE_KERNELS, "a2e_sharded",
             "a2e_all_sizes_global", "a2e_clamp_global", "march_block"]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("shards", "ckpt_launches", "domain_launches", "mp_launches",
             "bench_launches",
             "octree_launches", "octree_ms", "octree_plain_ms",
             "octree_bound_ms", "octree_max_abs_err", "sources_launches",
             "sources_ms", "sources_plain_ms", "sources_bound_ms",
             "sources_max_abs_err", "pol_launches", "pol_ms",
             "pol_plain_ms", "pol_bound_ms", "pol_max_abs_err",
             "nf1088_ms", "nf1088_plain_ms", "nf1088_bound_ms",
             "nf1088_bound_by", "nf1088_max_abs_err", "config5_launches",
             "config5_ms", "config5_bound_ms", "config5_check_cells",
             "config5_check_ms", "config5_check_plain_ms",
             "config5_max_abs_err")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=sources[name][0],
        replaces=sources[name][1],
        **{k: report[name][k] for k in keys + extra if k in report[name]})
        for name in order]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qrack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

The first line is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; then each phase prints JSON lines:

1. build: both kernel libraries from qrack_tpu_torch/csrc, one nvcc per
   source started together (ops/cuda_build.py), with ptxas's registers
   and spills for each kernel instance (cuda_build.ptxas_report); the
   window kernel's instances of a full-width tile (window_tiles<T, R,
   pair>, R = window_kernel.reg_bits: every launch of the main paths)
   must not spill;
2. kernel against plain: random fused windows at n = 24 over the whole
   vocabulary (cross-tile inv/gen, high and low controls); pair-led
   segments at n = 24 that reach every route of the pair kernel
   (window_kernel.pair_route: in-tile inv/gen on register, lane and warp
   bits, a 256-op diagonal run after a cross-tile H, the trailing segment
   of qft_qcircuit(24), controls below and above the tile with mixed
   values); and one whole qft_qcircuit(30) window; the CUDA kernel
   against its plain PyTorch version on the same inputs.  Then the
   in-tile kernel (K1) in float32, float64, bfloat16 and float16: at
   n = 24 (bp = 12) one segment whose inv/gen cycle through the register,
   lane and warp bits of the dtype's tile layout (window_kernel.
   tile_route: every route reached) with diagonal ops anywhere, and a
   256-op diagonal run ending in an inv/gen on a warp bit; at n = 1-6
   (bp = n, the whole ket one tile) the first kind, through the routes
   that tile has.  Each must launch K1 once and hold the dtype's bar of
   phase 13 (float32: the one below).  Bar, here and
   on every launch of the main path in phase 4: max abs diff <=
   min(1e-6, 1e-4 * the largest |amp| of the plain result), so it scales
   with the amplitudes (about 3e-5 at the end of a w30 QFT); plus
   fidelity >= 1 - 1e-5 on the w30 window;
3. the main path at w30: create_quantum_interface("cuda", 30),
   SetPermutation, QFT (every |amp|^2 must be 2^-30 to 1e-3 relative),
   IQFT (ProbAll back at the start >= 1 - 1e-3), then QCircuit.RunFused
   of qft_qcircuit(30), which must match the engine's QFT to fidelity
   >= 1 - 1e-5.  The kernel's launch counts are set to 0 just before
   and read just after: both entry points must have launched;
4. times, by CUDA events: the w30 QFT end to end on the engine path and
   through RunFused (and through the plain gate-function chain, kernel
   off), then the main path again, every eighth launch (DENSE_PROBE_EVERY:
   every launch took 81 s of an 850 s run; every second, then every
   fourth, then every sixth, until the run budget took the cuts) with the kernel and its plain
   version timed and compared on the same input, beside the bound; each
   path's largest held launch (most ops) with its time and bound.

Then the TurboQuant path (the compressed engine, kernels K3-K5 of
csrc/turboquant_kernel.cu):

5. kernel against plain: tq_gate_low, tq_diag and tq_window at n = 24
   on random codes from quantize_blocks, int8 and int16: targets below
   the tile, diagonals above it, low and high controls with mixed
   values, a unit diagonal above the tile.  Bars, here and on every
   launch of the main path in phase 7: codes differ by at most 1, on at
   most 1e-3 of the entries at int8 and 1e-2 at int16 (the kernel's
   products split each operand into two TF32 parts and sum in another
   order than cuBLAS, and the gate's multiply-adds contract into FMAs,
   which moves a code only where its exact value sits at a rounding
   boundary; an int16 code unit is 32767 times finer than the row
   scale); scales within 1e-5 of the largest
   scale of their tile, in or out (a row whose amplitudes cancel, as
   most of them do when the IQFT brings the ket back to one basis
   state, keeps a scale that is the residue of the cancellation: its
   rounding error is relative to what cancelled, not to what is left);
   rows of tiles no op acts on identical to the input, bit for bit;
6. the main path at w32, int8: create_quantum_interface("turboquant",
   32), SetPermutation, QFT (the chunk masses sum to 1 within 1e-2),
   IQFT, NormalizeState (each requantization moves the norm a little;
   the engine rescales it from the chunk masses), ProbAll back at the
   start >= 0.98 (printed before the NormalizeState too), then H(0) and
   Prob(0) (0.5 within 2e-2), a one-gate window that takes the low 2x2
   entry.
   The three launch counts are set to 0 just before and read just
   after: each must have launched.  Then a w30 QFT on the turboquant
   engine against the dense "cuda" engine: fidelity >= 0.99;
7. times: the w32 QFT and IQFT end to end by CUDA events (those of
   phase 6's main path, the first QFT of the engine; a separate timed
   run was cut for the run budget), the two float32 products of one sweep through torch.matmul (context only,
   beside the mean time of K3's fully dirty sweep), and every launch of
   the main path again, timed, beside the bound; K3's and K4's launches
   and K5's first launch and a seeded forty-eighth of the rest
   (TQ_WINDOW_HELD: replaying all 79 took 179 s, a sixth about 30 s; a
   twelfth, then a twenty-fourth, until the run budget took the cuts) also run as the plain version on the
   same input, timed and compared.  The bound: the bytes of the tiles
   it requantizes, or their products as the TF32 tensor-core passes the
   kernel runs (2 + 3 at int8, 40 * D flops per amplitude; 3 + 3 at
   int16, 48 * D) plus the gates' flops on the CUDA cores, whichever
   takes longer.  f32_core_bound_ms is the bound with
   the products on the CUDA cores (16 * D flops per amplitude), as
   earlier runs stated it.

Then the slice of the ALU, the host oracle, QHybrid and the algorithm
programs, which run K1 and K2 on new paths (the ALU's gathers and
scatters, the RCS ISwap layer and the Grover passes are plain torch):

8. alu_vs_oracle, n = 22: create_quantum_interface("cuda", 22) against
   ("cpu", 22), the complex128 oracle, from one seeded start (H on every
   qubit, seeded T and CNOT), through one seeded sequence of every ALU
   op of the slice, each after a seeded H and CNOT and followed by
   NormalizeState (MUL and the *ModNOut ops drop the amplitudes outside
   their zeroed registers).  Bar: fidelity >= 1 - 1e-5 after every op;
9. alu_w30: on create_quantum_interface("cuda", 30), a seeded
   superposition with the MUL carry register at |0>, exact round trips
   (INC and INC(-a), ROL and ROR, MUL and DIV, CMUL and CDIV, Hash and
   its inverse table, IndexedLDA twice): the planes must come back
   bit for bit (torch.equal).  Each op's time by CUDA events beside the
   plane byte bound (2·2·2^30·4 B at 3.35 TB/s, 5.13 ms) and the peak
   memory;
10. shor, w30: N = 32639 = 127·257, base 21591 (order 256), width 15:
    SetPermutation(0), H on 0-14, POWModNOut into the 15-bit out
    register, IQFT(0, 15).  The in-register marginal, summed on the card
    over the out register, must match algorithms.order_finding_marginal
    (256 host IQFTs on the port's QEngineCPU) within 1e-6 and sum to 1
    within 1e-4; ProbReg(15, 15, 1) within 1e-6 of 1/256.  Then one
    seeded shor_order_find round (its factor is printed, not barred),
    and every K1/K2 launch of the IQFT again with its plain version
    (SweepProbe, the bar of phase 2).  K1 and K2 must have launched;
11. hybrid_rcs: create_quantum_interface("hybrid", 10) (QEngineCPU),
    GHZ, Compose a 14-qubit hybrid (the engine becomes a QEngineCUDA on
    the card at 24 qubits), Compose a 6-qubit "cuda" register (w30).
    Bars: ProbReg(0, 10, 0) and ProbReg(0, 10, 1023) within 1e-5 of
    0.5; random_circuit_sampling(6 layers, QrackRandom(7); RCS_DEPTH, 12
    until the run budget's cut) through the hybrid against
    rcs.make_rcs_fn(30, 6, 7) on a copy of the planes, fidelity >= 1 -
    1e-5;
12. grover, w22 (GROVER_ENGINE_WIDTH; w24 and 3216 iterations until the
    run budget's cut in PR 15): grover.make_grover_fn gives a
    success_probability >= 0.99; on create_quantum_interface("cuda", 22)
    the body of grover_search (grover_amplify: 804 iterations) reaches the same
    ProbAll within 1e-4 after NormalizeState (each H's float32 1/sqrt(2)
    shrinks the norm by 3.4e-8, 0.5% over the run), and the search's
    MAll then returns the seeded target.

Then the FPPOW slice: K1 and K2 in float64, bfloat16 and float16 planes,
the float32 -> float64 drift escalation, the whole-circuit programs and
the uniformly controlled gate past 10 controls:

13. fppow kernel against plain, n = 24, for each of float64, bfloat16
    and float16: the four random windows and the three pair-led cases of
    phase 2 (the pair layout of the dtype, every route reached), kernel
    against its plain version.  Bars, here and on every probed launch of
    phase 14: max abs diff <= 1e-13 of the largest |amp| at float64; at
    16 bits <= 4 ulps of the dtype at the largest |amp| (both compute in
    float32 and round once a sweep; FMA contraction moves a value across
    a rounding boundary now and then);
14. fppow at w30: create_quantum_interface("cuda", 30, dtype=float64),
    QFT (every |amp|^2 2^-30 to 1e-9 relative), IQFT (ProbAll back >=
    1 - 1e-9), and RunFused of qft_qcircuit(30) on float64 planes (the
    same |amp|^2 bar, fidelity to the engine's ket >= 1 - 1e-9); then the
    bfloat16 and float16 engine QFTs, their fidelity to the float64 ket
    held to HALF_QFT_BAR (predicted in PERF.md before the first run);
    each dtype's K1/K2 launches counted.  Then the engine QFT of each
    dtype again, every eighth launch (FPPOW_PROBE_EVERY) beside its
    plain version;
15. drift, w24: Grover (grover_amplify, 201 of the search's 3216
    iterations, DRIFT_ITERS; 804, then 402, until the run budget's cuts) on float32
    planes with QRACK_TPU_AUTO_F64_DRIFT = 1e-5 checked every 64 gates.
    The engine must escalate (float64 planes afterwards, one warning),
    and its raw ProbAll(target), without NormalizeState, must be within
    1e-4 of make_grover_fn's at as many iterations;
16. circuit_forms: QCircuit.compile_fn_pallas of qft_qcircuit(30)
    against RunFused (fidelity >= 1 - 1e-5), its K1/K2 launches counted;
    make_qft_fn(30) in the unrolled and the carried-fraction form against
    the engine's QFT (>= 1 - 1e-5); compile_batched_fn of a seeded
    48-gate circuit on 4 kets of 28 qubits against compile_fn on each
    ket alone (fidelity >= 1 - 1e-6, max abs diff <= 1e-6);
17. uc_wide, n = 27: UniformlyControlledRY with 12 scattered controls
    (a single permuted view would need 28 dimensions; uc_2x2 gathers)
    against the same 4096 payloads as single controlled gates through
    the window kernel (a pair sweep each), fidelity >= 1 - 1e-5.

Then the layers above the terminals (QStabilizer and its native tableau
library, QStabilizerHybrid, QUnit, QUnitClifford), stacked by the
factory; phase 18 runs right after the build, 19-22 at the end:

18. stack_native: native/tableau.cpp built with g++ into
    qrack_tpu_torch/_build/ and loaded (its build seconds printed); a
    counting stand-in replaces the library for the rest of the run, and
    a w64 GHZ on QStabilizer must make native calls (Prob 0.5 on every
    qubit, MAll all zeros or all ones).  No native library, no run;
19. qv_optimal: quantum_volume's gates (algorithms.quantum_volume_ops)
    at n = 30, depth 10 (QV_DEPTH; 30, then 20, until the run budget's
    cuts), before its MAll, through
    create_quantum_interface("optimal", 30) and through ("cuda", 30),
    each with the K1/K2 counts set to 0 just before and read just
    after (both must have launched).  Bars: Prob(q) within 1e-4 for
    every q; over 4096 seeded indices read with GetAmplitude,
    |<a|b>|^2 / (<a|a><b|b>) >= 1 - 1e-4.  Printed: both walls, the
    unit count, largest unit and host seconds after each layer (the
    device may still be behind), the unit Composes,
    QHybrid's host stagings and the in-unit Swaps; then MAll on the
    stack, whose outcome must match the collapsed Probs;
20. qft_optimal: SetPermutation of a seeded 40-bit value and QFT(0, 40)
    through OPTIMAL: no unit is built (QUnit's closed-form product
    path), every Prob(q) is 0.5 within 1e-12, and 256 seeded amplitudes
    match 2^-20 exp(2 pi i x rev(k) / 2^40) within 1e-9 of their
    modulus.  At w30 the same through OPTIMAL against the "cuda"
    engine's QFT (K1/K2): 4096 seeded amplitudes within 1e-3 * 2^-15;
21. clifford_wide: GHZ on 40 qubits through OPTIMAL, then T(0): the
    unit's QStabilizerHybrid keeps the T as a phase shard (or a gadget
    ancilla) on the tableau, no host staging; every Prob(q) 0.5 within
    1e-9 and MAll all zeros or all ones.  GHZ on 64 qubits through
    "unit_clifford", the same bars;
22. stab_switch, n = 18: ["stabilizer_hybrid", "hybrid"], 400 seeded
    Clifford gates, then RX(0.3) on qubit 0 and CNOT(0, 1), which forces
    SwitchToEngine into a QEngineCUDA (18 >= 13): it must run once, and
    the ket must match the same gates on the "cuda" engine at fidelity
    >= 1 - 1e-5.  Printed: the switch's seconds and microseconds per
    amplitude.  The native call count must have grown over 19-22.

Then the decision-tree layers, the tensor network and the noise plane,
each stack built by create_quantum_interface(..., rng=QrackRandom(seed),
rand_global_phase=False) on the card, each phase with its walls:

23. bdt_wide: SetPermutation of a seeded 48-bit value and QFT(0, 48)
    through ["bdt_hybrid", "hybrid"]: it stays a tree (at most 2 * 48
    nodes, no switch), and 4096 seeded amplitudes match the closed form
    within 1e-9 of their modulus; GHZ on 64 qubits then T(0), every
    Prob(q) 0.5 within 1e-12;
24. bdt_attached: "bdt_attached" at n = 36 with 16 attached qubits (the
    leaves are float32 (2, 2^16) planes on the card; any leaf elsewhere
    fails), a seeded depth-10 circuit (U3 on each qubit, CNOT on
    alternating pairs) on the attached qubits and H, T on each of the 20
    tree qubits: Prob(q) within 1e-5 of the same circuit on a bare w16
    "cuda" engine (attached qubits) and of 0.5 (tree qubits);
25. bdt_switch, n = 20: ["bdt_hybrid", "hybrid"] with a node budget of
    2^20 / 64 (BDT_SWITCH_RATIO), H on every qubit and seeded phases of
    random angles on random pairs until the tree stops compressing: it
    must switch once, into a QEngineCUDA; then 10 seeded layers on the
    card (K1/K2 must launch), and the ket must match the same gates on a
    bare "cuda" engine at fidelity >= 1 - 1e-5.  Printed: the switch's
    seconds and microseconds per amplitude, the tree walk's
    (GetQuantumState) alone, and the node count at the switch;
26. tn_cone: ["tensor_network", "unit", "stabilizer_hybrid", "hybrid"]
    over a seeded brickwork of non-Clifford bricks, depth 8.  At n = 30,
    Prob(q) of 8 seeded qubits, each read through its past light cone
    (the stack stays buffered), within 1e-5 of a bare w30 "cuda" engine
    that ran the whole circuit; at n = 64, Prob(32), whose cone of about
    18 qubits becomes a unit on the card (K1/K2 must launch), within
    1e-5 of the cone alone on a bare engine of its width.  Printed: the
    cone width, the gates kept against the gates buffered, the launches;
27. noisy_stack: ["noisy", "unit", "stabilizer_hybrid", "hybrid"] at
    n = 24 over a seeded depth-12 circuit.  With lambda 0 the ket matches
    the bare "cuda" engine's at fidelity >= 1 - 1e-5; with lambda 1e-3
    GetUnitaryFidelity() equals (1 - lambda)^k within 1e-12, k the
    (gate, distinct qubit) pairs the phase counts at the wrapper's funnel
    points (MCMtrxPerm, Apply4x4, Swap).  K1/K2 must launch.  Printed:
    the overlap with the ideal ket and the Paulis the channel applied;
28. trajectories: run_trajectories at n = 24 over a seeded depth-4
    circuit (TRAJ_DEPTH; depth 10, then 6, until the run budget's cuts),
    B = 64
    (8 GiB of float32 planes on the card).  With a
    noise-free model every trajectory's p1 is the bare engine's Prob(q)
    within 1e-5, weights 1; with NoiseModel(default=depolarizing(1e-3))
    the same key twice gives identical samples, and
    QRACK_NOISE_TRAJ_CHUNK=16 (4 chunks) the same samples, weights
    within 1e-6 and p1 within 1e-5.  Then a ballast tensor leaves the
    card free memory for about 20.5 trajectories, and a B = 64
    amplitude-damping run of one layer (the Kraus step) takes the chunk
    that traj_chunk sizes from that budget: it must run in
    ceil(64 / chunk) chunks of 16 or more without running out of memory.
    The peak of device memory per amplitude
    (torch.cuda.max_memory_allocated), of the unchunked run and of that
    one, must not pass trajectories.BYTES_PER_AMP, the coefficient that
    sizes a chunk.  Printed: trajectories a second, the peaks, and the
    CUDA-event time (warmed once, the median of 3) of one batched general
    2x2 on qubits 0, 12 and 23 and of the readout over a random
    (64, 2, 2^24) batch, beside their byte bounds (the 2x2 reads and
    writes the batch, the readout reads it).

Then the pager (QPager, parallel/pager.py): one ket in pages of at most
2^30 amplitudes over a device list that names this card once a page;
its windows run K1/K2 on every page (fusion.sharded_kernel_window_body)
and its paged-target 2x2s, remaps and page swaps as plain torch passes
in place (ops/sharded.py):

29. pager_parity, w30 on 4 pages of 2^28: a seeded depth-10 circuit
    (pager_circuit: H and RY on page bits, CNOTs with a page-bit target
    and with a page-bit control, CZ and controlled phases between page
    bits, T and RZ on page bits, U and H in the page, one Swap a layer,
    local-local, mixed and page-page in turn) on
    create_quantum_interface("pager", 30, devices=[card] * 4) and on
    ("cuda", 30): fidelity >= 1 - 1e-5.  The per-page launches must equal
    the count the window plans predict (parallel/pager.FLUSHES: pages x
    the in-page sweeps of fusion.sharded_kernel_sweeps), both entry
    points must launch, and the run must take a page exchange that
    moves amplitudes between pages.  The first launch of
    every in-page run and a seeded sixteenth
    of the rest (PAGER_HELD) run as the kernel and as its plain version
    on the same input, held to the bar of phase 2;
30. pager_qft, w32 on 4 pages of 2^30 (32 GiB of float32 planes): the
    engine path (QFT(0, 32)) and RunFused(qft_qcircuit(32)) from a basis
    state; each must launch K1/K2 per page exactly as its plans predict,
    keep the device memory above the planes within half a page (4 GiB,
    torch.cuda.max_memory_allocated), and match the closed form
    2^(-n/2) exp(2 pi i x rev(k) / 2^n) on every amplitude (checked on
    the card 2^26 at a time: max abs diff <= 1e-4 * 2^(-n/2), fidelity
    >= 1 - 1e-5); the engine path's IQFT brings ProbAll(x) back to >=
    1 - 1e-4.  Then 3 warm walls of each by CUDA events, and one more run
    of each with every launch and every page pass between events
    (PageTimer): kernel sum against its bound, exchange count, bytes
    (each element an exchange moves read and written once) and ms;
31. pager_w33, w33 on 8 pages of 2^30 (64 GiB): one RunFused QFT with the
    bars of phase 30 (closed form, launches as planned, memory);
32. pager_factory: create_quantum_interface("pager", 31, devices=[card]
    * 2) and ("hybrid", 31, devices=...), which builds straight into its
    pager mode: a GHZ state (H and 30 CNOTs) read across the page bit,
    Prob of the top qubit and ProbAll of both ends within 1e-5 of 0.5.

Then the rest of the pager: the split-index forms that run every
gate-set and ALU op past 31 qubits, the whole-circuit programs over
pages, the TurboQuant pager and QUnitMulti (no new kernel: the split
bodies, page programs and chunk programs are plain torch, as the JAX
package left them to XLA):

33. wide_ops, w32 on 4 pages of 2^30: H on bits 1, 2, 5, 29, 30 and 31,
    T, RZ and a CNOT, then one seeded sequence (wide_sequence) of XMask,
    ZMask, PhaseParity, UniformParityRZ, CUniformParityRZ,
    PhaseFlipIfLess, INC, CINC with a page-bit control, INCBCD, ROL,
    Hash, MUL and DIV, POWModNOut, IndexedLDA and ForceMParity, every
    register across the page boundary, on the pager and on the port's
    "sparse" engine (numpy int64 indices on the host).  The engine runs
    three of them only through a dense 2^n ket, so it takes each in
    another form: INCBCD as the same digit permutation through Hash
    (bcd_table), IndexedLDA as the controlled X gates that load the zero
    value register (lda_as_gates), and the last op, ForceMParity, is
    held to its closed form (forced_parity).
    After every op the pager's amplitudes at the oracle's support are
    within 1e-6 and its norm within 1e-5 of 1; each op is timed by CUDA
    events beside the bytes it must move (a diagonal reads and writes
    the ket once, 2·2·2^32·4 B at 3.35 TB/s; a gather twice), and the
    device memory above the planes stays within 4 GiB for a diagonal and
    32 + 4 GiB for a gather (gather_ring builds the new pages while the
    old ones live).  Then w33 on 8 pages (64 GiB): after a GHZ-like
    preparation, flushed before the first op is timed, ZMask,
    UniformParityRZ and ForceMParity from (|0> + |x>)/sqrt(2) against
    their closed form (1e-6), within 4 GiB; then a w32 int8 "turboquant"
    engine: H on bits 0, 20 and 31, ZMask and UniformParityRZ through
    the split phase program, H again, Prob against the closed form
    (1, sin^2(0.6), sin^2(0.6)) within 2e-2;
34. page_programs: make_sharded_qft_fn at w30 on 4 pages of 2^28
    (SHARDED_QFT_FN_WIDTH; w32 on pages of 2^30, 21.1 s, until the run
    budget's cut) from |x> against the closed form of phase 30 (every
    amplitude, 2^26 at a
    time); QCircuit.compile_sharded_fn of qft_qcircuit(26) on 4 pages of
    2^24 (SHARDED_QFT_WIDTH; w30 on pages of 2^28, 29.9 s, then w28, until
    the run budget's cuts) against the "cuda" engine's RunFused (fidelity
    >= 1 - 1e-5);
    make_sharded_rcs_fn at w30, depth 6 (RCS_PAGE_DEPTH), against
    make_rcs_fn on one plane pair (fidelity >= 1 - 1e-5);
    make_sharded_grover_fn at w30 on 4 pages of 2^28
    (SHARDED_GROVER_WIDTH; w32, 8.1 s, until the run budget's cut in PR
    15) with 3 iterations against sin^2(7 asin(2^-15)) within 1e-4 of
    it.  Each timed, each within
    4 GiB above its pages;
35. tq_pager: create_quantum_interface("turboquant_pager", 31, bits=8,
    devices=[card] * 4; TQ_PAGER_WIDTH, w32 until the run budget's cut):
    a GHZ state (H, 30 CNOTs: targets in the chunk,
    in the local chunk bits and in the page bits), Prob(q) of a seeded
    half of the qubits (TQ_PAGER_READS; every q until the run budget
    took the cut, each a whole decode) and ProbAll of both ends within
    2e-2 of 0.5; a seeded pager_circuit at
    w26 against the "cuda" engine, fidelity >= 0.99 (the bar of phase 6);
    the resident bytes a page; no TurboQuant kernel launches (the pager
    runs the plain chunk programs, as the JAX package's does);
36. unit_multi: create_quantum_interface("optimal_multi", 48,
    device_ids=[0, 0]) with two separable seeded 24-qubit registers
    (random_layers, depth 6): each register's unit becomes a w24
    QEngineCUDA on the card (K1/K2 must launch); every Prob(q) within
    1e-5 of two w24 "cuda" engines on the same gates, and 1024 seeded
    GetAmplitude reads of the stack against the product of theirs at
    |<a|b>|^2 / (<a|a><b|b>) >= 1 - 1e-5; the device table after
    RedistributeQEngines, one unit on each row of the one card.

Then the telemetry plane (qrack_tpu_torch/telemetry; no new kernel):

37. telemetry: the w30 "cuda" engine-path QFT of phase 4, three warm
    reps with telemetry disabled, alternated with three of phase 4's
    QFT on a fresh engine of its own (against_reference): their median
    at most 2% above the reference's, TELE_DISABLED_BAR, one-sided, as
    a faster wall is no cost; the signed differences to the reference
    and to phase 4's warm median printed (the card's own wall drifts by
    up to 3.8% within a run, so phase 4's, ten minutes earlier, is no
    bar); no counter recorded) and three with it enabled (the overhead is printed, not
    barred).  Over one more
    enabled QFT, taken as a snapshot difference: fuse.kernel.sweeps
    equals the window kernel's own launch count (K1 + K2) and the sum
    of the plans' sweeps of the windows that went through the kernel,
    whose number fuse.kernel.windows equals (a window may plan more than
    one sweep); the gate.cuda.*.w30 counters sum to the gates the QFT
    requested, 30 * 31 / 2.  The roofline: roofline.cuda.fuse.flush's
    planned bytes (the sweeps times a read and a write of the planes)
    over the wall of a span synced on the planes give the implied GB/s,
    at most the device class's peak (3350 for the H100 SXM) with
    roofline.honesty.clamped at 0; roofline.device_class reports the
    card's name, HBM bytes and peak.  A torch.profiler bracket around
    one QFT lists as many window_tiles kernels as the wrappers counted;
    the trace's kernel durations, summed, are the card's busy time,
    printed beside the enabled wall as the engine path's idle share.
    Small stacks on the card then reach every other hook (QUnit over the
    stabilizer hybrid, QHybrid's grow and switch, the tree's switch,
    QUnitMulti, trajectories, a w16 TurboQuant engine, the float64
    escalation, a checkpoint, a build).  The w32 pager QFT of phase 30
    on 4 pages: exchange.pager.<pass> and .bytes equal sharded.EXCHANGES
    over the same calls, the per-page launches equal 4 x
    (fuse.kernel.sweeps - paged-target 2x2s) and the plans' count, and
    fuse.kernel.windows the pager's kernel windows.  Every counter
    family of TELE_REQUIRED must be reached; the JSONL snapshot and the
    Chrome trace are written to a temporary directory and load back.

Then the resilience plane (qrack_tpu_torch/resilience; no new kernel).
Every drill holds the plane's telemetry events against a count that does
not come from them: the window kernel's wrappers' launches per window
dispatch (CallLog), the fault specs' own fire counts, sharded.EXCHANGES,
the engine's type and page count, QEngineCPU constructions counted at
the class, and the planes themselves:

38. resilience: the w30 "cuda" engine-path QFT of phase 4 with the
    plane off, three warm reps alternated with phase 4's on a fresh
    engine, their median at most 2% above the reference's
    (RES_DISABLED_BAR, one-sided, as phase 37's), and once more as the
    clean reference (its planes and each window's K1/K2 launches).
    Armed (create_quantum_interface after resilience.enable(): a
    ResilientEngine), no fault: two warm reps (overhead printed, no bar)
    and a run whose planes equal the clean ones bit for bit with the
    same launches a window.  One amp-corrupt at cuda.fuse.flush: the
    integrity envelope's snapshot (on the card) restores the window and
    replays it: integrity.violation >= 1, integrity.replay.repaired = 1,
    the planes bit for bit, the launches the clean run's with one window
    run twice; the memory above the planes printed.  A transient raise
    there, fired twice: two retries, no window run twice, the planes bit
    for bit.  The loud end: a persistent device-loss there without
    failover_cpu raises DispatchGiveUp, the planes unchanged.  The w32
    pager on 4 pages of 2^30: the same replay against a clean pager's
    QFT (32 GiB of snapshot on the card; pages and table bit for bit,
    launches as planned), then its loud end (no shrink fits a page past
    2^30, no dense rung past 30 qubits): DispatchGiveUp, the pages'
    digest and table unchanged.  The staircase: w30 on 4 pages of 2^28
    (RES_STAIR_*) under a persistent pager.dispatch device-loss, an INC
    moves it 4 -> 2 -> 1 pages -> QEngineCUDA (those events, in order),
    K1/K2 launch on the dense engine after the move, and the ket is
    within fidelity 1 - 1e-5 of a clean engine's.  A pager.exchange raise
    fired three times on a remap-off page-bit H shrinks the pager to 2
    pages, one exchange runs, and the next call grows it back to 4.  A
    w20 engine with failover_cpu=True lands on QEngineCPU (the one CPU
    construction of the phase before the oracle's,
    resilience.failover.cuda_to_cpu) and matches the oracle.  A
    persistent turboquant.dispatch raise on the w24 int8 engine (K3, K4
    and K5 launched first) moves it to QEngineCUDA, where a QFT launches
    K1/K2; fidelity >= 0.99 to the dense engine's run.  A hang at
    cuda.device_get with a 2 s watchdog raises DispatchTimeout within
    RES_HANG_S + RES_HANG_SLACK_S; a breaker of threshold 3 opens,
    refuses without calling, half-opens after 0.5 s and closes; and
    resilience.run_probe() on the card returns ok (its seconds printed).
    No QEngineCPU is built but for the named rung and the oracle.  The
    phase's seconds are printed beside its budget of 35 s (RES_PHASE_S),
    as the run's are beside its 880 s: a budget, not a bar (one machine
    ran the same phase 27-33 s).

Then the checkpoint plane (qrack_tpu_torch/checkpoint; no new kernel).
Its files go to one temporary directory, under QRACK_SMOKE_TMP when it
is set, else the system's; the phase first checks that the directory has
1.2 times the bytes it writes at once free (1 GiB: the w27 dense file
and the w26 pager's), raises naming it otherwise, and deletes each file
after its check:

39. checkpoint: (a) the w27 float32 "cuda" engine from 0x2A5C3F1
    (CKPT_DENSE_WIDTH; w30, then w28, until the run budget's cuts), its
    engine-path QFT through K1/K2, then capture + save_snapshot (what
    save_state runs), the planes' digest (plane_digest) the same after
    the capture; a fresh create_quantum_interface("cuda", 27,
    rng=QrackRandom(991)) loads the file (load_snapshot + restore_into,
    what load_state(path, into=) runs, the planes written in place);
    both continue with the IQFT and a seeded tail of 90 H/T/CNOT
    (ckpt_tail), the first K1 and K2 launch of the loaded engine's
    continuation held to plain at phase 2's bar: planes torch.equal and
    MAll equal.  Printed: the capture, hash and write, the read, hash
    and upload, each in ms with its GB/s (host clocks; the parts of the
    container's own save and load, checkpoint/container.py LAST_SAVE/
    LAST_LOAD; the digests run on threads beside the write and the read,
    so the wait for them past it is printed too), the file's bytes, and
    the device memory above the live
    engines' planes during the save and the load (bar: 1 GiB each).
    (b) a w26 pager on 4 pages of 2^24 on the card (CKPT_PAGER_WIDTH;
    w28, then w27, until the run budget's cuts): its engine-path QFT
    and H on the top four qubits leave the placement table non-identity
    (checked); save_state writes the raw pages as complex128 (1 GiB);
    one load_snapshot of the file (one read and hash) restores into a
    fresh 4-page pager (table and pages bit for bit after the
    continuation, the first per-page K1 and K2 launch held to plain, MAll
    equal) and builds with no target (4 pages on cuda, bit for bit,
    registry.build: what load_state(path) runs after the read); then
    load_state into a 2-page pager (fidelity >= 1 - 1e-6 after the
    continuation, against the build's pages in logical order).
    (c) a w28 int8 "turboquant" engine: its QFT through K3-K5, save and
    load_state(path): codes and scales equal the saved ones bit for bit;
    both continue (a one-gate window, a lone diagonal, the IQFT and the
    seeded tail: K3, K4 and K5 each launch) and their codes and scales
    equal bit for bit (no kernel of csrc/turboquant_kernel.cu uses an
    atomic: each block writes its own tile).  (d) the "optimal" stack at
    w24: a GHZ and a non-Clifford block whose shards meet CNOTs, which
    puts a unit on a QEngineCUDA on the card; save, load INTO a fresh
    "optimal" stack, continue both: every amplitude equal and MAll
    equal.  (e) the failover snapshot file at w20, with
    QRACK_TPU_FAILOVER_PERSIST naming a directory: a 2-page pager under
    a persistent pager.device_get raise, with no retries (so the breaker
    stays closed) and no CPU rung, moves 2 -> 1 pages -> QEngineCUDA;
    exactly one file a move, each loading (load_state, on cuda) to the
    ket before the call bit for bit; K1/K2 launch on the dense engine
    after the moves.  Then a pager whose page holds a NaN under a
    persistent pager.device_get nan-poison: persist_rejected is counted
    and no file is written.  The phase's seconds are printed beside its
    budget of 60 s (CKPT_PHASE_S), a budget, not a bar.

Then the router and the light-cone engine (qrack_tpu_torch/route and
lightcone; no new kernel: the stacks they build launch K1-K5):

40. route: (a) a "route" wrapper at w28 (ROUTE_TQ_WIDTH; w30 until the
    run budget's cut) from 0x2A5C3F1 runs RunFused(qft_qcircuit(28))
    under the default knobs, with the card's
    own memory as the budget (checked against torch.cuda.mem_get_info):
    it must route to "turboquant" (layers ("turboquant",)), launch
    K3-K5, and hold the closed form on 4 seeded pages of 4096
    amplitudes (GetAmplitudePage) at fidelity >= 0.99, the TurboQuant
    bar of phase 6; printed: its wall and launches.  (b) the same with
    QRACK_ROUTE_DENSE_MAX_QB=30: "dense" (("cuda",)), its K1/K2 launches
    equal to a direct "cuda" engine's on the same circuit, and its planes
    torch.equal to that engine's (else held at phase 2's bar; which held
    is printed); direct, routed, direct, each wall with construction,
    the gap to the faster direct one the cost of admission; and a plan
    alone (QRouted.plan, host only).
    (c) four w100 GHZ through "route": "stabilizer", no K1-K5 launch,
    each MAll all zeros or all ones.  (d) the README's w50 depth-4
    brickwork through "route": "lightcone"; all 50 Prob(q) within 1e-6
    of the same cones run by the port with device="cpu" and of the
    closed form sin^2(theta_q / 2); a second pass all cache hits, no
    launch and the same values; printed: launches, reads a second.
    (e) a w100 brickwork on the "lightcone" terminal at the deepest of
    8-13 brick layers whose widest cone (the middle qubit's) the router
    still sends to "dense" (printed, with the widths tried): 100 reads,
    every cone dense, each read within 1e-6 of the closed form, every
    tenth cone's planes held to the circuit's plain gate path on the
    card (QCircuit.compile_fn) at phase 2's bar; printed: reads a second
    and the cone cache's device bytes.  (f) a w24 GHZ on the stabilizer
    stack, then general circuits: escalated to dense exactly once
    (telemetry route.misroute.escalated == 1), fidelity >= 1 - 1e-6 to a
    direct "cuda" engine; a w40 general circuit after a GHZ is refused
    with MisrouteError, the stabilizer state intact.  (g) 30 calls of
    MultiShotMeasureMask (1024 shots over all 20 qubits) from one rng
    position on a w20 engine in each plane dtype draw one key set;
    printed beside it, on the same ket and uniforms, the distinct results
    of 30 calls of the cumsum draw the card used before
    (gatekernels.cumsum_mask_keys) and of the trajectories' terminal
    draw (noise/trajectories.readout on 8 copies); a light-cone read's
    MultiShotMeasureMask repeats too; a w20 pager's ProbMaskAll over 30
    calls (distinct results, and the largest difference to a float64
    host binning, bar 1e-6).  (h) a routed w20 QFT session and a w24
    light-cone session (warm cones and a recorded projector) saved and
    loaded on the card (the routed one built from the file, the
    light-cone one into a fresh session built as the saver was): the
    routed continuation's planes torch.equal and MAll equal; the
    light-cone load's cones torch.equal, its warm reads equal, and the
    continuation's reads and draws equal.  The
    phase's seconds are printed beside its budget of 40 s
    (ROUTE_PHASE_S), a budget, not a bar.

Then pages in several processes (qrack_tpu_torch/parallel/cluster.py
and the pagers over its page homes; no new kernel: every rank launches
K1/K2 on its own pages).  The script re-invokes itself as
``chip_smoke.py --cluster-worker nccl|gloo`` once a rank, each rank's
rendezvous in the QRACK_* environment, the NCCL worker of (a) started
beside the gloo cohort of (b)-(h); a worker that fails or
passes CLUSTER_TIMEOUT_S fails the run, and every worker is stopped:

41. cluster: (a) NCCL as a group of one on cuda:0: a w28 pager of 4
    pages over cluster.global_page_devices runs the remap-on QFT of
    |0x2A5C3F1> through QCircuit.Run; its pages and table torch.equal to
    the one-process pager's in the same worker, Prob(3), GetAmplitude
    (broadcast over NCCL) and MAll equal, the closed form at phase 30's
    bars, the per-page K1/K2 launches equal.  (b) two ranks on gloo,
    both on cuda:0 (the cut: NCCL refuses two ranks on one device, so
    the one card holds both ranks' halves of the ket): the w30 QFT
    (CLUSTER_WIDTH: 4 pages, 2 a rank, the top page bit crosses
    the ranks; w28 after the run budget's first cut: 4 pages of
    2^26) through QCircuit.Run with remap on and batched prologues;
    each rank holds its own pages against the closed form at phase 30's
    bars (max diff <= 1e-4 * 2^(-n/2), fidelity >= 1 - 1e-5), its
    per-page K1/K2 launches equal its plans' and are > 0,
    remap.pager.batched >= 1 and bytes crossed the ranks; Prob(3) and
    MAll equal on both ranks.  Printed: the QFT's wall, the bytes sent
    over the wire, the bytes staged through pinned host buffers, and
    apart the transport's seconds in its staging copies and on the wire
    (sharded.TRANSPORT_S), each with its GB/s.  (c) make_sharded_qft_fn
    at w26 (CLUSTER_PROGRAM_WIDTH) over the two ranks' pages against the
    closed form.  (d) the 16-bit TurboQuant pager at w24 over the two
    ranks: marginals within 1e-3 of 1/2, its codes equal the one-process
    TurboQuant pager's, MAll equal on both ranks.  (e) a w24 cluster
    pager saved on each rank and loaded into a fresh cluster pager (each
    local page and the table torch.equal) and into a one-process pager
    on the card.  (f) (b)'s QFT with the resilience plane armed over the
    two ranks, twice: a transient pager.exchange raise armed on rank 1
    alone, then an amp-corrupt of a window's output pinned to a page of
    rank 1, armed there alone: the closed form at phase 30's bars, the
    pages torch.equal to (b)'s, the per-page launches equal the plans'
    (a replayed window's relaunch included), and both ranks count the
    same retries (1; 0), replays (0; 1) and strikes (0; 1).  Printed:
    each armed wall beside (b)'s, the device memory above the planes,
    the agreements and their seconds.  (g) the staircase at w26
    (CLUSTER_STAIR_WIDTH): after the QFT a persistent device loss at
    pager.device_get takes the pager 4 -> 2 (onto rank 0's slots) -> 1
    page, then a QEngineCUDA replica of the gathered ket on each rank:
    the replica at the closed form, Prob(3) and two MAll draws equal on
    both ranks; the faults cleared, the degraded pager grows back to 4
    pages over both ranks, at the closed form again; 2 shrinks, 1
    expansion and 3 failover moves on both ranks; the bytes each move
    sent over the wire, summed over the ranks, half the ket, none, the
    whole ket and half of it (sharded.repage, sharded.all_gather_pages).
    Printed: each move's wire bytes and seconds.
    (h) at w24 (CLUSTER_STRUCT_WIDTH), each bit for bit against the
    one-process pager in the same worker: three strikes quarantine slot
    2 and the re-page moves its page onto spare slot 4, on rank 1;
    Compose, Decompose, Dispose and Allocate down to one qubit (4 -> 2
    pages) and back (2 -> 4), composing a pager over the ranks; the
    16-bit TurboQuant pager's dense float32 plane (an INC), its codes
    equal.  The phase's seconds are printed beside its budget of 90 s
    (CLUSTER_PHASE_S), a budget, not a bar.
42. The serving plane (qrack_tpu_torch/serve, ROADMAP item 16b) on the
    card: QrackService(engine_layers="cuda").  (a) Eight tenants at w27
    (SERVE_WIDTH, 1 GiB each), each first given its own X(k) through
    call, submit qft_qcircuit(27) with the prefix cache off and a batch
    window long enough to hold the eight submits: they co-batch into ONE
    dispatch of one fold, the eight kets stacked as the high bits of a
    w30 ket (serve.batch.dispatches 1, serve.batch.jobs 8), and the K1/K2
    launches, counted from 0 just before the submits, equal the fold's
    planned sweeps.  Each tenant's ket is held against the same circuit
    run by compile_fn_pallas(27) on its pre-batch ket alone at the dense
    bar (whether torch.equal held is printed), and the device memory
    above the sessions' planes to twice their bytes plus 1 GiB.
    Printed: the batch's wall by CUDA events beside the eight solo w27
    RunFused walls, and, timed again after the counts were read, the
    program's host build, the fold's stack (fresh memory and warm),
    kernels and binds apart, and one solo lane's kernels eight times;
    queue wait and latency p50/p99.  (b)
    Sixteen jobs over the eight tenants in two waves of seeded circuits,
    pipelined (the second wave staged while the first is in flight), with
    one serve.device_get raise armed and no retry: the first wave's
    batch fails over once and each of its jobs replays on its own
    QEngineCUDA as a one-lane batch (serve.batch.replay.in_place 8); every
    ket at the dense bar against an unfaulted run of both waves, so no job
    applied twice.  (c) The prefix cache: eight w24 tenants
    (SERVE_PREFIX_WIDTH) share the prefix tests' state-prep and differ in
    their tails; after one host lookup of a ninth tenant primes the
    popularity window, one materialization and seven hits (each a copy at
    seed, serve.prefix.cow), every ket at fidelity 1 - 1e-6 of its solo run,
    and the entry's host fingerprint after every suffix ran in place
    equal to the one at insert.  (d) The warm start, run first: a
    service on the phase's store (checkpoint_every_job) runs two
    co-batched w24 sessions and is abandoned without drain or close; a
    child process (``--serve-worker``) starts then, reaches the card
    while (c), (e), (a) and (b) run, and, told to go after them,
    recovers the store with prewarm: its kernel
    libraries are compile.kernel.*.hit (the whole run builds into the
    store's kernel_cache, QRACK_TPU_KERNEL_CACHE), the recorded program
    is rebuilt, the recovered kets hash equal to the abandoned ones, and
    its first job is a compile.serve_batch.hit.  (e) The canary at rate 1
    on a w20 session (SERVE_CANARY_WIDTH): a clean job verifies, an
    amp-corrupt at serve.dispatch is caught (1 mismatch) and strikes the
    card once.  The phase's seconds are printed beside its budget of 30 s
    (SERVE_PHASE_S), a budget, not a bar.

43. The fleet (qrack_tpu_torch/fleet, ROADMAP item 16c) on the card: a
    FleetSupervisor of FLEET_WORKERS (2) ``python -m
    qrack_tpu_torch.fleet.worker`` processes, each a QrackService on the
    card (its own CUDA context; hold_lease=False,
    checkpoint_every_job=True) over one store in a temporary directory
    (the free disk checked as phase 39 checks it), started before phase
    42 so that the workers boot while it runs.  The store's
    kernel_cache holds a copy of the libraries the run built, so no
    worker runs nvcc: every worker incarnation that launched a kernel
    (the killed and the retired ones too) counts
    compile.kernel.window_kernel.hit in the telemetry of its beats, and
    no incarnation a miss.  Through
    a FleetFrontDoor: two w26 dense sessions (FLEET_WIDTH: 512 MiB of
    planes and a 1 GiB complex128 snapshot at every job, each past the
    placement budget so each owns a worker), one w20 (FLEET_SMALL_WIDTH),
    one w64 GHZ on "stabilizer"; seeded QFT and wave jobs.  (a) The owner
    of a w26 session is killed with SIGKILL while that session's job is
    journaled and not settled: the front door's apply returns without a
    resubmit, the adopter's WAL replay lands the job once (replayed +
    deduplicated = 1), the next job lands on the peer, the dead worker
    restarts to healthy with one crash; the adopted ket (read back in
    this process from the store's every-job snapshot) is torch.equal to
    an uninterrupted in-process QrackService run of the same jobs, and
    the w20 session's get_state equal to its own.  (b) A rolling restart
    with all four sessions live: no SIGKILL needed, every session
    migrated, the next jobs exact as in (a), the GHZ's Prob 0.5.  (c)
    boot_worker adds a worker, booted beside (b)'s restart once its
    first drain has begun; a third w26 session is created and its
    owner retired by scale_down: it lands on a peer, its next job
    exact, the retired incarnation's metrics still in the fleet merge
    and the fleet JSONL.  Every dense ket within the dense bar of a
    direct QEngineCUDA run of its jobs; the only death the injected
    kill.  Printed: kill to detected, adopted, the in-flight apply's
    return and the next result, in ms; the adoption's recover wall and
    its container read (GB/s), and this process's read and upload of
    the same snapshots; each worker's boot to ready; each rolling
    restart's drain, SIGTERM and reap, adoption and respawn to ready; the
    card's used memory (cudaMemGetInfo, every process) at each event;
    each worker incarnation's K1/K2 launches (from its beats) beside
    the served jobs' planned sweeps (the launches add each boot's
    prewarm and the WAL replay); the phase's seconds beside its budget
    of 60 s (FLEET_PHASE_S), a budget, not a bar.

The kernels line counts K1/K2 launches by dtype form over every dense
path (phases 3, 8-12, 14-17, 19-22, 24-28, 37, 38, 39, 40, 42 and 43); their times and errors
are those of the launches held to plain (float32: phase 4 and the Shor
IQFT of phase 10; the other forms: phase 14).  The per-page form of K1
and K2 has entries of its own: launches over phases 29-32, times and
errors over the launches held in phase 29, and the w32 engine path's
launches at pages of 2^30 (l30_*).  Phase 33's launches count with the
per-page form, phase 36's with the dense one; phase 37's w32 QFT with
the per-page form, its w16 TurboQuant engine with K3-K5; phase 38's
pagers' with the per-page form, its w24 TurboQuant engine with K3-K5;
phase 39's pagers' with the per-page form, its w28 TurboQuant engines
with K3-K5, the rest with the dense form; phase 40's routed w30
TurboQuant engine with K3-K5, its w20 pager (g) with none of them (its
launches are not read), the rest with the dense form; phase 41's
per-page K1/K2 of every rank with the per-page form; phase 42's K1/K2
of every served job (its folds, its replays and (d)'s child) with the
dense form; phase 43's K1/K2 of every worker incarnation with the dense
form.

``--tq-only`` runs the build and phases 5-7 alone; ``--algo-only`` the
build and phases 8-12; ``--fppow-only`` the build and phases 13-17;
``--layers-only`` the build and phases 18-28; ``--pager-only`` the build
and phases 29-32; ``--wide-only`` the build and phases 33-36;
``--telemetry-only`` the build and phase 37 (its disabled wall then
held to two warm reps of its own in place of phase 4's);
``--resilience-only`` the build and phase 38 (likewise);
``--checkpoint-only`` the build and phase 39; ``--route-only`` the build
and phase 40; ``--cluster-only`` the build and phase 41;
``--serve-only`` the build and phase 42; ``--fleet-only`` the build and
phase 43.

The line before the last is the "kernels" summary, the last line
{"ok": true, "device": {...}}.  Any failed check raises, so the script
exits non-zero and prints no result.  Without a CUDA device it exits
non-zero at once.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import time

# the w30 plain comparisons allocate and free many 4-8 GiB temporaries
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

WIDTH = 30            # MAX_DENSE_QB: the widest single dense shard
CHECK_WIDTH = 24      # random-window kernel checks
PERM = 0x2A5C3F1      # basis state the QFTs start from
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores, and dense TF32 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12
DEVICE = "cuda"
KERNEL_SOURCE = "qrack_tpu_torch/csrc/window_kernel.cu"
REPLACES = {"in_tile": "qrack_tpu/ops/pallas_kernels.py:294",
            "pair": "qrack_tpu/ops/pallas_kernels.py:315"}
# flops per touched amplitude: a complex product (4 mul + 2 add); the
# general 2x2 takes two products and a complex sum
FLOPS_PER_AMP = {0: 6, 1: 6, 2: 6, 3: 14}
# kernel against plain: max abs diff <= min(ABS_BAR, REL_BAR * max|amp|)
ABS_BAR = 1e-6
REL_BAR = 1e-4

TQ_WIDTH = 32         # the widest int8 ket the compressed engine allows
TQ_PERM = 0xA5C3F1E7  # basis state of the w32 QFT (top bit set)
TQ_SOURCE = "qrack_tpu_torch/csrc/turboquant_kernel.cu"
TQ_REPLACES = {"gate_low": "qrack_tpu/ops/pallas_turboquant.py:95",
               "diag": "qrack_tpu/ops/pallas_turboquant.py:139",
               "window": "qrack_tpu/ops/pallas_turboquant.py:186"}
# kernel against plain on quantized outputs (see the docstring)
TQ_CODE_FRAC = {8: 1e-3, 16: 1e-2}
TQ_SCALE_REL = 1e-5
# flops per amplitude an op acts on (complex product, or a 2x2 row)
TQ_OP_FLOPS = {0: 6, 1: 6, 3: 14}
TQ_WINDOW_HELD = 1 / 48  # share of tq_window's launches held to plain
TQ_WINDOW_SEED = 79

ALU_WIDTH = 22        # the CUDA engine against the complex128 oracle
# FPPOW planes (phases 13-16)
FPPOW_DTYPES = (torch.float64, torch.bfloat16, torch.float16)
PEAK_F64_S = 34e12    # H100 SXM float64 on the CUDA cores (data sheet)
ULP_BITS = {torch.bfloat16: 7, torch.float16: 10}  # significand bits
F64_REL_BAR = 1e-13   # kernel against plain at float64, of the largest |amp|
HALF_ULP_BAR = 4      # ... at 16 bits, in ulps of the dtype there
F64_QFT_BAR = 1e-9    # the float64 w30 QFT: |amp|^2 rel. error, 1 - ProbAll
# the 16-bit w30 QFTs against the float64 ket: 1 - fidelity, predicted
# in PERF.md from the plain version on the CPU (w10-w22, grown to w30)
HALF_QFT_BAR = {torch.bfloat16: 1e-3, torch.float16: 2e-5}
# phase 14 holds every eighth launch of each dtype's w30 QFT to plain
# (holding all of them took 105 s of an 822.7 s run on the H100, every
# second 264.6 s for phases 13-17 against 322; every fourth until the
# pager's second slice needed the room)
FPPOW_PROBE_EVERY = 8
# phase 4 holds every eighth launch of the w30 main path to plain
# (every second, then every fourth, then every sixth, until the run
# budget's cuts)
DENSE_PROBE_EVERY = 8
DRIFT_THRESH = "1e-5"  # QRACK_TPU_AUTO_F64_DRIFT of the drift phase
DRIFT_EVERY = "64"     # QRACK_TPU_DRIFT_CHECK_GATES
# the drift phase's Grover runs an eighth of the search's 3216 iterations
# (the whole search took 131 s of an 822.3 s run, a quarter 33 s in PR
# 14's; the escalation fires within the first dozen); a sixteenth since
# the run budget's cut that paid for the widths of phases 16 and 28
DRIFT_ITERS = 201
BATCH_WIDTH = 28      # compile_batched_fn: 4 kets of 28 qubits
BATCH = 4
BATCH_GATES = 48
UC_WIDTH = 27         # UniformlyControlledRY with 12 scattered controls
UC_CONTROLS = 12
PLANE_BOUND_MS = 2 * 2 * (1 << WIDTH) * 4 / PEAK_BYTES_S * 1e3
SHOR_MOD = 32639      # 127 * 257
SHOR_BASE = 21591     # 3 mod 257 (a primitive root), 1 mod 127: order 256
SHOR_ORDER = 256
SHOR_WIDTH = 15       # 2 * 15 = WIDTH qubits; the out register is 15 bits
HYBRID_START = 10     # below the hybrid threshold (13): QEngineCPU
HYBRID_GROW = 14      # composed on: 24 qubits, QEngineCUDA
RCS_DEPTH = 6           # 12 until the run budget's cut
RCS_SEED = 7
GROVER_WIDTH = 24     # 3216 iterations (the drift phase)
GROVER_ENGINE_WIDTH = 22  # phase 12: 804 iterations (w24 until PR 15's cut)
# the layers above the terminals (phases 18-22)
QV_WIDTH = WIDTH      # quantum_volume's gates through OPTIMAL and "cuda"
QV_DEPTH = 10          # 30, then 20, until the run budget's cuts (PERF.md)
QV_SEED = 30
QV_AMPS = 4096        # seeded GetAmplitude reads compared
QFT_WIDE = 40         # the permutation-init QFT that QUnit keeps factored
QFT_WIDE_AMPS = 256
GHZ_OPTIMAL = 40      # GHZ + T through OPTIMAL, on the tableau
GHZ_CLIFFORD = 64     # GHZ through "unit_clifford"
SWITCH_WIDTH = 18     # the tableau -> QEngineCUDA switch
SWITCH_DEPTH = 400    # seeded Clifford gates before the forcing gate
# the decision tree, the tensor network and the noise plane (phases 23-28)
BDT_QFT_WIDTH = 48    # permutation-init QFT through "bdt_hybrid"
BDT_AMPS = 4096
BDT_GHZ = 64
BDT_ATT_WIDTH = 36    # "bdt_attached": 20 tree qubits over 2^16 leaves
BDT_ATT_QB = 16
BDT_ATT_DEPTH = 10
BDT_SWITCH_WIDTH = 20
# QBdtHybrid's node budget, ratio * 2^n: 2^14 nodes at w20.  Every gate
# walks the whole tree on the host, so reaching the default 0.25 (2^18
# nodes) would cost 16 times the walks of every gate near the budget
BDT_SWITCH_RATIO = 1 / 64
BDT_SWITCH_AFTER = 10  # layers on the card after the switch
TN_WIDTH = 30
TN_WIDE = 64
TN_DEPTH = 8
TN_PROBES = 8
TN_WIDE_PROBE = 32
NOISY_WIDTH = 24
NOISY_DEPTH = 12
NOISY_LAMBDA = 1e-3
TRAJ_WIDTH = 24
TRAJ_DEPTH = 4           # 10, then 6, until the run budget's cuts
TRAJ_B = 64           # 8 GiB of float32 planes
TRAJ_CHUNK = "16"
TRAJ_ROOM = 20.5      # trajectories' peak bytes left free for the budget run
TRAJ_KEY = 24
PAGER_PARITY_WIDTH = 30   # 4 pages of 2^28 beside a w30 QEngineCUDA
PAGER_PAGES = 4
PAGER_DEPTH = 10          # 20 until the run budget took the cut (PERF.md)
PAGER_SEED = 10
# share of the other per-page launches held (an eighth until phase 37
# needed the room)
PAGER_HELD = 1 / 16
PAGER_WIDTH = 32          # 4 pages of 2^30 float32: 32 GiB of planes
PAGER_PERM = 0x9A5C3F1E   # basis state of the w32 QFT (top bit set)
PAGER_W33 = 33            # 8 pages of 2^30: 64 GiB of planes
PAGER_W33_PAGES = 8
PAGER_PERM33 = 0x1A5C3F1E7
PAGER_FACTORY_WIDTH = 31  # 2 pages of 2^30
PAGE_MEM_BAR = 4 << 30    # half a page of 2^30 float32 amplitudes
PAGE_L30 = {}             # the w32 engine path's launches, timed
PHASE4_WARM = []          # phase 4's warm engine-path w30 QFT walls (ms)
# the rest of the pager (phases 33-36)
WIDE_WIDTH = 32           # 4 pages of 2^30: every ALU op split-index
WIDE_SEED = 33
RCS_PAGE_DEPTH = 6        # make_sharded_rcs_fn at w30
SHARDED_QFT_WIDTH = 26    # compile_sharded_fn's QFT: 4 pages of 2^24
                          # (w28 until the run budget's second cut)
SHARDED_QFT_FN_WIDTH = 30  # make_sharded_qft_fn: 4 pages of 2^28
GROVER_PAGE_ITERS = 3     # make_sharded_grover_fn ...
SHARDED_GROVER_WIDTH = 30  # ... on 4 pages of 2^28 (w32 until PR 15's cut)
TQ_PAGER_WIDTH = 31       # the TurboQuant pager's GHZ (w32, TQ_WIDTH, until
                          # the run budget's cut)
TQ_PAGER_SMALL = 26       # the TurboQuant pager against QEngineCUDA
TQ_PAGER_READS = 35       # seed of the half of the qubits phase 35 reads
UNIT_MULTI_HALF = 24      # two separable 24-qubit registers
UNIT_MULTI_DEPTH = 6
UNIT_MULTI_SEED = 36
UNIT_MULTI_AMPS = 1024    # seeded GetAmplitude reads compared
# the telemetry plane (phase 37)
RES_DISABLED_BAR = 0.02   # phase 38: w30 QFT, plane off, against phase 4's
                          # QFT in the same seconds (against_reference)
RES_STAIR_WIDTH = 30      # the staircase and the shrink drill ...
RES_STAIR_PAGES = 4       # ... on 4 pages of 2^28
RES_CPU_WIDTH = 20        # the named CPU rung; the hang drill
RES_TQ_WIDTH = 24         # the TurboQuant drill, int8
RES_SEED = 38
RES_HANG_S = 2.0          # the watchdog's timeout in the hang drill
RES_HANG_SLACK_S = 1.0
RES_PHASE_S = 35.0        # phase 38's budget (printed, as the run's 880 s)
# the checkpoint plane (phase 39)
CKPT_SEED = 39
CKPT_DENSE_WIDTH = 27     # (a) the dense file (w30, then w28, until the run budget's cuts)
CKPT_PAGER_WIDTH = 26     # 4 pages of 2^24: a 1 GiB file (complex128; w28,
CKPT_PAGER_PAGES = 4      # then w27, until the run budget's cuts)
CKPT_PAGER_PERM = 0x1A5C3F1  # 26 bits (0x5A5C3F1 at w27)
CKPT_TQ_WIDTH = 28        # int8 codes: 512 MiB
CKPT_STACK_WIDTH = 24     # "optimal"
CKPT_FAILOVER_WIDTH = 20  # the failover snapshot file's drills
CKPT_FAILOVER_PERM = 0x5C3F1
CKPT_MEM_BAR = 1 << 30    # device bytes above the planes, save or load
CKPT_ROOM = 1.2           # free disk over the bytes written at once
CKPT_PHASE_S = 60.0       # phase 39's budget (printed, as the run's 880 s)
ROUTE_SEED = 40
ROUTE_TQ_WIDTH = 28       # (a) the routed TurboQuant QFT (w30 until the run budget's cut)
ROUTE_TQ_BAR = 0.99       # phase 40(a): the TurboQuant fidelity bar of phase 6
ROUTE_TQ_PAGES = 4        # pages of 4096 amplitudes held to the closed form
ROUTE_GHZ = 100           # (c) the Clifford circuit past every dense rung
ROUTE_LC_WIDTH = 50       # (d) the README's w50 depth-4 brickwork
ROUTE_WIDE = 100          # (e) brickwork on "lightcone" ...
ROUTE_WIDE_LAYERS = tuple(range(8, 14))  # ... brick layers tried
ROUTE_WIDE_READS = 100    # one Prob(q) a qubit
ROUTE_REPLAY_EVERY = 10   # every tenth cone through the plain gate path
ROUTE_MISROUTE_WIDTH = 24
ROUTE_REFUSED_WIDTH = 40  # past the compressed rung (w32)
ROUTE_REPEAT_WIDTH = 20   # (g) the draws' repeat, as phase 39's MAll check
ROUTE_REPEATS = 30
ROUTE_SHOTS = 1024
ROUTE_LC_REPEAT = 24      # the light-cone sessions of (g) and (h)
ROUTE_CKPT_WIDTH = 20
ROUTE_PHASE_S = 40.0      # phase 40's budget (printed, as the run's 880 s)
# pages in several processes (phase 41).  The card is one: NCCL refuses
# two ranks on one device, so the two-rank cells take gloo, both ranks
# on cuda:0, each holding half of the ket's pages; NCCL runs as a group
# of one
CLUSTER_NCCL_WIDTH = 28   # (a) 4 pages of 2^26 on a group of one
CLUSTER_WIDTH = 28        # (b), (f) 4 pages of 2^26, 2 a rank: the top page
CLUSTER_PAGES = 4         #     bit crosses the ranks (w30 until the run
                          #     budget's cut)
CLUSTER_RANKS = 2
CLUSTER_SEED = 41
CLUSTER_TQ_WIDTH = 24     # (d) the TurboQuant pager, 16-bit codes
CLUSTER_CKPT_WIDTH = 24   # (e) the file round trip
CLUSTER_PROGRAM_WIDTH = 26  # (c) the page-list QFT (SHARDED_QFT_WIDTH,
                            #     w28, until the run budget's cut)
CLUSTER_STAIR_WIDTH = 26  # (g) the staircase to the dense replicas (w28
                          #     until the run budget's cut)
CLUSTER_STRUCT_WIDTH = 24  # (h) quarantine, structure, TurboQuant's plane
# what only the rank where a fault fired records
CLUSTER_LOCAL = ("resilience.fault.", "resilience.timeout.",
                 "resilience.abandoned_threads")
CLUSTER_TIMEOUT_S = 420   # a cohort's limit: past it every worker is killed
CLUSTER_PHASE_S = 90.0    # phase 41's budget (printed, as the run's 880 s)
SERVE_WIDTH = 27          # (a), (b) eight tenants of 1 GiB: one w30 fold
SERVE_TENANTS = 8
SERVE_SEED = 42
SERVE_WAVE_GATES = 24     # (b), (e) each seeded wave circuit
SERVE_PREFIX_WIDTH = 24   # (c) the shared state-prep
SERVE_WARM_WIDTH = 24     # (d) the warm start's two sessions
SERVE_CANARY_WIDTH = 20   # (e) the canary's session
SERVE_MEM_SLACK = 1 << 30  # (a) above twice the sessions' planes
SERVE_CHILD_TIMEOUT_S = 300
SERVE_PHASE_S = 30.0      # phase 42's budget (printed, as the run's 880 s)
FLEET_WORKERS = 2         # worker processes on the one card
FLEET_WIDTH = 26          # the dense sessions (w30: a save a job, ~21 s)
FLEET_SMALL_WIDTH = 20    # the session whose ket crosses the wire
FLEET_STAB_WIDTH = 64     # the GHZ on the tableau (STABILIZER_COST)
FLEET_SEED = 43
FLEET_DISK_BYTES = 6 << 30  # the snapshots and their temporaries at once
FLEET_READY_TIMEOUT_S = 300.0
FLEET_PHASE_S = 60.0      # phase 43's budget (printed, as the run's 880 s)
TELE_DISABLED_BAR = 0.02  # disabled w30 QFT wall against phase 4's QFT
                          # in the same seconds (against_reference)
TELE_HOOK_WIDTH = 16      # the small stacks that reach every other hook
TELE_REQUIRED = (         # counter families phase 37 must reach
    "gate.cuda.", "fuse.cuda.", "fuse.kernel.windows", "fuse.kernel.sweeps",
    "roofline.cuda.fuse.flush.", "gate.pager.", "fuse.pager.",
    "remap.pager.", "exchange.pager.", "exchange.pager.host_fetch",
    "roofline.pager.exchange.", "tq.sweeps", "fuse.tq.",
    "roofline.tq.sweep.", "fuse.turboquant.", "qunit.",
    "stabilizer.to_dense", "hybrid.grow.", "hybrid.switch.",
    "qbdt.to_dense", "qunitmulti.redistribute", "noise.traj.",
    "factory.create", "checkpoint.save", "checkpoint.restore",
    "compile.kernel.", "engine.cuda.f64_escalation",
    "telemetry.profiler.dump", "roofline.chip.qft.w30.")
ROOT = os.path.dirname(os.path.abspath(__file__))


T_START = time.time()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.time() - T_START, 1)}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def release() -> None:
    """Free the card's memory of the engines a phase dropped: an engine
    and its gate fuser refer to each other, so only the collector frees
    them."""
    gc.collect()
    torch.cuda.empty_cache()


def chunked_max(x, y=None) -> float:
    """max |x| (or max |x - y|) in float64, a slice of the planes at a
    time: a float64 w30 ket is 16 GiB, and a whole difference as much."""
    x = x.reshape(2, -1)
    y = None if y is None else y.reshape(2, -1)
    step = 1 << 26
    most = 0.0
    for s0 in range(0, x.shape[1], step):
        a = x[:, s0:s0 + step].double()
        if y is not None:
            a = a - y[:, s0:s0 + step].double()
        most = max(most, float(a.abs().max()))
    return most


def plain_bar(dtype, scale: float) -> float:
    """The kernel-against-plain bar at the largest |amp| `scale`: float32
    min(ABS_BAR, REL_BAR * scale); float64 F64_REL_BAR * scale; 16-bit
    planes HALF_ULP_BAR units in the last place of the dtype at scale."""
    if dtype == torch.float64:
        return F64_REL_BAR * scale
    if dtype in ULP_BITS:
        return HALF_ULP_BAR * 2.0 ** (np.floor(np.log2(scale)) - ULP_BITS[dtype])
    return min(ABS_BAR, REL_BAR * scale)


def held_to_plain(got, want, what: str) -> tuple:
    """(max abs diff, that diff over the largest |amp| of `want`); raises
    when the diff is above plain_bar for the planes' dtype."""
    err = chunked_max(got, want)
    scale = chunked_max(want)
    bar = plain_bar(want.dtype, scale)
    check(err <= bar, f"{what}: kernel differs from plain by {err} "
                      f"(bar {bar}, largest |amp| {scale}, {want.dtype})")
    # an all-zero input (a page the ket has not reached) must stay zero
    return err, err / scale if scale else 0.0


def fidelity(a, b) -> float:
    """|<a|b>|^2 / (<a|a><b|b>) of two (2, N) plane tensors, accumulated
    in float64 chunk by chunk on a's device (b may lie on the host)."""
    a, b = a.reshape(2, -1), b.reshape(2, -1)
    step = 1 << 26
    re = im = na = nb = 0.0
    for s in range(0, a.shape[1], step):
        a0, a1 = a[0, s:s + step].double(), a[1, s:s + step].double()
        b0 = b[0, s:s + step].to(a.device).double()
        b1 = b[1, s:s + step].to(a.device).double()
        re += float(a0 @ b0 + a1 @ b1)
        im += float(a0 @ b1 - a1 @ b0)
        na += float(a0 @ a0 + a1 @ a1)
        nb += float(b0 @ b0 + b1 @ b1)
    return (re * re + im * im) / (na * nb)


def random_op(rng, n: int, kind: int, t: int, fu):
    """One fused op of kind 0-3 (cphase, diag, inv, gen) on target t: 0-2
    controls anywhere else, mixed control values but for a cphase."""
    others = [q for q in range(n) if q != t]
    nc = min(int(rng.integers(0, 3)), len(others))
    cmask = 0
    for c in (rng.choice(others, nc, replace=False) if nc else ()):
        cmask |= 1 << int(c)
    cval = cmask
    if kind and cmask and rng.integers(2):
        cval = cmask & int(rng.integers(1 << n))
    a, b = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 2))
    if kind == 0:
        m = np.diag([1.0 + 0j, b])
    elif kind == 1:
        m = np.diag([a, b])
    elif kind == 2:
        m = np.array([[0, a], [b, 0]])
    else:
        z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        m, _ = np.linalg.qr(z)
    m = np.asarray(m, dtype=np.complex128)
    return fu.FusedOp(fu.classify(m, cmask, cval), t, cmask, cval, m)


def random_window(rng, n: int, k: int, fu):
    """k fused ops over the whole vocabulary: targets anywhere (so below
    and above the tile width)."""
    return [random_op(rng, n, int(rng.integers(4)), int(rng.integers(n)), fu)
            for _ in range(k)]


def pair_cases(rng, n: int, bp: int, fu, wk, dtype=torch.float32) -> list:
    """(label, ops) of pair-led segments at width n, each one window
    that plans as a single pair sweep: in-tile inv/gen whose targets
    cycle through the register, lane and warp bits of the pair layout of
    `dtype` planes, with diagonal ops between; a 256-op diagonal run
    after a cross-tile H; the trailing segment of qft_qcircuit(n)."""
    from qrack_tpu_torch.models.qft import qft_qcircuit

    lay = wk.pair_layout(bp, dtype)
    classes = [lay["register"], lay["lane"], lay["warp"]]
    routes = [random_op(rng, n, 3, bp + 4, fu)]
    for i in range(72):
        bits = classes[(i // 2) % 3]
        routes.append(
            random_op(rng, n, 2 + int(rng.integers(2)),
                      int(bits[int(rng.integers(len(bits)))]), fu)
            if i % 2 == 0 else
            random_op(rng, n, int(rng.integers(2)), int(rng.integers(n)), fu))
    h = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
    diagonal = [fu.FusedOp(fu.classify(h, 0, 0), bp, 0, 0, h)] + [
        random_op(rng, n, int(rng.integers(2)), int(rng.integers(n)), fu)
        for _ in range(256)]
    qft = fu.lower_gates(qft_qcircuit(n).gates)
    xop = wk.segment_launches(fu.structure_of(qft), bp)[-1][0]
    return [("routes", routes), ("diagonal_run", diagonal),
            ("qft_tail", qft[xop:])]


def tile_cases(rng, n: int, bp: int, fu, wk, dtype=torch.float32) -> list:
    """(label, ops) of in-tile segments at width n, each one window that
    plans as a single in-tile sweep: inv/gen whose targets cycle through
    the register, lane and warp bits of the tile layout of `dtype` planes
    that bp has, with diagonal ops (targets anywhere) between; at n > bp
    also a 256-op diagonal run that ends in an inv/gen on the highest
    thread bit (or a register bit)."""
    lay = wk.tile_layout(bp, dtype)
    classes = [c for c in (lay["register"], lay["lane"], lay["warp"]) if c]
    routes = []
    for i in range(72):
        bits = classes[(i // 2) % len(classes)]
        routes.append(
            random_op(rng, n, 2 + int(rng.integers(2)),
                      int(bits[int(rng.integers(len(bits)))]), fu)
            if i % 2 == 0 else
            random_op(rng, n, int(rng.integers(2)), int(rng.integers(n)), fu))
    if n == bp:
        return [("routes", routes)]
    diagonal = [random_op(rng, n, int(rng.integers(2)), int(rng.integers(n)),
                          fu) for _ in range(256)]
    top = (lay["warp"] or lay["lane"] or lay["register"])[-1]
    diagonal.append(random_op(rng, n, 3, top, fu))
    return [("routes", routes), ("diagonal_run", diagonal)]


def launch_bound(n: int, rows, iv, dtype=torch.float32) -> tuple:
    """(bytes time, operations time) in ms of one sweep: both planes read
    and written once in `dtype`, and the flops the window's ops need on
    this data (a controlled op touches 2^n / 2^popcount(mask) amplitudes)
    at the card's float64 rate for float64 planes and its float32 rate
    for the others (16-bit planes compute in float32)."""
    esize = torch.empty((), dtype=dtype).element_size()
    bytes_ms = 2 * 2 * (1 << n) * esize / PEAK_BYTES_S * 1e3
    flops = 0
    for kind, t, has_ctrl, _foff, ioff in rows:
        cm = int(iv[ioff]) if has_ctrl else 0
        mask = cm | (1 << t) if kind == 0 else cm
        flops += FLOPS_PER_AMP[kind] * ((1 << n) >> bin(mask).count("1"))
    peak = PEAK_F64_S if dtype == torch.float64 else PEAK_F32_S
    return bytes_ms, flops / peak * 1e3


class SweepProbe:
    """Wraps the two sweep entry points of ops/window_kernel.py.  Every
    launch the wrapped main path makes is run as the kernel and as its
    plain version on the same input, each between CUDA events, and the
    two results are compared; the kernel's result goes on.  Stats go
    under the entry (float32), entry_dtype (the other dtype forms) and
    (label, entry).  With ``every`` = k only the first of each k launches
    of a form is replayed and held; the others run the kernel alone.  A
    held in-tile launch is also timed with no op (copy_only_ms), so
    copy_ms sums the loads and stores alone of the launches in ms."""

    def __init__(self, wk):
        self.wk = wk
        self.real = {"in_tile": wk.in_tile_sweep, "pair": wk.pair_sweep}
        self.plain = {"in_tile": wk.in_tile_sweep_plain,
                      "pair": wk.pair_sweep_plain}
        self.stats = {}
        self.label = None
        self.every = 1
        self.seen = {}

    def _entry(self, name):
        from qrack_tpu_torch.ops.gatekernels import dtype_name

        def run(planes, n, bp, table, fv, iv, *span):
            # float32 launches under the entry's name, the other dtype
            # forms under entry_dtype
            form = (name if planes.dtype == torch.float32
                    else f"{name}_{dtype_name(planes.dtype)}")
            k = self.seen.get(form, 0)
            self.seen[form] = k + 1
            if not self._held(k):
                return self.real[name](planes, n, bp, table, fv, iv, *span)
            ref = planes.clone()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            sync()
            ev[0].record()
            self.real[name](planes, n, bp, table, fv, iv, *span)
            ev[1].record()
            ev[2].record()
            self.plain[name](ref, n, bp, table, fv, iv, *span)
            ev[3].record()
            sync()
            err, rel = held_to_plain(planes, ref,
                                     f"{self.label} {name} sweep")
            copy_ms = (copy_only_ms(self.wk, ref, n, bp, table, fv, iv,
                                    span[-2]) if name == "in_tile" else None)
            del ref
            first, count = span[-2], span[-1]
            idx = ([span[0]] if name == "pair" else []) + list(
                range(first, first + count))
            host_table = table.cpu().tolist()
            host_iv = iv.cpu().tolist()
            b_ms, o_ms = launch_bound(n, [host_table[i] for i in idx], host_iv,
                                      planes.dtype)
            ms = ev[0].elapsed_time(ev[1])
            for key in (form, (self.label, name)):
                s = self.stats.setdefault(key, {
                    "launches": 0, "ms": 0.0, "plain_ms": 0.0,
                    "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                    "max_abs_err": 0.0, "max_rel_err": 0.0,
                    "largest_ops": 0, "largest_ms": 0.0,
                    "largest_bound_ms": 0.0})
                s["launches"] += 1
                s["ms"] += ms
                s["plain_ms"] += ev[2].elapsed_time(ev[3])
                s["bytes_ms"] += b_ms
                s["ops_ms"] += o_ms
                s["bound_ms"] += max(b_ms, o_ms)
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s["max_rel_err"] = max(s["max_rel_err"], rel)
                if copy_ms is not None:
                    s["copy_ms"] = s.get("copy_ms", 0.0) + copy_ms
                if len(idx) > s["largest_ops"]:
                    s["largest_ops"] = len(idx)
                    s["largest_ms"] = ms
                    s["largest_bound_ms"] = max(b_ms, o_ms)
            return planes
        return run

    def _held(self, k: int) -> bool:
        """Is launch k of its dtype form replayed and held to plain?"""
        return k % self.every == 0

    def __enter__(self):
        self.wk.in_tile_sweep = self._entry("in_tile")
        self.wk.pair_sweep = self._entry("pair")
        return self

    def __exit__(self, *exc):
        self.wk.in_tile_sweep = self.real["in_tile"]
        self.wk.pair_sweep = self.real["pair"]


def copy_only_ms(wk, planes, n, bp, table, fv, iv, first) -> float:
    """ms of the in-tile kernel on `planes` with no op (count 0): it
    loads each tile and stores it back unchanged, the byte part of a
    launch without its ops.  Called on the library, not through
    window_kernel.in_tile_sweep, so the launch counts nowhere."""
    lib = wk.load_library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = []
    ms = timed(lambda: err.append(lib.qtt_window_in_tile(
        planes.data_ptr(), wk.DTYPE_CODE[planes.dtype], n, bp,
        table.data_ptr(), first, 0, fv.data_ptr(), iv.data_ptr(), stream)))
    check(err == [0], f"copy-only in-tile launch failed: CUDA error {err}")
    return ms


def timed_warm(fn, reps: int = 3) -> float:
    """Median ms of `reps` timed calls of fn(), after one warm call."""
    fn()
    return float(np.median([timed(fn) for _ in range(reps)]))


def against_reference(measured, reps: int = 3) -> tuple:
    """Phases 37-38's A/B: `reps` walls of measured() (ms, one call a
    wall) alternated with `reps` of phase 4's engine-path w30 QFT, timed
    as phase 4 times it on a fresh engine of its own, after one warm call
    of each.  The card's w30 QFT wall drifts by up to 3.8% over a full
    run on one tree (PERF.md §6), so a disabled plane's wall is held
    against this reference, taken in the same seconds, and phase 4's own
    walls are printed beside it.  Returns (measured walls, reference
    walls)."""
    import qrack_tpu_torch as qt

    r = qt.create_quantum_interface("cuda", WIDTH)

    def ref() -> float:
        r.SetPermutation(PERM)
        return timed(lambda: (r.QFT(0, WIDTH), r.device_planes))

    ref()
    measured()
    got, refs = [], []
    for i in range(reps):
        for fn in ((ref, measured) if i % 2 == 0 else (measured, ref)):
            (refs if fn is ref else got).append(fn())
    del r
    release()
    return got, refs


def timed(fn) -> float:
    """ms of fn() between CUDA events, after a synchronise; fn ends with
    work queued on the device."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    sync()
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


# ---------------------------------------------------------------------------
# the TurboQuant kernels
# ---------------------------------------------------------------------------

def tq_compare(kc, ks, pc, ps, inp_c, inp_s, dirty, TB: int, bits: int,
               what: str) -> dict:
    """Kernel output (kc, ks) against the plain version's (pc, ps) on the
    same input (inp_c, inp_s), row block by row block; raises on a bar.
    A scale's error is taken relative to the largest scale of its tile,
    in or out (the module docstring says why).  max_abs_err is the
    largest difference of the dequantized values (code * scale / qmax,
    in the rotated frame)."""
    qmax = float((1 << (bits - 1)) - 1)
    clean = (~dirty).repeat_interleave(TB)
    rows = kc.shape[0]
    step = max(TB, 1 << 20)
    maxd = ndiff = 0
    amp_err = srel = 0.0
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        a, b = kc[r0:r1].to(torch.int32), pc[r0:r1].to(torch.int32)
        d = (a - b).abs()
        maxd = max(maxd, int(d.max()))
        ndiff += int((d > 0).sum())
        sa, sb = ks[r0:r1], ps[r0:r1]
        tile_max = torch.maximum(inp_s[r0:r1].abs(), sb.abs()).view(
            -1, TB).amax(1).repeat_interleave(TB)
        srel = max(srel, float(((sa - sb).abs()
                                / tile_max.clamp_min(1e-30)).max()))
        amp_err = max(amp_err, float(
            (a.float() * (sa / qmax)[:, None]
             - b.float() * (sb / qmax)[:, None]).abs().max()))
        cl = clean[r0:r1]
        if bool(cl.any()):
            for got_c, got_s in ((kc, ks), (pc, ps)):
                check(torch.equal(got_c[r0:r1][cl], inp_c[r0:r1][cl])
                      and torch.equal(got_s[r0:r1][cl], inp_s[r0:r1][cl]),
                      f"{what}: a tile no op acts on changed")
    frac = ndiff / kc.numel()
    check(maxd <= 1, f"{what}: codes differ by {maxd}")
    check(frac <= TQ_CODE_FRAC[bits],
          f"{what}: {frac} of the codes differ (bar {TQ_CODE_FRAC[bits]})")
    check(srel <= TQ_SCALE_REL, f"{what}: scales differ by {srel} relative")
    return {"code_max_diff": maxd, "code_diff_frac": frac,
            "scale_max_rel_err": srel, "max_abs_err": amp_err}


def tq_bound(bits: int, D: int, T: int, n_dirty: int,
             gate_flops: int) -> tuple:
    """(bytes time, operations time, operations time on the CUDA cores)
    in ms of one sweep: the codes and scales of the tiles it requantizes
    read and written once; the two products of those tiles (2 * (2D)^2
    flops per row of D each, 8 * D per amplitude) as the TF32
    tensor-core passes the kernel runs to keep float32 accuracy (three
    for each, two for the decode of int8 codes, which TF32 holds
    exactly), plus the gates' flops on the CUDA cores; and the same with
    the products once each on the CUDA cores."""
    row_bytes = 2 * D * (1 if bits <= 8 else 2) + 4
    bytes_ms = n_dirty * (T // D) * row_bytes * 2 / PEAK_BYTES_S * 1e3
    products = n_dirty * T * 16 * D
    passes = (2 if bits <= 8 else 3) + 3
    ops_ms = (passes * products / 2 / PEAK_TF32_S
              + gate_flops / PEAK_F32_S) * 1e3
    core_ms = (products + gate_flops) / PEAK_F32_S * 1e3
    return bytes_ms, ops_ms, core_ms


class TQProbe:
    """Wraps the three entry points of ops/turboquant_kernel.py.  Every
    launch made through them runs as the kernel and as its plain version
    on clones of the same input, each between CUDA events; the two are
    compared (tq_compare) and the kernel's result goes on."""

    ENTRIES = ("gate_low", "diag", "window")

    def __init__(self, tqk):
        self.tqk = tqk
        self.real = {e: getattr(tqk, f"tq_{e}") for e in self.ENTRIES}
        self.plain = {e: getattr(tqk, f"tq_{e}_plain") for e in self.ENTRIES}
        self.stats = {}
        self.label = None
        # tq_window's launches held to plain: the first, then a seeded
        # draw of TQ_WINDOW_HELD of the rest (its plain replay of all 79
        # took 179 s); every launch is timed
        self._draw = np.random.default_rng(TQ_WINDOW_SEED)
        self._seen = 0

    def _held(self, name) -> bool:
        if name != "window":
            return True
        self._seen += 1
        return self._seen == 1 or self._draw.random() < TQ_WINDOW_HELD

    def _dirty_flops(self, name, codes, tp, args):
        tqk = self.tqk
        bp, T, _TB, nblk = tqk.layout(codes, tp)
        n = (codes.shape[0] << bp).bit_length() - 1
        blk = torch.arange(nblk, dtype=torch.int32, device=codes.device)
        if name == "gate_low":
            _mp, _t, hm, hv, lm, _lv = args
            dirty = tqk.gate_low_dirty(blk, hm, hv)
            return dirty, int(dirty.sum()) * (T >> bin(lm).count("1")) * 14
        if name == "diag":
            dp, tm_lo, tb_hi, lm, _lv, hm, hv = args
            dirty = tqk.diag_dirty(blk, dp, tm_lo, tb_hi, lm, hm, hv)
            return dirty, int(dirty.sum()) * (T >> bin(lm).count("1")) * 6
        structure, operands = args
        table, fv, iv = tqk.pack_window(structure, operands, codes.device)
        rows, ivh = table.tolist(), iv.tolist()
        dirty = tqk.window_dirty(blk, tp, rows, fv, iv)
        flops = 0
        for kind, t, has_ctrl, _foff, ioff in rows:
            if kind == 0:
                mask = (ivh[ioff] | (ivh[ioff + 1] << tp)) if has_ctrl \
                    else 1 << t
            else:
                mask = (ivh[ioff] | (ivh[ioff + 2] << tp)) if has_ctrl else 0
            flops += TQ_OP_FLOPS[kind] * ((1 << n) >> bin(mask).count("1"))
        return dirty, flops

    def _entry(self, name):
        def run(codes, scales, rot, rot_t, bits, tp, *args):
            held = self._held(name)
            if held:
                inp_c, inp_s = codes.clone(), scales.clone()
                pc, ps = codes.clone(), scales.clone()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            sync()
            ev[0].record()
            self.real[name](codes, scales, rot, rot_t, bits, tp, *args)
            ev[1].record()
            ev[2].record()
            if held:
                self.plain[name](pc, ps, rot, rot_t, bits, tp, *args)
            ev[3].record()
            sync()
            dirty, gflops = self._dirty_flops(name, codes, tp, args)
            bp, T, TB, _nblk = self.tqk.layout(codes, tp)
            res = {}
            if held:
                res = tq_compare(codes, scales, pc, ps, inp_c, inp_s, dirty,
                                 TB, bits, f"{self.label} {name}")
                del inp_c, inp_s, pc, ps
            n_dirty = int(dirty.sum())
            b_ms, o_ms, core_ms = tq_bound(bits, 1 << bp, T, n_dirty, gflops)
            for key in (name, (self.label, name)):
                s = self.stats.setdefault(key, {
                    "launches": 0, "ms": 0.0, "plain_ms": 0.0,
                    "held_launches": 0, "held_ms": 0.0,
                    "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                    "f32_core_bound_ms": 0.0,
                    "dirty_tiles": 0, "tiles": 0, "max_abs_err": 0.0,
                    "code_max_diff": 0, "code_diff_frac": 0.0,
                    "scale_max_rel_err": 0.0})
                s["launches"] += 1
                s["ms"] += ev[0].elapsed_time(ev[1])
                if held:
                    s["held_launches"] += 1
                    s["held_ms"] += ev[0].elapsed_time(ev[1])
                    s["plain_ms"] += ev[2].elapsed_time(ev[3])
                s["bytes_ms"] += b_ms
                s["ops_ms"] += o_ms
                s["bound_ms"] += max(b_ms, o_ms)
                s["f32_core_bound_ms"] += max(b_ms, core_ms)
                s["dirty_tiles"] += n_dirty
                s["tiles"] += int(dirty.numel())
                for k in res:
                    s[k] = max(s[k], res[k])
            return codes, scales
        return run

    def __enter__(self):
        for e in self.ENTRIES:
            setattr(self.tqk, f"tq_{e}", self._entry(e))
        return self

    def __exit__(self, *exc):
        for e in self.ENTRIES:
            setattr(self.tqk, f"tq_{e}", self.real[e])


def tq_random_window(rng, n: int, tp: int, k: int, fu) -> list:
    """k FusedOps: controlled phases, diagonals and in-tile 2x2s, with
    targets and controls anywhere (gen targets below the tile) and mixed
    control values."""
    ops = []
    for _ in range(k):
        kind = int(rng.integers(3))
        t = int(rng.integers(tp if kind == 2 else n))
        others = [q for q in range(n) if q != t]
        cmask = 0
        for c in rng.choice(others, int(rng.integers(0, 3)), replace=False):
            cmask |= 1 << int(c)
        a, b = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 2))
        if kind == 0:
            m, cval = np.diag([1.0 + 0j, b]), cmask
        elif kind == 1:
            m, cval = np.diag([a, b]), cmask & int(rng.integers(1 << n))
        else:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            m, cval = np.linalg.qr(z)[0], cmask & int(rng.integers(1 << n))
        m = np.asarray(m, dtype=np.complex128)
        ops.append(fu.FusedOp(fu.classify(m, cmask, cval), t, cmask, cval, m))
    return ops


def tq_check_cases(rng, n: int, tp: int, dev, fu) -> list:
    """(label, entry, args) of the n = 24 kernel-against-plain cases."""
    T = 1 << tp
    z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    m = np.linalg.qr(z)[0]
    mp = np.stack([m.real, m.imag]).astype(np.float32)

    def split(cmask, cval):
        return cmask >> tp, cval >> tp, cmask & (T - 1), cval & (T - 1)

    def dp_of(d0, d1):
        dp = np.zeros((2, 2, 2), np.float32)
        dp[0, 0, 0], dp[0, 0, 1] = np.real(d0), np.real(d1)
        dp[1, 0, 0], dp[1, 0, 1] = np.imag(d0), np.imag(d1)
        return dp

    d0, d1 = np.exp(1j * rng.uniform(0.0, 2 * np.pi, 2))
    # low control on bit 2 (value 0), high on n-11 (1) and n-1 (0)
    hm, hv, lm, lv = split((1 << 2) | (1 << (n - 11)) | (1 << (n - 1)),
                           1 << (n - 11))
    ops = tq_random_window(rng, n, tp, 24, fu)
    return [
        ("low_target", "gate_low", (mp, 3, 0, 0, 0, 0)),
        ("low_target_mixed_ctrl", "gate_low", (mp, tp - 1, hm, hv, lm, lv)),
        ("diag_low", "diag", (dp_of(d0, d1), 1 << 5, 0, 0, 0, 0, 0)),
        ("diag_high_mixed_ctrl", "diag",
         (dp_of(d0, d1), 0, 1 << (n - 4 - tp), lm, lv, hm, hv)),
        ("unit_diag_high", "diag", (dp_of(1.0, d1), 0, 1 << (n - 2 - tp),
                                    0, 0, 0, 0)),
        ("window", "window", (fu.sharded_structure_of(ops),
                              fu.sharded_operands(ops, tp, torch.float32,
                                                  dev))),
    ]


def tq_kernel_checks(card: str, dev) -> None:
    """Phase 5 (module docstring)."""
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.storage import turboquant as tq

    tp = tqk.DEFAULT_TILE_POW
    bp = tq.DEFAULT_BLOCK_POW
    n = CHECK_WIDTH
    rng = np.random.default_rng(2025)
    rot = torch.from_numpy(tq.rotation_matrix(2 << bp)).to(dev)
    rot_t = rot.T.contiguous()
    check_probe = TQProbe(tqk)
    psi = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    psi /= np.linalg.norm(psi)
    cases = tq_check_cases(rng, n, tp, dev, fu)
    for bits in (8, 16):
        scales, codes, _ = tq.quantize_blocks(psi, bits=bits, block_pow=bp)
        c0 = torch.from_numpy(codes).to(dev)
        s0 = torch.from_numpy(scales).to(dev)
        with check_probe:
            for label, entry, args in cases:
                check_probe.label = f"n{n}_int{bits}_{label}"
                c, s = c0.clone(), s0.clone()
                getattr(tqk, f"tq_{entry}")(c, s, rot, rot_t, bits, tp, *args)
        del c0, s0, c, s
    for key, s in check_probe.stats.items():
        if isinstance(key, tuple):
            emit({"phase": "tq_kernel_vs_plain", "card": card, "case": key[0],
                  "entry": key[1], "code_frac_bar": TQ_CODE_FRAC,
                  "scale_rel_bar": TQ_SCALE_REL, **s})
    unit = check_probe.stats[(f"n{n}_int8_unit_diag_high", "diag")]
    check(unit["dirty_tiles"] * 2 == unit["tiles"],
          f"unit diagonal above the tile requantized {unit['dirty_tiles']} "
          f"of {unit['tiles']} tiles")
    release()


def tq_phases(card: str, dev) -> list:
    """Phases 5-7 (module docstring); returns the kernels-line entries
    of K3-K5."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import turboquant_kernel as tqk

    tq_kernel_checks(card, dev)

    # ---- 6. the main path at w32 ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    tqk.reset_launches()
    q = qt.create_quantum_interface("turboquant", TQ_WIDTH)
    check(q.device == dev and q._codes.is_cuda,
          "the compressed ket did not land on the card")
    q.SetPermutation(TQ_PERM)
    qft_ms = timed(lambda: (q.QFT(0, TQ_WIDTH), q._codes))
    mass = float(q._chunk_masses().sum())
    check(abs(mass - 1.0) <= 1e-2, f"w{TQ_WIDTH} QFT: chunk masses sum to "
                                   f"{mass}")
    page = q.GetAmplitudePage(TQ_PERM & ~0xFFF, 4096)
    page_mean = float(np.mean(np.abs(page) ** 2) * 2.0 ** TQ_WIDTH)
    qft_launches = dict(tqk.LAUNCHES)
    iqft_ms = timed(lambda: (q.IQFT(0, TQ_WIDTH), q._codes))
    raw_back = q.ProbAll(TQ_PERM)
    # each requantization moves the norm a little; NormalizeState
    # rescales it from the chunk masses, without a decode
    q.NormalizeState()
    back = q.ProbAll(TQ_PERM)
    check(back >= 0.98, f"w{TQ_WIDTH} IQFT round trip: ProbAll {back} "
                        f"after NormalizeState ({raw_back} before)")
    iqft_launches = {k: v - qft_launches[k] for k, v in tqk.LAUNCHES.items()}
    q.H(0)
    p0 = q.Prob(0)
    check(abs(p0 - 0.5) <= 2e-2, f"H(0) then Prob(0) = {p0}")
    launches = dict(tqk.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"the w{TQ_WIDTH} path skipped a kernel entry point: {launches}")
    chunk_pair = 2 * q._chunk_amps
    check(q.peak_transient_amps <= chunk_pair,
          f"peak float32 transient {q.peak_transient_amps} amplitudes "
          f"exceeds a chunk pair ({chunk_pair})")
    emit({"phase": "tq_main_path", "card": card, "width": TQ_WIDTH,
          "bits": q._tq_bits, "block_pow": q._tq_block_pow,
          "tile_pow": q._pallas_tile_pow(), "chunk_qb": q._tq_chunk_pow,
          "resident_bytes": q.resident_bytes(),
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "peak_transient_amps": q.peak_transient_amps,
          "qft_chunk_mass": mass, "qft_page_mean_amp2_x_2^n": page_mean,
          "iqft_prob_back_raw": raw_back, "iqft_prob_back": back,
          "h0_prob0": p0,
          "launches_qft": qft_launches, "launches_iqft": iqft_launches,
          "launches_h0_read": {k: launches[k] - qft_launches[k]
                               - iqft_launches[k] for k in launches},
          "launches_total": launches})
    del q
    release()

    w = WIDTH
    d = qt.create_quantum_interface("cuda", w)
    d.SetPermutation(PERM)
    d.QFT(0, w)
    dense = d.device_planes
    del d
    t = qt.create_quantum_interface("turboquant", w)
    t.SetPermutation(PERM)
    t.QFT(0, w)
    f30 = fidelity(t.device_planes, dense)
    check(f30 >= 0.99, f"w{w} turboquant QFT against dense: fidelity {f30}")
    emit({"phase": "tq_vs_dense", "card": card, "width": w,
          "fidelity": f30})
    del t, dense
    release()

    # ---- 7. times ------------------------------------------------------
    q = qt.create_quantum_interface("turboquant", TQ_WIDTH)
    # context only: the two float32 products of one w32 sweep through
    # torch.matmul (cuBLAS), never called on the path
    D = q._block
    rows = torch.randn((1 << 20, 2 * D), device=dev)
    out = torch.empty_like(rows)
    n_groups = q._codes.shape[0] >> 20

    def products():
        for _ in range(n_groups):
            torch.matmul(rows, q._rot_t, out=out)
            torch.matmul(out, q._rot, out=rows)

    products()
    matmul_ms = timed(products)
    del rows, out
    probe = TQProbe(tqk)
    with probe:
        probe.label = "tq_qft"
        q.SetPermutation(TQ_PERM)
        q.QFT(0, TQ_WIDTH)
        q.Finish()
        probe.label = "tq_iqft"
        q.IQFT(0, TQ_WIDTH)
        q.Finish()
        probe.label = "tq_h0_read"
        q.ProbAll(TQ_PERM)
        q.NormalizeState()
        q.H(0)
        q.Prob(0)
    del q
    release()
    for key, s in probe.stats.items():
        if isinstance(key, tuple):
            emit({"phase": "tq_sweeps", "card": card, "path": key[0],
                  "entry": key[1], **s})
    for name in TQProbe.ENTRIES:
        got_n = probe.stats.get(name, {"launches": 0})["launches"]
        check(got_n == launches[name],
              f"probe saw {got_n} {name} launches, main path "
              f"{launches[name]}")

    def kernel_ms(label):
        return sum(s["ms"] for k, s in probe.stats.items()
                   if isinstance(k, tuple) and k[0] == label)

    k3 = probe.stats["gate_low"]
    emit({"phase": "tq_e2e", "card": card, "width": TQ_WIDTH,
          "qft_ms": qft_ms, "iqft_ms": iqft_ms,
          "qft_kernel_ms": kernel_ms("tq_qft"),
          "iqft_kernel_ms": kernel_ms("tq_iqft"),
          "qft_outside_kernels_ms": qft_ms - kernel_ms("tq_qft"),
          "iqft_outside_kernels_ms": iqft_ms - kernel_ms("tq_iqft"),
          "torch_matmul_pair_sweep_ms": matmul_ms,
          "k3_sweep_ms": k3["ms"] / k3["launches"],
          "k3_dirty_tiles_frac": k3["dirty_tiles"] / k3["tiles"]})

    kernels = []
    for name, k in zip(TQProbe.ENTRIES, ("K3", "K4", "K5")):
        s = probe.stats[name]
        kernels.append({
            "name": f"tq_{name}", "id": k, "route": "cuda",
            "source": TQ_SOURCE, "replaces": TQ_REPLACES[name],
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "code_max_diff": s["code_max_diff"],
            "code_diff_frac": s["code_diff_frac"],
            "scale_max_rel_err": s["scale_max_rel_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "held_launches": s["held_launches"], "held_ms": s["held_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
            else "operations",
            "f32_core_bound_ms": s["f32_core_bound_ms"],
            "library_ms": None})
    return kernels


def unit_planes(rng, n: int, dev):
    psi = rng.normal(size=(2, 1 << n)).astype(np.float32)
    psi /= np.float32(np.sqrt((psi.astype(np.float64) ** 2).sum()))
    return torch.from_numpy(psi).to(dev)


def dense_kernel_checks(card: str, dev) -> None:
    """Phase 2 (module docstring)."""
    from qrack_tpu_torch.models.qft import basis_planes, qft_qcircuit
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops import window_kernel as wk

    rng = np.random.default_rng(2024)
    n = CHECK_WIDTH
    worst = worst_rel = 0.0
    for w in range(4):
        ops = random_window(rng, n, 40, fu)
        structure = fu.structure_of(ops)
        operands = fu.dense_operands(ops)
        x = unit_planes(rng, n, dev)
        got = wk.make_window_fn(n, structure)(x.clone(), *operands)
        want = wk.make_window_fn(n, structure, plain=True)(x.clone(), *operands)
        sync()
        err, rel = held_to_plain(got, want, f"n={n} window {w}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    del x, got, want

    # pair-led segments through every route of the pair kernel
    bp = wk.DEFAULT_BLOCK_POW
    reached = set()
    low = high = mixed = 0
    for label, ops in pair_cases(rng, n, bp, fu, wk):
        structure = fu.structure_of(ops)
        check(wk.segment_launches(structure, bp) == [(0, 1, len(ops) - 1)],
              f"{label}: not one pair-led segment")
        routes = {}
        for op in ops:
            r = wk.pair_route(op.kind, op.target, bp)
            routes[r] = routes.get(r, 0) + 1
            low += (op.cmask & ((1 << bp) - 1)) != 0
            high += (op.cmask >> bp) != 0
            mixed += op.cval != op.cmask
        reached |= set(routes)
        operands = fu.dense_operands(ops)
        x = unit_planes(rng, n, dev)
        wk.reset_launches()
        got = wk.make_window_fn(n, structure)(x.clone(), *operands)
        sync()
        check(wk.launches() == {"in_tile": 0, "pair": 1},
              f"{label}: launches {wk.launches()}")
        want = wk.make_window_fn(n, structure, plain=True)(x.clone(), *operands)
        sync()
        err, rel = held_to_plain(got, want, f"n={n} pair case {label}")
        emit({"phase": "pair_kernel_vs_plain", "card": card, "case": label,
              "width": n, "block_pow": bp, "ops": len(ops), "routes": routes,
              "max_abs_err": err, "max_rel_err": rel})
    check(reached == set(wk.PAIR_ROUTES),
          f"pair cases reached the routes {sorted(reached)} only")
    check(low and high and mixed, "pair cases miss low, high or mixed "
                                  "controls")
    del x, got, want
    ops = fu.lower_gates(qft_qcircuit(WIDTH).gates)
    structure = fu.structure_of(ops)
    operands = fu.dense_operands(ops)
    x = basis_planes(WIDTH, PERM, device=dev)
    got = wk.make_window_fn(WIDTH, structure)(x, *operands)
    want = wk.make_window_fn(WIDTH, structure, plain=True)(
        basis_planes(WIDTH, PERM, device=dev), *operands)
    sync()
    f30 = fidelity(got, want)
    check(f30 >= 1 - 1e-5, f"w{WIDTH} QFT window: fidelity {f30}")
    err30, rel30 = held_to_plain(got, want, f"w{WIDTH} QFT window")
    emit({"phase": "kernel_vs_plain", "card": card,
          "abs_bar": ABS_BAR, "rel_bar": REL_BAR,
          f"n{CHECK_WIDTH}_windows": 4, f"n{CHECK_WIDTH}_max_abs_err": worst,
          f"n{CHECK_WIDTH}_max_rel_err": worst_rel,
          f"w{WIDTH}_qft_window_sweeps": wk.plan_sweeps(
              structure, wk.DEFAULT_BLOCK_POW, WIDTH),
          f"w{WIDTH}_fidelity": f30, f"w{WIDTH}_max_abs_err": err30,
          f"w{WIDTH}_max_rel_err": rel30})
    del x, got, want
    release()
    tile_kernel_checks(card, dev)


TILE_CHECK_WIDTHS = (CHECK_WIDTH, 1, 2, 3, 4, 5, 6)


def tile_kernel_checks(card: str, dev) -> None:
    """Phase 2's in-tile cases (module docstring): K1 in every plane
    dtype, every route its tile layout has, against its plain version."""
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops.gatekernels import dtype_name
    from qrack_tpu_torch.ops import window_kernel as wk

    for dt in (torch.float32,) + FPPOW_DTYPES:
        name = dtype_name(dt)
        rng = np.random.default_rng(2025)
        cases = {}
        for n in TILE_CHECK_WIDTHS:
            bp = min(wk.DEFAULT_BLOCK_POW, n)
            lay = wk.tile_layout(bp, dt)
            offered = {"diagonal"} | {r for r in ("register", "lane", "warp")
                                      if lay[r]}
            for label, ops in tile_cases(rng, n, bp, fu, wk, dt):
                structure = fu.structure_of(ops)
                check(wk.segment_launches(structure, bp)
                      == [(None, 0, len(ops))],
                      f"{name} n={n} {label}: not one in-tile segment")
                routes = {}
                for op in ops:
                    r = wk.tile_route(op.kind, op.target, bp, dt)
                    routes[r] = routes.get(r, 0) + 1
                # the routes case reaches every route the layout has
                # (all of them at n = 24)
                check(label != "routes" or set(routes) == offered,
                      f"{name} n={n} {label}: routes {sorted(routes)} of "
                      f"{sorted(offered)}")
                check(n != CHECK_WIDTH or offered == set(wk.TILE_ROUTES),
                      f"{name} n={n}: the layout lacks a route")
                operands = fu.dense_operands(ops, dt)
                x = unit_planes(rng, n, dev).to(dt)
                wk.reset_launches()
                got = wk.make_window_fn(n, structure)(x.clone(), *operands)
                sync()
                check(wk.launches() == {"in_tile": 1, "pair": 0},
                      f"{name} n={n} {label}: launches {wk.launches()}")
                want = wk.make_window_fn(n, structure, plain=True)(
                    x.clone(), *operands)
                sync()
                err, rel = held_to_plain(got, want,
                                         f"{name} n={n} in-tile {label}")
                cases[f"n{n}_{label}"] = {"block_pow": bp, "ops": len(ops),
                                          "routes": routes,
                                          "max_abs_err": err,
                                          "max_rel_err": rel}
        emit({"phase": "tile_kernel_vs_plain", "card": card, "dtype": name,
              "bar": plain_bar_text(dt), "cases": cases,
              "tile_layout": wk.tile_layout(wk.DEFAULT_BLOCK_POW, dt)})
    del x, got, want
    release()


def plain_bar_text(dtype) -> str:
    if dtype == torch.float64:
        return f"f64: {F64_REL_BAR} of the largest |amp|"
    if dtype in ULP_BITS:
        return f"{HALF_ULP_BAR} ulps of the dtype at the largest |amp|"
    return f"min({ABS_BAR}, {REL_BAR} * the largest |amp|)"


def dense_phases(card: str, dev, probe) -> dict:
    """Phases 2-4 (module docstring), timing phase 4's launches through
    `probe`; returns the main path's launch counts."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import window_kernel as wk

    dense_kernel_checks(card, dev)

    # ---- 3. the main path at w30 ---------------------------------------
    wk.reset_launches()
    q = qt.create_quantum_interface("cuda", WIDTH)
    check(q.device == dev, "the engine did not land on the card")
    q.SetPermutation(PERM)
    q.QFT(0, WIDTH)
    planes = q.device_planes
    p = planes[0] ** 2 + planes[1] ** 2
    amp_err = float((p * float(1 << WIDTH) - 1.0).abs().max())
    del p
    check(amp_err <= 1e-3, f"QFT |amp|^2 off 2^-{WIDTH} by {amp_err} rel.")
    qft_state = planes.clone()
    del planes
    q.IQFT(0, WIDTH)
    back = q.ProbAll(PERM)
    check(back >= 1 - 1e-3, f"IQFT round trip: ProbAll {back}")
    engine_launches = wk.launches()
    check(engine_launches["in_tile"] > 0 and engine_launches["pair"] > 0,
          f"engine path skipped a kernel entry point: {engine_launches}")
    del q
    release()

    r = qt.create_quantum_interface("cuda", WIDTH)
    r.SetPermutation(PERM)
    qft_qcircuit(WIDTH).RunFused(r)
    f_fused = fidelity(r.device_planes, qft_state)
    check(f_fused >= 1 - 1e-5, f"RunFused against engine QFT: {f_fused}")
    launches = wk.launches()
    # the QFT circuit opens with H on its top qubit, so every segment of
    # its single window is led by a cross-tile op: RunFused adds pair
    # sweeps only
    check(sum(launches.values()) > sum(engine_launches.values()),
          f"RunFused launched no kernel: {launches}")
    emit({"phase": "main_path", "card": card, "width": WIDTH,
          "qft_amp_max_rel_err": amp_err, "iqft_prob_back": back,
          "runfused_fidelity": f_fused,
          "launches_engine_qft_iqft": engine_launches,
          "launches_total": launches})
    del r, qft_state
    release()

    # ---- 4. times ------------------------------------------------------
    q = qt.create_quantum_interface("cuda", WIDTH)
    e2e = {"engine_qft_ms": [], "runfused_qft_ms": []}
    circ = qft_qcircuit(WIDTH)
    for _ in range(3):
        q.SetPermutation(PERM)
        e2e["engine_qft_ms"].append(timed(lambda: (q.QFT(0, WIDTH),
                                                   q.device_planes)))
        q.SetPermutation(PERM)
        e2e["runfused_qft_ms"].append(timed(lambda: circ.RunFused(q)))
    mode = os.environ.get("QRACK_TPU_FUSE_KERNEL")
    os.environ["QRACK_TPU_FUSE_KERNEL"] = "off"
    try:
        q.SetPermutation(PERM)
        chain_ms = timed(lambda: (q.QFT(0, WIDTH), q.device_planes))
    finally:
        os.environ.pop("QRACK_TPU_FUSE_KERNEL")
        if mode is not None:
            os.environ["QRACK_TPU_FUSE_KERNEL"] = mode
    emit({"phase": "e2e", "card": card, "width": WIDTH, **e2e,
          "engine_qft_chain_ms": chain_ms})
    PHASE4_WARM[:] = e2e["engine_qft_ms"][1:]

    probe.every, probe.seen = DENSE_PROBE_EVERY, {}
    with probe:
        probe.label = "engine_qft"
        q.SetPermutation(PERM)
        q.QFT(0, WIDTH)
        q.Finish()
        probe.label = "engine_iqft"
        q.IQFT(0, WIDTH)
        q.Finish()
        probe.label = "runfused_qft"
        q.SetPermutation(PERM)
        circ.RunFused(q)
        q.Finish()
    del q
    for key, s in probe.stats.items():
        if isinstance(key, tuple):
            emit({"phase": "sweeps", "card": card, "path": key[0],
                  "entry": key[1], **s})
    for name in launches:
        seen_n = probe.seen.get(name, 0)
        got_n = probe.stats[name]["launches"]
        check(seen_n == launches[name],
              f"probe saw {seen_n} {name} launches, main path "
              f"{launches[name]}")
        check(got_n >= seen_n // DENSE_PROBE_EVERY,
              f"probe held {got_n} of {seen_n} {name} launches")
    probe.every = 1
    release()
    return launches


def window_entries(probe, launches: dict) -> list:
    """The kernels-line entries of K1 and K2: launches over every dense
    path, times and errors over the launches `probe` held to plain."""
    kernels = []
    for name, k in (("in_tile", "K1"), ("pair", "K2")):
        s = probe.stats[name]
        kernels.append({
            "name": f"window_{name}", "id": k, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "probed_launches": s["launches"],
            "max_abs_err": s["max_abs_err"],
            "max_rel_err": s["max_rel_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
            else "operations",
            "library_ms": None, "copy_ms": s.get("copy_ms")})
    return kernels


# ---------------------------------------------------------------------------
# the ALU, the host oracle, QHybrid and the algorithm programs
# ---------------------------------------------------------------------------

def alu_sequence(table, perm) -> list:
    """(method, args) of every ALU op of the slice on a 22-qubit ket;
    `table` is 64 values below 2^8, `perm` a permutation of 2^10."""
    return [
        ("INC", (1234, 0, 12)),
        ("CINC", (77, 4, 9, (20, 21))),
        ("INCDECC", (300, 2, 9, 15)),
        ("INCS", (45, 3, 8, 19)),
        ("INCDECSC", (100, 5, 8, 18, 17)),
        ("INCBCD", (4721, 6, 16)),
        ("INCDECBCDC", (58, 0, 8, 21)),
        ("ROL", (5, 1, 14)),
        ("ROR", (2, 7, 11)),
        ("MUL", (5, 0, 8, 8)),
        ("DIV", (5, 0, 8, 8)),
        ("CMUL", (3, 2, 9, 7, (20,))),
        ("CDIV", (3, 2, 9, 7, (20,))),
        ("MULModNOut", (7, 221, 0, 10, 9)),
        ("IMULModNOut", (7, 221, 0, 10, 9)),
        ("CMULModNOut", (5, 29, 1, 12, 6, (21,))),
        ("CIMULModNOut", (5, 29, 1, 12, 6, (21,))),
        ("POWModNOut", (3, 1009, 0, 11, 11)),
        ("CPOWModNOut", (5, 61, 0, 8, 7, (21,))),
        ("IndexedLDA", (0, 6, 8, 8, table, False)),
        ("IndexedADC", (0, 6, 8, 8, 16, table)),
        ("IndexedSBC", (0, 6, 8, 8, 16, table)),
        ("Hash", (4, 10, perm)),
        ("PhaseFlipIfLess", (12345, 3, 16)),
        ("CPhaseFlipIfLess", (300, 2, 10, 19)),
    ]


def host_planes(state, dev):
    """A host complex vector as float64 planes on the card."""
    return torch.from_numpy(np.stack([state.real, state.imag])).to(dev)


def alu_vs_oracle(card: str, dev) -> dict:
    """Phase 8 (module docstring); returns the window kernel's launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = ALU_WIDTH
    rng = np.random.default_rng(2026)
    wk.reset_launches()
    q = qt.create_quantum_interface("cuda", n, rng=QrackRandom(5),
                                    rand_global_phase=False)
    o = qt.create_quantum_interface("cpu", n, rng=QrackRandom(5),
                                    rand_global_phase=False)
    check(q.device == dev, "the engine did not land on the card")

    def both(name, *args):
        return [getattr(e, name)(*args) for e in (q, o)]

    def pair():
        return (int(x) for x in rng.choice(n, 2, replace=False))

    for b in range(n):
        both("H", b)
    for _ in range(16):
        a, b = pair()
        both("T", a)
        both("CNOT", a, b)
    table = [int(v) for v in rng.integers(0, 256, 64)]
    perm = [int(v) for v in rng.permutation(1024)]
    fids, returns = {}, {}
    t0 = time.time()
    for name, args in alu_sequence(table, perm):
        a, b = pair()
        both("H", a)
        both("CNOT", a, b)
        out = both(name, *args)
        if out[0] is not None:
            returns[name] = out
        both("NormalizeState")
        f = fidelity(q.device_planes, host_planes(o.GetQuantumState(), dev))
        check(f >= 1 - 1e-5, f"n={n} {name}: fidelity {f} against the oracle")
        fids[name] = f
    launches = wk.launches()
    emit({"phase": "alu_vs_oracle", "card": card, "width": n,
          "ops": len(fids), "min_fidelity": min(fids.values()),
          "fidelity": fids, "indexed_returns_cuda_cpu": returns,
          "seconds": time.time() - t0, "launches": launches})
    del q, o
    release()
    return launches


def alu_round_trips(card: str, dev) -> dict:
    """Phase 9 (module docstring); returns the window kernel's launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = WIDTH
    rng = np.random.default_rng(2030)
    wk.reset_launches()
    q = qt.create_quantum_interface("cuda", n, rng=QrackRandom(6),
                                    rand_global_phase=False)
    free = [b for b in range(n) if not 8 <= b < 16]  # MUL carry [8, 16)
    for b in free:
        q.H(b)
    for _ in range(24):
        a, b = (int(x) for x in rng.choice(free, 2, replace=False))
        q.T(a)
        q.CNOT(a, b)
    hash_t = rng.permutation(1 << 12)
    hash_inv = np.argsort(hash_t)
    lda_t = [int(v) for v in rng.integers(0, 1 << 10, 256)]
    add = 123457 % (1 << (n - 10))
    trips = [
        ("INC", ("INC", (add, 0, n - 10)), ("INC", (-add, 0, n - 10))),
        ("ROL_ROR", ("ROL", (7, 2, n - 4)), ("ROR", (7, 2, n - 4))),
        ("MUL_DIV", ("MUL", (13, 0, 8, 8)), ("DIV", (13, 0, 8, 8))),
        ("CMUL_CDIV", ("CMUL", (11, 0, 8, 8, (n - 1,))),
         ("CDIV", (11, 0, 8, 8, (n - 1,)))),
        ("Hash", ("Hash", (n - 14, 12, [int(v) for v in hash_t])),
         ("Hash", (n - 14, 12, [int(v) for v in hash_inv]))),
        ("IndexedLDA", ("IndexedLDA", (0, 8, n - 10, 10, lda_t, False)),
         ("IndexedLDA", (0, 8, n - 10, 10, lda_t, False))),
    ]
    before = q.device_planes.clone()
    for label, first, second in trips:
        ops = []
        for m, args in (first, second):
            torch.cuda.reset_peak_memory_stats()
            ms = timed(lambda: (getattr(q, m)(*args), q.device_planes))
            ops.append({"op": m, "ms": ms,
                        "peak_allocated_bytes":
                            torch.cuda.max_memory_allocated()})
            if len(ops) == 1:
                check(not torch.equal(q.device_planes, before),
                      f"w{n} {label}: {m} left the planes as they were")
        check(torch.equal(q.device_planes, before),
              f"w{n} {label}: the round trip changed the planes")
        emit({"phase": "alu_w30", "card": card, "width": n, "pair": label,
              "bit_equal": True, "plane_bound_ms": PLANE_BOUND_MS,
              "ops": ops})
    launches = wk.launches()
    emit({"phase": "alu_w30_launches", "card": card, "launches": launches})
    del q, before
    release()
    return launches


def shor_phase(card: str, dev, probe) -> dict:
    """Phase 10 (module docstring); returns the window kernel's launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    w, mod_n, base = SHOR_WIDTH, SHOR_MOD, SHOR_BASE
    check(2 * w == WIDTH and pow(base, SHOR_ORDER, mod_n) == 1
          and pow(base, SHOR_ORDER // 2, mod_n) != 1,
          f"{base} does not have order {SHOR_ORDER} mod {mod_n}")
    t0 = time.time()
    host = al.order_finding_marginal(
        lambda m: qt.create_quantum_interface("cpu", m,
                                              rand_global_phase=False),
        base, mod_n, w)
    host_s = time.time() - t0

    def prepare(q):
        q.SetPermutation(0)
        for i in range(w):
            q.H(i)

    wk.reset_launches()
    q = qt.create_quantum_interface("cuda", WIDTH, rng=QrackRandom(12),
                                    rand_global_phase=False)
    prepare(q)
    pow_ms = timed(lambda: (q.POWModNOut(base, mod_n, 0, w, w),
                            q.device_planes))
    before_iqft = wk.launches()
    iqft_ms = timed(lambda: (q.IQFT(0, w), q.device_planes))
    iqft_launches = {k: v - before_iqft[k] for k, v in wk.launches().items()}
    check(iqft_launches["in_tile"] > 0 and iqft_launches["pair"] > 0,
          f"the IQFT skipped a kernel entry point: {iqft_launches}")
    planes = q.device_planes
    p = planes[0] ** 2 + planes[1] ** 2
    marg = torch.sum(p.view(1 << w, 1 << w), dim=0,
                     dtype=torch.float64).cpu().numpy()
    del p, planes
    err = float(np.abs(marg - host).max())
    total = float(marg.sum())
    check(err <= 1e-6, f"w{WIDTH} Shor marginal off the host's by {err}")
    check(abs(total - 1.0) <= 1e-4, f"w{WIDTH} Shor marginal sums to {total}")
    p_one = q.ProbReg(w, w, 1)
    check(abs(p_one - 1.0 / SHOR_ORDER) <= 1e-6,
          f"ProbReg(out = 1) = {p_one}, not 1/{SHOR_ORDER}")
    sync()
    t0 = time.time()
    factor = al.shor_order_find(q, base, mod_n, w)
    round_s = time.time() - t0
    launches = wk.launches()

    # every launch of the IQFT again, each beside its plain version
    prepare(q)
    q.POWModNOut(base, mod_n, 0, w, w)
    q.Finish()
    with probe:
        probe.label = "shor_iqft"
        q.IQFT(0, w)
        q.Finish()
    probed = {k: probe.stats.get(("shor_iqft", k), {"launches": 0})
              ["launches"] for k in iqft_launches}
    check(probed == iqft_launches,
          f"probe saw {probed} IQFT launches, main path {iqft_launches}")
    emit({"phase": "shor", "card": card, "width": WIDTH, "mod": mod_n,
          "base": base, "order": SHOR_ORDER, "register": w,
          "marginal_max_abs_err": err, "marginal_sum": total,
          "marginal_head": [float(v) for v in marg[:4]],
          "prob_out_1": p_one, "host_marginal_s": host_s,
          "powmodnout_ms": pow_ms, "iqft_ms": iqft_ms,
          "order_find_round_s": round_s, "order_find_factor": factor,
          "launches_iqft": iqft_launches, "launches": launches,
          "iqft_sweeps": {k: probe.stats[("shor_iqft", k)] for k in
                          iqft_launches if iqft_launches[k]}})
    del q
    release()
    return launches


def hybrid_rcs(card: str, dev) -> dict:
    """Phase 11 (module docstring); returns the window kernel's launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.engines.cpu import QEngineCPU
    from qrack_tpu_torch.engines.cuda import QEngineCUDA
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.models import rcs
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    a, b = HYBRID_START, HYBRID_START + HYBRID_GROW
    wk.reset_launches()
    h = qt.create_quantum_interface("hybrid", a, rng=QrackRandom(3),
                                    rand_global_phase=False)
    check(isinstance(h._engine, QEngineCPU), f"hybrid({a}) is not on the host")
    al.ghz(h)
    t0 = time.time()
    h.Compose(qt.create_quantum_interface("hybrid", HYBRID_GROW,
                                          rand_global_phase=False))
    sync()
    cross_s = time.time() - t0
    eng = h._engine
    check(isinstance(eng, QEngineCUDA) and eng.device == dev
          and h.qubit_count == b,
          f"hybrid at {b} qubits is a {type(eng).__name__}")
    h.Compose(qt.create_quantum_interface("cuda", WIDTH - b,
                                          rand_global_phase=False))
    check(h.qubit_count == WIDTH and h._engine is eng,
          f"Compose to w{WIDTH} left the CUDA engine")
    p0, p1 = h.ProbReg(0, a, 0), h.ProbReg(0, a, (1 << a) - 1)
    check(abs(p0 - 0.5) <= 1e-5 and abs(p1 - 0.5) <= 1e-5,
          f"GHZ marginals after the crossing: {p0}, {p1}")
    start = h.device_planes.clone()
    rcs_ms = timed(lambda: (al.random_circuit_sampling(
        h, RCS_DEPTH, QrackRandom(RCS_SEED)), h.device_planes))
    launches = wk.launches()
    check(launches["in_tile"] > 0 and launches["pair"] > 0,
          f"the hybrid RCS skipped a kernel entry point: {launches}")
    fn = rcs.make_rcs_fn(WIDTH, RCS_DEPTH, RCS_SEED)
    out = []
    fused_ms = timed(lambda: out.append(fn(start)))
    f = fidelity(h.device_planes, out[0])
    check(f >= 1 - 1e-5, f"w{WIDTH} hybrid RCS against make_rcs_fn: {f}")
    emit({"phase": "hybrid_rcs", "card": card, "width": WIDTH,
          "depth": RCS_DEPTH, "crossing_s": cross_s, "ghz_p0": p0,
          "ghz_p_all_ones": p1, "engine_rcs_ms": rcs_ms,
          "make_rcs_fn_ms": fused_ms, "fidelity": f, "launches": launches})
    del h, eng, start, out
    release()
    return launches


def grover_phase(card: str, dev) -> dict:
    """Phase 12 (module docstring); returns the window kernel's launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.models import grover
    from qrack_tpu_torch.models.qft import basis_planes
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = GROVER_ENGINE_WIDTH
    target = int(np.random.default_rng(n).integers(1, 1 << n))
    fn, iters = grover.make_grover_fn(n, target)
    out = []
    fused_ms = timed(lambda: out.append(fn(basis_planes(n, 0, device=dev))))
    p_fused = grover.success_probability(out[0], target)
    check(p_fused >= 0.99, f"w{n} make_grover_fn success {p_fused}")
    del out

    # grover_search is grover_amplify, then MAll: one engine run reads
    # the amplified ket between the two, then measures
    wk.reset_launches()
    q = qt.create_quantum_interface("cuda", n, rng=QrackRandom(8),
                                    rand_global_phase=False)
    t0 = time.time()
    al.grover_amplify(q, target)
    p_raw = q.ProbAll(target)
    amplify_s = time.time() - t0
    # every H's float32 1/sqrt(2) shrinks the norm by 3.4e-8: the ket's
    # direction is compared, so renormalize first
    q.UpdateRunningNorm()
    norm = q.GetRunningNorm()
    q.NormalizeState()
    p_engine = q.ProbAll(target)
    check(abs(p_engine - p_fused) <= 1e-4,
          f"w{n} engine ProbAll {p_engine} against make_grover_fn {p_fused}")
    got = q.MAll()
    check(got == target, f"w{n} Grover search found {got}, not {target}")
    launches = wk.launches()
    check(launches["in_tile"] > 0 and launches["pair"] > 0,
          f"the Grover path skipped a kernel entry point: {launches}")
    h = np.float32(1.0 / np.sqrt(2.0))
    n_h = n * (2 * iters + 1)
    emit({"phase": "grover", "card": card, "width": n, "target": target,
          "iterations": iters, "found": got, "grover_amplify_s": amplify_s,
          "make_grover_fn_ms": fused_ms, "success_fused": p_fused,
          "prob_target_raw": p_raw, "norm": norm,
          "norm_float32_h_prediction": float(2.0 * float(h) ** 2) ** n_h,
          "success_engine": p_engine, "launches": launches})
    del q
    release()
    return launches


# ---------------------------------------------------------------------------
# FPPOW planes, the drift escalation, the whole-circuit forms, uc_2x2
# ---------------------------------------------------------------------------

def amp2_rel_err(planes, n: int) -> float:
    """max | |amp|^2 * 2^n - 1 | in float64, a slice at a time."""
    step = 1 << 26
    most = 0.0
    for s0 in range(0, planes.shape[1], step):
        p = planes[:, s0:s0 + step].double()
        most = max(most, float(((p[0] ** 2 + p[1] ** 2) * float(1 << n)
                                - 1.0).abs().max()))
    return most


def dtype_launches(wk) -> dict:
    """The window kernel's launches by dtype form, read now."""
    return {k: dict(v) for k, v in wk.DTYPE_LAUNCHES.items()}


def fppow_kernel_checks(card: str, dev) -> None:
    """Phase 13 (module docstring)."""
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops.gatekernels import dtype_name
    from qrack_tpu_torch.ops import window_kernel as wk

    n, bp = CHECK_WIDTH, wk.DEFAULT_BLOCK_POW
    for dt in FPPOW_DTYPES:
        rng = np.random.default_rng(2024)
        worst = worst_rel = 0.0
        wk.reset_launches()
        for w in range(4):
            ops = random_window(rng, n, 40, fu)
            structure = fu.structure_of(ops)
            operands = fu.dense_operands(ops, dt)
            x = unit_planes(rng, n, dev).to(dt)
            got = wk.make_window_fn(n, structure)(x.clone(), *operands)
            want = wk.make_window_fn(n, structure, plain=True)(x.clone(),
                                                               *operands)
            sync()
            err, rel = held_to_plain(got, want, f"{dt} n={n} window {w}")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        windows = dict(wk.DTYPE_LAUNCHES[dtype_name(dt)])
        check(windows["in_tile"] > 0 and windows["pair"] > 0,
              f"{dt} random windows skipped an entry point: {windows}")
        reached = set()
        cases = {}
        for label, ops in pair_cases(rng, n, bp, fu, wk, dt):
            structure = fu.structure_of(ops)
            check(wk.segment_launches(structure, bp) == [(0, 1, len(ops) - 1)],
                  f"{dt} {label}: not one pair-led segment")
            reached |= {wk.pair_route(op.kind, op.target, bp, dt)
                        for op in ops}
            operands = fu.dense_operands(ops, dt)
            x = unit_planes(rng, n, dev).to(dt)
            wk.reset_launches()
            got = wk.make_window_fn(n, structure)(x.clone(), *operands)
            sync()
            check(wk.launches() == {"in_tile": 0, "pair": 1},
                  f"{dt} {label}: launches {wk.launches()}")
            want = wk.make_window_fn(n, structure, plain=True)(x.clone(),
                                                               *operands)
            sync()
            cases[label] = held_to_plain(got, want, f"{dt} pair case {label}")
        check(reached == set(wk.PAIR_ROUTES),
              f"{dt} pair cases reached the routes {sorted(reached)} only")
        emit({"phase": "fppow_kernel_vs_plain", "card": card,
              "dtype": dtype_name(dt), "width": n, "block_pow": bp,
              "bar": plain_bar_text(dt),
              "windows_max_abs_err": worst, "windows_max_rel_err": worst_rel,
              "windows_launches": windows,
              "pair_cases_max_abs_err": {k: v[0] for k, v in cases.items()},
              "pair_layout": wk.pair_layout(bp, dt)})
    del x, got, want
    release()


def fppow_phase(card: str, dev, probe) -> dict:
    """Phases 13-14 (module docstring); returns the launches by dtype."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops.gatekernels import dtype_name
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import window_kernel as wk

    fppow_kernel_checks(card, dev)
    launches = {}

    # float64: the engine path and RunFused
    wk.reset_launches()
    q = qt.create_quantum_interface("cuda", WIDTH, dtype=torch.float64)
    check(q.device_planes.dtype == torch.float64, "no float64 planes")
    q.SetPermutation(PERM)
    t0 = time.time()
    q.QFT(0, WIDTH)
    q.Finish()
    qft_s = time.time() - t0
    # the float64 ket waits on the host: beside a second float64 w30
    # engine and its gate temporaries it would not fit the card
    ref64 = q.device_planes.to("cpu", copy=True)
    amp_err = amp2_rel_err(q.device_planes, WIDTH)
    check(amp_err <= F64_QFT_BAR,
          f"float64 QFT |amp|^2 off 2^-{WIDTH} by {amp_err} rel.")
    q.IQFT(0, WIDTH)
    back = q.ProbAll(PERM)
    check(back >= 1 - F64_QFT_BAR, f"float64 IQFT round trip: {back}")
    engine = dict(wk.DTYPE_LAUNCHES["float64"])
    check(engine["in_tile"] > 0 and engine["pair"] > 0,
          f"the float64 engine path skipped an entry point: {engine}")
    del q
    release()
    r = qt.create_quantum_interface("cuda", WIDTH, dtype=torch.float64)
    r.SetPermutation(PERM)
    qft_qcircuit(WIDTH).RunFused(r)
    fused_err = amp2_rel_err(r.device_planes, WIDTH)
    check(fused_err <= F64_QFT_BAR,
          f"float64 RunFused |amp|^2 off 2^-{WIDTH} by {fused_err} rel.")
    f_fused = fidelity(r.device_planes, ref64)
    check(f_fused >= 1 - F64_QFT_BAR, f"float64 RunFused against the "
                                      f"engine QFT: {f_fused}")
    launches["float64"] = dict(wk.DTYPE_LAUNCHES["float64"])
    check(sum(launches["float64"].values()) > sum(engine.values()),
          "float64 RunFused launched no kernel")
    emit({"phase": "fppow_float64", "card": card, "width": WIDTH,
          "qft_amp2_max_rel_err": amp_err, "iqft_prob_back": back,
          "runfused_amp2_max_rel_err": fused_err,
          "runfused_fidelity": f_fused, "engine_qft_s": qft_s,
          "launches_engine_qft_iqft": engine,
          "launches_total": launches["float64"]})
    del r
    release()

    # 16-bit planes: the engine path against the float64 ket
    for dt in (torch.bfloat16, torch.float16):
        name = dtype_name(dt)
        wk.reset_launches()
        q = qt.create_quantum_interface("cuda", WIDTH, dtype=dt)
        q.SetPermutation(PERM)
        q.QFT(0, WIDTH)
        planes = q.device_planes
        check(planes.dtype == dt, f"no {name} planes")
        f = fidelity(planes, ref64)
        norm = float(sum(float((planes[:, s0:s0 + (1 << 26)].double() ** 2)
                               .sum()) for s0 in range(0, 1 << WIDTH,
                                                       1 << 26)))
        del planes
        q.IQFT(0, WIDTH)
        back = q.ProbAll(PERM)
        launches[name] = dict(wk.DTYPE_LAUNCHES[name])
        check(launches[name]["in_tile"] > 0 and launches[name]["pair"] > 0,
              f"the {name} engine path skipped an entry point: "
              f"{launches[name]}")
        emit({"phase": f"fppow_{name}", "card": card, "width": WIDTH,
              "qft_fidelity_vs_float64": f, "infidelity": 1 - f,
              "infidelity_bar": HALF_QFT_BAR[dt], "qft_norm": norm,
              "iqft_prob_back": back, "launches": launches[name]})
        check(1 - f <= HALF_QFT_BAR[dt],
              f"{name} w{WIDTH} QFT: infidelity {1 - f} against float64 "
              f"(bar {HALF_QFT_BAR[dt]})")
        del q
        release()
    del ref64
    release()

    # every fourth launch of each dtype's engine QFT, beside its plain
    # version (SweepProbe, with the dtype's bar)
    probe.every, probe.seen = FPPOW_PROBE_EVERY, {}
    for dt in FPPOW_DTYPES:
        name = dtype_name(dt)
        q = qt.create_quantum_interface("cuda", WIDTH, dtype=dt)
        q.SetPermutation(PERM)
        q.Finish()
        wk.reset_launches()
        with probe:
            probe.label = f"fppow_{name}_qft"
            q.QFT(0, WIDTH)
            q.Finish()
        for entry in ("in_tile", "pair"):
            got_n = probe.stats.get(f"{entry}_{name}",
                                    {"launches": 0})["launches"]
            want_n = wk.DTYPE_LAUNCHES[name][entry]
            held = -(-want_n // FPPOW_PROBE_EVERY)
            check(got_n == held, f"probe held {got_n} {name} {entry} "
                                 f"launches of the path's {want_n}")
        del q
        release()
    probe.every = 1
    for dt in FPPOW_DTYPES:
        name = dtype_name(dt)
        emit({"phase": "fppow_sweeps", "card": card, "dtype": name,
              **{e: probe.stats[f"{e}_{name}"] for e in ("in_tile", "pair")}})
    return launches


def drift_phase(card: str, dev) -> dict:
    """Phase 15 (module docstring); returns the launches by dtype."""
    import warnings

    from qrack_tpu_torch.ops.gatekernels import dtype_name
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.models import grover
    from qrack_tpu_torch.models.qft import basis_planes
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = GROVER_WIDTH
    target = int(np.random.default_rng(n).integers(1, 1 << n))
    fn, iters = grover.make_grover_fn(n, target, iters=DRIFT_ITERS)
    p_fused = grover.success_probability(fn(basis_planes(n, 0, device=dev)),
                                         target)
    env = {"QRACK_TPU_AUTO_F64_DRIFT": DRIFT_THRESH,
           "QRACK_TPU_DRIFT_CHECK_GATES": DRIFT_EVERY}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        q = qt.create_quantum_interface("cuda", n, rng=QrackRandom(8),
                                        rand_global_phase=False)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    check(q.dtype == torch.float32, "the drift phase starts on float32")
    wk.reset_launches()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        al.grover_amplify(q, target, iters=DRIFT_ITERS)
        p_raw = q.ProbAll(target)
    amplify_s = time.time() - t0
    launches = dtype_launches(wk)
    warned = [str(w.message) for w in seen if "escalating" in str(w.message)]
    check(q.dtype == torch.float64 and q.device_planes.dtype == torch.float64,
          f"w{n} Grover did not escalate: {q.dtype}")
    check(len(warned) == 1, f"{len(warned)} escalation warnings")
    check(abs(p_raw - p_fused) <= 1e-4,
          f"w{n} escalated ProbAll {p_raw} against make_grover_fn {p_fused}")
    for name in ("float32", "float64"):
        check(sum(launches[name].values()) > 0,
              f"the drift path launched no {name} kernel: {launches}")
    emit({"phase": "drift", "card": card, "width": n, "target": target,
          "iterations": iters, "threshold": DRIFT_THRESH,
          "check_gates": DRIFT_EVERY, "warning": warned[0],
          "dtype_after": dtype_name(q.dtype), "prob_target_raw": p_raw,
          "success_fused": p_fused, "grover_amplify_s": amplify_s,
          "launches": launches})
    del q
    release()
    return launches


def batch_circuit(n: int, k: int, seed: int):
    """A seeded circuit of k gates: H, RZ, general 2x2, CNOT, controlled
    phase, on any qubits."""
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit

    rng = np.random.default_rng(seed)
    c = QCircuit(n)
    for _ in range(k):
        kind = int(rng.integers(5))
        t = int(rng.integers(n))
        o = int(rng.choice([q for q in range(n) if q != t]))
        if kind == 0:
            c.append_1q(t, np.asarray(mat.H2))
        elif kind == 1:
            a = float(rng.uniform(0, 2 * np.pi))
            c.append_1q(t, np.diag([np.exp(-0.5j * a), np.exp(0.5j * a)]))
        elif kind == 2:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            c.append_1q(t, np.linalg.qr(z)[0])
        elif kind == 3:
            c.append_ctrl((o,), t, np.asarray(mat.X2), 1)
        else:
            c.append_ctrl((o,), t, np.diag([1.0, np.exp(1j * rng.uniform(
                0, 2 * np.pi))]), 1)
    return c


def circuit_forms_phase(card: str, dev) -> dict:
    """Phase 16 (module docstring); returns the launches by dtype."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models.qft import (basis_planes, make_qft_fn,
                                            qft_qcircuit)
    from qrack_tpu_torch.ops import window_kernel as wk

    circ = qft_qcircuit(WIDTH)
    q = qt.create_quantum_interface("cuda", WIDTH)
    q.SetPermutation(PERM)
    q.QFT(0, WIDTH)
    engine = q.device_planes.clone()
    del q
    r = qt.create_quantum_interface("cuda", WIDTH)
    r.SetPermutation(PERM)
    circ.RunFused(r)
    fused = r.device_planes
    del r
    release()

    fn = circ.compile_fn_pallas(WIDTH)
    x = basis_planes(WIDTH, PERM, device=dev)
    wk.reset_launches()
    pallas_ms = timed(lambda: fn(x))
    launches = dtype_launches(wk)
    check(sum(launches["float32"].values()) > 0,
          f"compile_fn_pallas launched no kernel: {launches}")
    f_pallas = fidelity(x, fused)
    check(f_pallas >= 1 - 1e-5, f"compile_fn_pallas against RunFused: "
                                f"{f_pallas}")
    del x, fused
    release()
    forms = {}
    for fast in (False, True):
        out = []
        ms = timed(lambda: out.append(make_qft_fn(WIDTH, fast=fast)(
            basis_planes(WIDTH, PERM, device=dev))))
        f = fidelity(out[0], engine)
        check(f >= 1 - 1e-5, f"make_qft_fn(fast={fast}) against the engine "
                             f"QFT: {f}")
        forms["fast" if fast else "unrolled"] = {"ms": ms, "fidelity": f}
        del out
        release()
    del engine
    release()

    n, B = BATCH_WIDTH, BATCH
    c = batch_circuit(n, BATCH_GATES, 28)
    g = torch.Generator(device=dev)
    g.manual_seed(28)
    stacked = torch.randn((B, 2, 1 << n), device=dev, generator=g)
    stacked /= stacked.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
    out = []
    batched_ms = timed(lambda: out.append(c.compile_batched_fn(n)(stacked)))
    alone_f, alone_err = [], []
    single = c.compile_fn(n)
    alone_ms = 0.0
    for b in range(B):
        one = []
        alone_ms += timed(lambda: one.append(single(stacked[b])))
        alone_f.append(fidelity(out[0][b], one[0]))
        alone_err.append(chunked_max(out[0][b], one[0]))
        del one
    check(min(alone_f) >= 1 - 1e-6 and max(alone_err) <= 1e-6,
          f"compile_batched_fn against each ket alone: {alone_f}, "
          f"{alone_err}")
    emit({"phase": "circuit_forms", "card": card, "width": WIDTH,
          "compile_fn_pallas_sweeps": fn.sweeps,
          "compile_fn_pallas_ms": pallas_ms,
          "compile_fn_pallas_fidelity_vs_runfused": f_pallas,
          "make_qft_fn": forms, "batched_width": n, "batch": B,
          "batched_gates": BATCH_GATES, "batched_ms": batched_ms,
          "alone_ms": alone_ms, "batched_fidelity_vs_alone": alone_f,
          "batched_max_abs_err_vs_alone": alone_err, "launches": launches})
    del out, stacked
    release()
    return launches


def uc_wide_phase(card: str, dev) -> dict:
    """Phase 17 (module docstring); returns the launches by dtype."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.layers.qcircuit import QCircuitGate
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops import gatekernels as gk
    from qrack_tpu_torch.ops import window_kernel as wk

    n, k = UC_WIDTH, UC_CONTROLS
    controls = tuple(2 * i + 1 for i in range(k))
    target = 2 * k + 1
    shape, _a, _r = gk._bit_view(n, list(controls) + [target])
    angles = np.random.default_rng(n).uniform(0, 2 * np.pi, 1 << k)
    ms = [np.array([[np.cos(a / 2), -np.sin(a / 2)],
                    [np.sin(a / 2), np.cos(a / 2)]], dtype=np.complex128)
          for a in angles]
    engines = []
    for _ in range(2):
        q = qt.create_quantum_interface("cuda", n, rand_global_phase=False)
        for b in range(0, n, 2):
            q.H(b)
        q.H(target)
        q.Finish()
        engines.append(q)
    wk.reset_launches()
    uc_ms = timed(lambda: (engines[0].UniformlyControlledRY(
        controls, target, angles), engines[0].device_planes))
    # the same payloads as single controlled gates, one per control
    # value, through the window kernel: one pair sweep each (the fuser
    # would merge 4096 consecutive MCMtrxPerm calls pairwise, quadratic
    # in host time, and the cost model sends a window that saves no
    # sweep to the plain gate functions)
    ops = fu.lower_gates([QCircuitGate(target, dict(enumerate(ms)),
                                       controls)])
    fn = wk.make_window_fn(n, fu.structure_of(ops))
    operands = fu.dense_operands(ops)
    gates_ms = timed(lambda: fn(engines[1].device_planes, *operands))
    launches = dtype_launches(wk)
    f = fidelity(engines[0].device_planes, engines[1].device_planes)
    check(f >= 1 - 1e-5, f"w{n} UniformlyControlledRY with {k} controls "
                         f"against single controlled gates: {f}")
    check(launches["float32"]["pair"] >= 1 << k,
          f"the controlled gates skipped the kernel: {launches}")
    emit({"phase": "uc_wide", "card": card, "width": n, "controls": k,
          "single_view_dims": len(shape), "uc_ms": uc_ms,
          "gate_by_gate_ms": gates_ms, "fidelity": f, "launches": launches})
    del engines
    release()
    return launches


# ---------------------------------------------------------------------------
# the layers above the terminals: QStabilizer, QStabilizerHybrid, QUnit,
# QUnitClifford and the OPTIMAL stack
# ---------------------------------------------------------------------------

class TableauCalls:
    """Counts the calls into the native tableau library: the stabilizer
    module reads the library through ``get_tableau_lib`` at every use,
    and this hands it a counting stand-in."""

    def __init__(self, lib):
        self.lib = lib
        self.calls = {}

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args)

        return call

    def total(self) -> int:
        return sum(self.calls.values())


def stack_native(card: str) -> TableauCalls:
    """Phase 18 (module docstring); returns the call counter, left in
    place for the later phases."""
    from qrack_tpu_torch import native
    from qrack_tpu_torch.layers import stabilizer as st
    from qrack_tpu_torch.utils.rng import QrackRandom

    t0 = time.time()
    lib = native.get_tableau_lib()
    load_s = time.time() - t0
    check(lib is not None, "the native tableau library did not build or "
                           "load: the stabilizer would run its Python loops")
    path = native.library_path(native.TABLEAU_SRC, "g++")
    check(path.exists(), f"no {path}")
    calls = TableauCalls(lib)
    st.get_tableau_lib = lambda: calls
    q = st.QStabilizer(64, rng=QrackRandom(18))
    q.H(0)
    for i in range(63):
        q.CNOT(i, i + 1)
    probs = [q.Prob(i) for i in range(64)]
    got = q.MAll()
    check(all(p == 0.5 for p in probs) and got in (0, (1 << 64) - 1),
          f"w64 GHZ on the tableau: probs {set(probs)}, MAll {got}")
    check(calls.total() > 0, "the tableau ran no native call")
    emit({"phase": "stack_native", "card": card,
          "build_s": native.BUILD_SECONDS.get("tableau.cpp", 0.0),
          "load_s": load_s, "library": os.path.relpath(path, ROOT),
          "native_calls": dict(calls.calls)})
    return calls


def reset_stagings() -> dict:
    """Reset and return the host-staging counters of QHybrid."""
    from qrack_tpu_torch.engines import hybrid

    for k in hybrid.HOST_STAGINGS:
        hybrid.HOST_STAGINGS[k] = 0
    return hybrid.HOST_STAGINGS


def amplitudes(q, idx) -> np.ndarray:
    return np.array([q.GetAmplitude(int(i)) for i in idx])


def qv_optimal(card: str, dev) -> dict:
    """Phase 19 (module docstring); returns the window kernel's launches
    of both runs."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = QV_WIDTH
    ops = list(al.quantum_volume_ops(n, QV_DEPTH, QrackRandom(QV_SEED)))
    stagings = reset_stagings()
    wk.reset_launches()
    q = qt.create_quantum_interface("optimal", n, rng=QrackRandom(QV_SEED),
                                    rand_global_phase=False)
    units, layer_s = [], []
    t0 = time.time()
    for i, (layer, name, args) in enumerate(ops):
        getattr(q, name)(*args)
        if i + 1 == len(ops) or ops[i + 1][0] != layer:
            units.append((q.GetUnitCount(), q.GetMaxUnitSize()))
            layer_s.append(time.time() - t0)
    q.Finish()
    sync()
    opt_s = time.time() - t0
    t0 = time.time()
    p_opt = [q.Prob(b) for b in range(n)]
    opt_prob_s = time.time() - t0
    opt = {"launches": wk.launches(), "stagings": dict(stagings),
           "composes": q.compose_count, "swaps": q.swap_count,
           "dispatches": q.dispatch_count}
    check(opt["launches"]["in_tile"] + opt["launches"]["pair"] > 0,
          f"the OPTIMAL QV launched no K1/K2: {opt['launches']}")
    check(q.GetMaxUnitSize() == n, f"QV w{n} left units {units[-1]}")

    wk.reset_launches()
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(QV_SEED),
                                    rand_global_phase=False)
    t0 = time.time()
    for _layer, name, args in ops:
        getattr(c, name)(*args)
    c.Finish()
    sync()
    bare_s = time.time() - t0
    p_bare = [c.Prob(b) for b in range(n)]
    bare_launches = wk.launches()
    check(bare_launches["in_tile"] + bare_launches["pair"] > 0,
          f"the bare QV launched no K1/K2: {bare_launches}")
    dp = max(abs(a - b) for a, b in zip(p_opt, p_bare))
    check(dp <= 1e-4, f"QV w{n}: Prob differs by {dp} (bar 1e-4)")
    idx = np.random.default_rng(QV_SEED).integers(0, 1 << n, QV_AMPS)
    t0 = time.time()
    a = amplitudes(q, idx)
    amp_s = time.time() - t0
    b = amplitudes(c, idx)
    overlap = abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)
    check(overlap >= 1 - 1e-4, f"QV w{n}: amplitude overlap {overlap}")
    t0 = time.time()
    got = q.MAll()
    mall_s = time.time() - t0
    check(0 <= got < 1 << n and all(
        q.Prob(i) == float((got >> i) & 1) for i in range(n)),
        f"QV w{n}: MAll {got} does not match the collapsed Probs")
    emit({"phase": "qv_optimal", "card": card, "width": n, "depth": QV_DEPTH,
          "gates": len(ops), "optimal_s": opt_s, "cuda_s": bare_s,
          "optimal_prob_s": opt_prob_s, "get_amplitude_us":
          amp_s / QV_AMPS * 1e6, "mall_s": mall_s,
          "units_per_layer": units, "host_s_after_layer": layer_s,
          "optimal": opt,
          "cuda_launches": bare_launches, "max_prob_diff": dp,
          "amplitude_overlap": overlap, "mall": got})
    del q, c
    release()
    return {"optimal": opt["launches"], "cuda": bare_launches}


def qft_closed_form(x: int, k: int, n: int) -> complex:
    """Amplitude k of QFT(0, n) on |x>: this package's QFT has no final
    bit reversal, so 2^(-n/2) exp(2 pi i x rev(k) / 2^n)."""
    krev = int(f"{k:0{n}b}"[::-1], 2)
    return 2.0 ** (-n / 2) * np.exp(2j * np.pi * ((x * krev) % (1 << n))
                                    / 2.0 ** n)


def qft_optimal(card: str, dev) -> dict:
    """Phase 20 (module docstring); returns the launches of the bare
    engine's w30 QFT."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = QFT_WIDE
    rng = np.random.default_rng(n)
    x = int(rng.integers(0, 1 << n))
    q = qt.create_quantum_interface("optimal", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    t0 = time.time()
    q.SetPermutation(x)
    q.QFT(0, n)
    wide_s = time.time() - t0
    check(q.GetMaxUnitSize() == 1 and q.dispatch_count == 0,
          f"w{n} QFT built a unit of {q.GetMaxUnitSize()}")
    dp = max(abs(q.Prob(b) - 0.5) for b in range(n))
    check(dp <= 1e-12, f"w{n} QFT: Prob off 0.5 by {dp}")
    idx = rng.integers(0, 1 << n, QFT_WIDE_AMPS)
    err = max(abs(q.GetAmplitude(int(k)) - qft_closed_form(x, int(k), n))
              for k in idx)
    check(err <= 1e-9 * 2.0 ** (-n / 2),
          f"w{n} QFT: amplitude off the closed form by {err}")

    n = WIDTH
    perm = PERM & ((1 << n) - 1)
    o = qt.create_quantum_interface("optimal", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    t0 = time.time()
    o.SetPermutation(perm)
    o.QFT(0, n)
    opt_s = time.time() - t0
    wk.reset_launches()
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    c.SetPermutation(perm)
    sync()
    t0 = time.time()
    c.QFT(0, n)
    c.Finish()
    sync()
    cuda_s = time.time() - t0
    launches = wk.launches()
    check(launches["in_tile"] + launches["pair"] > 0,
          f"the w{n} engine QFT launched no K1/K2: {launches}")
    idx = np.random.default_rng(n).integers(0, 1 << n, QV_AMPS)
    a, b = amplitudes(o, idx), amplitudes(c, idx)
    d30 = float(np.abs(a - b).max())
    check(o.GetMaxUnitSize() == 1 and d30 <= 1e-3 * 2.0 ** (-n / 2),
          f"w{n} QFT: OPTIMAL against the engine by {d30}")
    emit({"phase": "qft_optimal", "card": card, "wide_width": QFT_WIDE,
          "wide_qft_s": wide_s, "wide_max_prob_diff": dp,
          "wide_max_amp_err": err, "width": n, "optimal_qft_s": opt_s,
          "cuda_qft_s": cuda_s, "max_amp_diff": d30, "cuda_launches": launches})
    del o, c
    release()
    return launches


def clifford_wide(card: str, dev) -> None:
    """Phase 21 (module docstring)."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = GHZ_OPTIMAL
    stagings = reset_stagings()
    q = qt.create_quantum_interface("optimal", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    t0 = time.time()
    al.ghz(q)
    q.T(0)
    # push QUnit's buffered T into the unit (a read would do the same,
    # but every amplitude read of a sharded tableau builds the ket)
    q._flush_all()
    unit = q.shards[0].unit
    check(q.GetMaxUnitSize() == n and unit.on_tableau()
          and (unit.shards[0] is not None or unit._anc > 0),
          f"w{n} GHZ + T left the tableau: units {q.GetMaxUnitSize()}, "
          f"on_tableau {unit.on_tableau()}, ancillae {unit._anc}")
    dp = max(abs(q.Prob(b) - 0.5) for b in range(n))
    got = q.MAll()
    opt_s = time.time() - t0
    check(dp <= 1e-9 and got in (0, (1 << n) - 1) and unit.on_tableau()
          and stagings["switch"] == 0,
          f"w{n} GHZ + T: Prob off 0.5 by {dp}, MAll {got}")

    m = GHZ_CLIFFORD
    u = qt.create_quantum_interface("unit_clifford", m, rng=QrackRandom(m),
                                    rand_global_phase=False)
    t0 = time.time()
    al.ghz(u)
    du = max(abs(u.Prob(b) - 0.5) for b in range(m))
    got_u = u.MAll()
    uc_s = time.time() - t0
    check(du <= 1e-9 and got_u in (0, (1 << m) - 1),
          f"w{m} unit_clifford GHZ: Prob off 0.5 by {du}, MAll {got_u}")
    emit({"phase": "clifford_wide", "card": card, "optimal_width": n,
          "optimal_s": opt_s, "optimal_t_on": "shard" if unit._anc == 0
          else "ancilla", "optimal_mall": got, "unit_clifford_width": m,
          "unit_clifford_s": uc_s, "unit_clifford_mall": got_u})


def switch_circuit(n: int, depth: int, seed: int) -> list:
    """A seeded Clifford circuit (H, S, CNOT, CZ) as (name, args)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(depth):
        kind = int(rng.integers(4))
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        out.append([("H", (a,)), ("S", (a,)), ("CNOT", (a, b)),
                    ("CZ", (a, b))][kind])
    return out


def stab_switch(card: str, dev, n: int = None) -> dict:
    """Phase 22 (module docstring); returns the window kernel's launches
    of the switched stack."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.engines.cuda import QEngineCUDA
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = SWITCH_WIDTH if n is None else n
    ops = switch_circuit(n, SWITCH_DEPTH, n) + [("RX", (0.3, 0)),
                                                 ("CNOT", (0, 1))]
    wk.reset_launches()
    q = qt.create_quantum_interface(["stabilizer_hybrid", "hybrid"], n,
                                    rng=QrackRandom(n), rand_global_phase=False)
    switched = []
    real_switch = q.SwitchToEngine

    def timed_switch():
        t0 = time.time()
        real_switch()
        sync()
        switched.append(time.time() - t0)

    q.SwitchToEngine = timed_switch
    t0 = time.time()
    for name, args in ops:
        getattr(q, name)(*args)
    q.Finish()
    sync()
    wall_s = time.time() - t0
    launches = wk.launches()
    check(len(switched) == 1 and not q.on_tableau()
          and isinstance(q.engine._engine, QEngineCUDA),
          f"w{n}: the switch ran {len(switched)} times into "
          f"{type(getattr(q.engine, '_engine', q.engine)).__name__}")
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    for name, args in ops:
        getattr(c, name)(*args)
    a, b = q.GetQuantumState(), c.GetQuantumState()
    f = abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a).real * np.vdot(b, b).real)
    check(f >= 1 - 1e-5, f"w{n} switched ket against the engine: {f}")
    emit({"phase": "stab_switch", "card": card, "width": n,
          "clifford_gates": SWITCH_DEPTH, "wall_s": wall_s,
          "switch_s": switched[0],
          "switch_us_per_amp": switched[0] / (1 << n) * 1e6,
          "fidelity": f, "launches": launches})
    del q, c
    release()
    return launches


# ---------------------------------------------------------------------------
# the decision-tree layers, the tensor network and the noise plane
# ---------------------------------------------------------------------------

def random_layers(qubits, depth: int, seed: int) -> list:
    """Seeded layers over `qubits` as (layer, name, args): U3 with random
    angles on each qubit, then CNOT on alternating neighbour pairs."""
    rng = np.random.default_rng(seed)
    qubits = list(qubits)
    out = []
    for layer in range(depth):
        for q in qubits:
            th = [float(v) for v in rng.uniform(-np.pi, np.pi, 3)]
            out.append((layer, "U", (q, *th)))
        for i in range(layer % 2, len(qubits) - 1, 2):
            out.append((layer, "CNOT", (qubits[i], qubits[i + 1])))
    return out


def brickwork(n: int, depth: int, seed: int) -> list:
    """A seeded brickwork of non-Clifford 2-qubit bricks as (name, args):
    U3 and RY, a CNOT and a controlled phase of a random angle on each
    neighbour pair of the layer."""
    rng = np.random.default_rng(seed)
    out = []
    for layer in range(depth):
        for a in range(layer % 2, n - 1, 2):
            th = [float(v) for v in rng.uniform(-np.pi, np.pi, 4)]
            out += [("U", (a, th[0], th[1], th[2])), ("RY", (th[3], a + 1)),
                    ("CNOT", (a, a + 1)),
                    ("MCPhase", ((a,), 1.0, np.exp(1j * th[1]), a + 1))]
    return out


def ket_fidelity(a, b) -> float:
    """|<a|b>|^2 / (<a|a><b|b>) of two host kets."""
    return float(abs(np.vdot(a, b)) ** 2
                 / (np.vdot(a, a).real * np.vdot(b, b).real))


def tree_leaves(bdt) -> list:
    """The distinct dense leaves of a QBdt."""
    from qrack_tpu_torch.layers.qbdt import _EngLeaf

    out, seen, todo = [], set(), [bdt.root]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, _EngLeaf):
            out.append(node)
        elif isinstance(node, tuple) and len(node) == 4:
            todo += [node[1], node[3]]
    return out


def bdt_wide(card: str, dev) -> None:
    """Phase 23 (module docstring)."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import algorithms as al
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = BDT_QFT_WIDTH
    rng = np.random.default_rng(n)
    x = int(rng.integers(0, 1 << n))
    q = qt.create_quantum_interface(["bdt_hybrid", "hybrid"], n,
                                    rng=QrackRandom(n),
                                    rand_global_phase=False)
    check(q.bdt.device.type == dev.type,
          f"the tree's device is {q.bdt.device}")
    t0 = time.time()
    q.SetPermutation(x)
    q.QFT(0, n)
    qft_s = time.time() - t0
    check(q.isBinaryDecisionTree(), f"w{n} QFT left the tree")
    nodes = q.bdt.node_count()
    check(nodes <= 2 * n, f"w{n} QFT: {nodes} nodes (bar {2 * n})")
    idx = rng.integers(0, 1 << n, BDT_AMPS)
    t0 = time.time()
    err = max(abs(q.GetAmplitude(int(k)) - qft_closed_form(x, int(k), n))
              for k in idx)
    amp_s = time.time() - t0
    check(err <= 1e-9 * 2.0 ** (-n / 2),
          f"w{n} QFT: amplitude off the closed form by {err}")

    m = BDT_GHZ
    g = qt.create_quantum_interface(["bdt_hybrid", "hybrid"], m,
                                    rng=QrackRandom(m),
                                    rand_global_phase=False)
    t0 = time.time()
    al.ghz(g)
    g.T(0)
    dp = max(abs(g.Prob(b) - 0.5) for b in range(m))
    ghz_s = time.time() - t0
    check(g.isBinaryDecisionTree() and dp <= 1e-12,
          f"w{m} GHZ + T on the tree: Prob off 0.5 by {dp}")
    emit({"phase": "bdt_wide", "card": card, "qft_width": n, "qft_s": qft_s,
          "qft_nodes": nodes, "amps": BDT_AMPS, "amp_read_us":
          amp_s / BDT_AMPS * 1e6, "max_amp_err": err, "ghz_width": m,
          "ghz_s": ghz_s, "ghz_nodes": g.bdt.node_count(),
          "ghz_max_prob_diff": dp})


def bdt_attached(card: str, dev) -> dict:
    """Phase 24 (module docstring); returns the launches of the bare
    engine."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, k = BDT_ATT_WIDTH, BDT_ATT_QB
    tq = n - k
    q = qt.create_quantum_interface("bdt_attached", n, attached_qubits=k,
                                    rng=QrackRandom(n),
                                    rand_global_phase=False)
    check(q._leaf_on_device() and q.tree_qubits == tq,
          f"w{n}: {k} attached qubits keep no device leaves")
    ops = random_layers(range(tq, n), BDT_ATT_DEPTH, n)
    t0 = time.time()
    for _layer, name, args in ops:
        getattr(q, name)(*args)
    for t in range(tq):
        q.H(t)
        q.T(t)
    sync()
    wall_s = time.time() - t0
    leaves = tree_leaves(q)
    check(leaves and all(lf.on_device and lf.planes.device.type == dev.type
                         and lf.planes.dtype == torch.float32
                         and lf.planes.shape == (2, 1 << k)
                         for lf in leaves),
          f"w{n}: a leaf is not float32 (2, 2^{k}) planes on the card")
    t0 = time.time()
    probs = [q.Prob(b) for b in range(n)]
    prob_s = time.time() - t0
    wk.reset_launches()
    c = qt.create_quantum_interface("cuda", k, rng=QrackRandom(k),
                                    rand_global_phase=False)
    for _layer, name, args in random_layers(range(k), BDT_ATT_DEPTH, n):
        getattr(c, name)(*args)
    want = [c.Prob(b) for b in range(k)]
    launches = wk.launches()
    d_att = max(abs(probs[tq + b] - want[b]) for b in range(k))
    d_tree = max(abs(probs[t] - 0.5) for t in range(tq))
    check(d_att <= 1e-5 and d_tree <= 1e-5,
          f"w{n} attached: Prob off the bare w{k} engine by {d_att}, the "
          f"tree qubits off 0.5 by {d_tree}")
    emit({"phase": "bdt_attached", "card": card, "width": n,
          "attached": k, "leaf_gates": len(ops), "wall_s": wall_s,
          "prob_s": prob_s, "nodes": q.node_count(), "leaves": len(leaves),
          "leaf_bytes": sum(lf.planes.numel() * 4 for lf in leaves),
          "max_prob_diff_attached": d_att, "max_prob_diff_tree": d_tree,
          "cuda_launches": launches})
    del q, c
    release()
    return launches


def bdt_switch(card: str, dev) -> dict:
    """Phase 25 (module docstring); returns the window kernel's launches
    of the switched stack."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.engines.cuda import QEngineCUDA
    from qrack_tpu_torch.layers.qbdt import QBdt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = BDT_SWITCH_WIDTH
    rng = np.random.default_rng(n)
    q = qt.create_quantum_interface(["bdt_hybrid", "hybrid"], n,
                                    rng=QrackRandom(n),
                                    rand_global_phase=False,
                                    ratio_threshold=BDT_SWITCH_RATIO)
    switches, walks = [], []
    real_maybe, real_walk = q._maybe_switch, QBdt.GetQuantumState

    def timed_walk(self):
        t0 = time.time()
        out = real_walk(self)
        walks.append(time.time() - t0)
        return out

    def timed_maybe():
        tree = q.bdt
        t0 = time.time()
        real_maybe()
        if tree is not None and q.engine is not None:
            sync()
            switches.append((time.time() - t0, tree.node_count(),
                             tree.attached_qubits))

    q._maybe_switch = timed_maybe
    QBdt.GetQuantumState = timed_walk
    wk.reset_launches()
    done = []
    t0 = time.time()
    try:
        for a in range(n):
            q.H(a)
            done.append(("H", (a,)))
        # random phases of random angles, the control above the target
        # in the tree (the tree's cheap order; a phase is symmetric)
        while q.isBinaryDecisionTree() and len(done) < 40 * n:
            a, b = sorted(int(v) for v in rng.choice(n, 2, replace=False))
            call = ("MCPhase", ((a,), 1.0,
                                np.exp(1j * rng.uniform(-np.pi, np.pi)), b))
            getattr(q, call[0])(*call[1])
            done.append(call)
        tree_s = time.time() - t0
        check(len(switches) == 1, f"w{n}: the tree switched "
                                  f"{len(switches)} times before the layers")
        for _layer, name, args in random_layers(range(n), BDT_SWITCH_AFTER,
                                                n + 1):
            getattr(q, name)(*args)
            done.append((name, args))
        q.Finish()
        sync()
    finally:
        QBdt.GetQuantumState = real_walk
    wall_s = time.time() - t0
    launches = wk.launches()
    check(len(switches) == 1 and isinstance(q.engine._engine, QEngineCUDA)
          and q.engine._engine.device.type == dev.type,
          f"w{n}: {len(switches)} switches, into "
          f"{type(getattr(q.engine, '_engine', q.engine)).__name__}")
    check(launches["in_tile"] + launches["pair"] > 0,
          f"the switched w{n} stack launched no K1/K2: {launches}")
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    for name, args in done:
        getattr(c, name)(*args)
    f = ket_fidelity(q.GetQuantumState(), c.GetQuantumState())
    check(f >= 1 - 1e-5, f"w{n} switched ket against the engine: {f}")
    switch_s, nodes, attached = switches[0]
    emit({"phase": "bdt_switch", "card": card, "width": n,
          "ratio": BDT_SWITCH_RATIO, "gates": len(done),
          "gates_on_tree": len(done) - len(random_layers(
              range(n), BDT_SWITCH_AFTER, n + 1)),
          "tree_s": tree_s, "wall_s": wall_s, "switch_s": switch_s,
          "switch_us_per_amp": switch_s / (1 << n) * 1e6,
          "walk_s": walks, "walk_us_per_amp": [w / (1 << n) * 1e6
                                               for w in walks],
          "nodes_at_switch": nodes, "attached_at_switch": attached,
          "fidelity": f, "launches": launches})
    del q, c
    release()
    return launches


def tn_cone(card: str, dev) -> dict:
    """Phase 26 (module docstring); returns the launches of the stack's
    cone reads and of the bare engine."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    layers = ["tensor_network", "unit", "stabilizer_hybrid", "hybrid"]
    n = TN_WIDTH
    ops = brickwork(n, TN_DEPTH, n)
    q = qt.create_quantum_interface(layers, n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    for name, args in ops:
        getattr(q, name)(*args)
    probes = sorted(int(b) for b in np.random.default_rng(n).choice(
        n, TN_PROBES, replace=False))
    wk.reset_launches()
    t0 = time.time()
    got = [q.Prob(b) for b in probes]
    sync()
    tn_s = time.time() - t0
    tn_launches = wk.launches()
    check(q.isBuffering() and q.sim is None,
          f"w{n}: the cone reads materialized the stack")
    wk.reset_launches()
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    t0 = time.time()
    for name, args in ops:
        getattr(c, name)(*args)
    want = [c.Prob(b) for b in probes]
    sync()
    cuda_s = time.time() - t0
    cuda_launches = wk.launches()
    dp = max(abs(a - b) for a, b in zip(got, want))
    check(dp <= 1e-5, f"w{n} cones: Prob off the bare engine by {dp}")
    check(tn_launches["in_tile"] + tn_launches["pair"] > 0,
          f"the w{n} cone reads launched no K1/K2: {tn_launches}")
    del c
    release()

    m, b = TN_WIDE, TN_WIDE_PROBE
    wide_ops = brickwork(m, TN_DEPTH, m)
    w = qt.create_quantum_interface(layers, m, rng=QrackRandom(m),
                                    rand_global_phase=False)
    for name, args in wide_ops:
        getattr(w, name)(*args)
    cone = w.circuit.PastLightCone([b])
    cone_q = sorted({x for g in cone.gates for x in g.qubits()})
    wk.reset_launches()
    t0 = time.time()
    p = w.Prob(b)
    sync()
    wide_s = time.time() - t0
    wide_launches = wk.launches()
    check(wide_launches["in_tile"] + wide_launches["pair"] > 0,
          f"the w{m} cone read launched no K1/K2: {wide_launches}")
    # the cone alone on a bare engine of its width (its qubits are one
    # contiguous run of the brickwork)
    lo = cone_q[0]
    check(cone_q == list(range(lo, lo + len(cone_q))),
          f"w{m}: the cone of {b} is not contiguous: {cone_q}")
    e = qt.create_quantum_interface("cuda", len(cone_q), rng=QrackRandom(m),
                                    rand_global_phase=False)
    for g in cone.gates:
        for perm, mtx in g.payloads.items():
            e.MCMtrxPerm(tuple(x - lo for x in g.controls), mtx,
                         g.target - lo, perm)
    pe = e.Prob(b - lo)
    check(abs(p - pe) <= 1e-5, f"w{m} cone: Prob({b}) {p} against the "
                               f"w{len(cone_q)} engine's {pe}")
    emit({"phase": "tn_cone", "card": card, "width": n, "depth": TN_DEPTH,
          "gates": len(ops), "probes": probes, "cone_reads_s": tn_s,
          "cuda_s": cuda_s, "max_prob_diff": dp, "cone_launches":
          tn_launches, "cuda_launches": cuda_launches,
          "wide_width": m, "wide_probe": b, "cone_width": len(cone_q),
          "gates_kept": cone.GetGateCount(),
          "gates_buffered": w.circuit.GetGateCount(), "wide_read_s": wide_s,
          "wide_launches": wide_launches, "wide_prob": p,
          "wide_prob_diff": abs(p - pe)})
    del q, w, e
    release()
    return {"cones": {k: tn_launches[k] + wide_launches[k]
                      for k in tn_launches}, "cuda": cuda_launches}


def noisy_stack(card: str, dev) -> dict:
    """Phase 27 (module docstring); returns the launches of the noisy
    stacks and of the bare engine."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    layers = ["noisy", "unit", "stabilizer_hybrid", "hybrid"]
    n = NOISY_WIDTH
    ops = [(name, args) for _l, name, args in
           random_layers(range(n), NOISY_DEPTH, n)]
    wk.reset_launches()
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    for name, args in ops:
        getattr(c, name)(*args)
    ideal = c.GetQuantumState()
    cuda_launches = wk.launches()
    del c
    release()

    wk.reset_launches()
    q0 = qt.create_quantum_interface(layers, n, noise=0.0,
                                     rng=QrackRandom(n),
                                     rand_global_phase=False)
    t0 = time.time()
    for name, args in ops:
        getattr(q0, name)(*args)
    q0.Finish()
    sync()
    clean_s = time.time() - t0
    f0 = ket_fidelity(q0.GetQuantumState(), ideal)
    check(f0 >= 1 - 1e-5 and q0.GetUnitaryFidelity() == 1.0,
          f"w{n} noisy stack at lambda 0 against the engine: {f0}")
    del q0
    release()

    q = qt.create_quantum_interface(layers, n, noise=NOISY_LAMBDA,
                                    rng=QrackRandom(n),
                                    rand_global_phase=False)
    pairs, paulis = [0], {"X": 0, "Y": 0, "Z": 0}
    in_noise = [False]

    def funnel(name):
        real = getattr(q, name)

        def call(*args):
            qubits = {"MCMtrxPerm": lambda c, m, t, p: (t,) + tuple(c),
                      "Apply4x4": lambda m, a, b: (a, b),
                      "Swap": lambda a, b: (a, b)}[name](*args)
            pairs[0] += len(set(qubits))
            return real(*args)

        setattr(q, name, call)

    for name in ("MCMtrxPerm", "Apply4x4", "Swap"):
        funnel(name)
    real_noise = q._apply_noise

    def counted_noise(qubits):
        in_noise[0] = True
        try:
            real_noise(qubits)
        finally:
            in_noise[0] = False

    q._apply_noise = counted_noise
    for p in paulis:
        real_p = getattr(q.inner, p)

        def pauli(t, _p=p, _real=real_p):
            if in_noise[0]:
                paulis[_p] += 1
            return _real(t)

        setattr(q.inner, p, pauli)
    t0 = time.time()
    for name, args in ops:
        getattr(q, name)(*args)
    q.Finish()
    sync()
    noisy_s = time.time() - t0
    launches = wk.launches()
    want = (1.0 - NOISY_LAMBDA) ** pairs[0]
    got = q.GetUnitaryFidelity()
    check(abs(got - want) <= 1e-12,
          f"w{n} noisy stack: fidelity {got} against (1 - lambda)^"
          f"{pairs[0]} = {want}")
    check(launches["in_tile"] + launches["pair"] > 0,
          f"the w{n} noisy stacks launched no K1/K2: {launches}")
    overlap = ket_fidelity(q.GetQuantumState(), ideal)
    emit({"phase": "noisy_stack", "card": card, "width": n,
          "depth": NOISY_DEPTH, "gates": len(ops), "lambda": NOISY_LAMBDA,
          "clean_s": clean_s, "noisy_s": noisy_s, "clean_fidelity": f0,
          "funnel_pairs": pairs[0], "unitary_fidelity": got,
          "expected": want, "overlap_with_ideal": overlap,
          "paulis": paulis, "launches": launches,
          "cuda_launches": cuda_launches})
    del q
    release()
    return {"stacks": launches, "cuda": cuda_launches}


def trajectories(card: str, dev) -> dict:
    """Phase 28 (module docstring); returns the launches of the bare
    engine."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit
    from qrack_tpu_torch.noise import (NoiseModel, amplitude_damping,
                                       depolarizing, run_trajectories)
    from qrack_tpu_torch.noise import trajectories as traj
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, B = TRAJ_WIDTH, TRAJ_B
    amps = B * (1 << n)
    circ = QCircuit(n)
    for _l, name, args in random_layers(range(n), TRAJ_DEPTH, n + 2):
        if name == "U":
            circ.append_1q(args[0], mat.u3_mtrx(*args[1:]))
        else:
            circ.append_ctrl((args[0],), args[1], mat.X2, 1)
    wk.reset_launches()
    c = qt.create_quantum_interface("cuda", n, rng=QrackRandom(n),
                                    rand_global_phase=False)
    circ.Run(c)
    want = np.array([c.Prob(b) for b in range(n)])
    launches = wk.launches()
    del c
    release()

    t0 = time.time()
    clean = run_trajectories(circ, NoiseModel(), B, key=TRAJ_KEY)
    clean_s = time.time() - t0
    dp = float(np.abs(clean.p1 - want[None, :]).max())
    check(dp <= 1e-5 and np.all(clean.weights == 1.0),
          f"w{n} noise-free trajectories: p1 off the engine by {dp}, "
          f"weights {set(clean.weights.tolist())}")

    model = NoiseModel(default=depolarizing(NOISY_LAMBDA))
    release()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    first = run_trajectories(circ, model, B, key=TRAJ_KEY)
    noisy_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / amps
    # the planes alone are 8 bytes an amplitude: less means they did not
    # live on the card
    check(peak >= 8 and first.chunks == 1,
          f"w{n} B{B}: {peak} bytes an amplitude on the card, "
          f"{first.chunks} chunks")
    again = run_trajectories(circ, model, B, key=TRAJ_KEY)
    check(np.array_equal(again.samples, first.samples)
          and np.array_equal(again.p1, first.p1)
          and np.array_equal(again.weights, first.weights),
          f"w{n}: the same key drew other samples")
    os.environ["QRACK_NOISE_TRAJ_CHUNK"] = TRAJ_CHUNK
    try:
        chunked = run_trajectories(circ, model, B, key=TRAJ_KEY)
    finally:
        del os.environ["QRACK_NOISE_TRAJ_CHUNK"]
    check(chunked.chunks == B // int(TRAJ_CHUNK)
          and np.array_equal(chunked.samples, first.samples)
          and float(np.abs(chunked.weights - first.weights).max()) <= 1e-6
          and float(np.abs(chunked.p1 - first.p1).max()) <= 1e-5,
          f"w{n}: chunks of {TRAJ_CHUNK} against one chunk")
    # the general-Kraus step (renormalise and weigh) on one layer, with
    # the chunk that the budget sizes: a ballast leaves the card room for
    # TRAJ_ROOM trajectories at the coefficient, so a chunk near the
    # limit runs on the real allocator
    kc = QCircuit(n)
    for g in circ.gates[:n]:
        kc.gates.append(g.clone())
    release()
    per_traj = traj.BYTES_PER_AMP * (1 << n)
    free, _total = torch.cuda.mem_get_info()
    ballast = torch.empty(free - int(TRAJ_ROOM * per_traj),
                          dtype=torch.uint8, device=dev)
    budget = traj.budget_bytes(dev)
    budget_chunk = traj.traj_chunk(n, B, dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kraus = run_trajectories(kc, NoiseModel(default=amplitude_damping(0.01)),
                             B, key=TRAJ_KEY)
    kraus_peak = (torch.cuda.max_memory_allocated() - base) / (
        budget_chunk * (1 << n))
    del ballast
    release()
    check(budget_chunk >= 16 and kraus.chunks == -(-B // budget_chunk),
          f"w{n}: a budget of {budget} bytes gave chunks of {budget_chunk}, "
          f"{kraus.chunks} chunks")
    check(traj.BYTES_PER_AMP >= max(peak, kraus_peak),
          f"traj.BYTES_PER_AMP {traj.BYTES_PER_AMP} is below the measured "
          f"peak {max(peak, kraus_peak)}: a chunk could start that does "
          "not fit")
    noise_slots = sum(1 for op in traj.lower_noisy(circ, model)
                      if isinstance(op, traj.NoiseSlot))
    # one batched general 2x2 on three targets, and the readout, against
    # the bytes of the batch (read once, written once)
    release()
    planes = torch.randn((B, 2, 1 << n), device=dev)
    mp = torch.randn((B, 2, 2, 2), device=dev)
    u = torch.rand((B,), device=dev)
    op_ms = {t: timed_warm(lambda t=t: traj.apply_2x2(planes, mp, n, t))
             for t in (0, n // 2, n - 1)}
    readout_ms = timed_warm(lambda: traj.readout(planes, u))
    read_ms = planes.numel() * 4 / PEAK_BYTES_S * 1e3
    del planes, mp, u
    emit({"phase": "trajectories", "card": card, "width": n,
          "trajectories": B, "gates": len(circ.gates),
          "noise_slots": noise_slots, "clean_s": clean_s,
          "max_p1_diff": dp, "noisy_s": noisy_s,
          "trajectories_per_s": B / noisy_s,
          "peak_bytes_per_amp": peak, "kraus_peak_bytes_per_amp": kraus_peak,
          "kraus_budget_bytes": budget, "kraus_budget_chunk": budget_chunk,
          "kraus_chunks": kraus.chunks,
          "bytes_per_amp_coefficient": traj.BYTES_PER_AMP,
          "aggregate_p1_mean": float(first.aggregate_p1.mean()),
          "min_kraus_weight": float(kraus.weights.min()),
          "chunked_chunks": chunked.chunks, "gen_op_ms_by_target": op_ms,
          "readout_ms": readout_ms, "gen_op_bound_ms": 2 * read_ms,
          "readout_bound_ms": read_ms,
          "cuda_launches": launches})
    release()
    return launches


# ---------------------------------------------------------------------------
# the pager: per-page K1/K2, the remap planner and page exchanges
# ---------------------------------------------------------------------------

class PageProbe(SweepProbe):
    """SweepProbe over the pager's per-page launches: the first launch
    of every in-page run and a seeded share (PAGER_HELD) of the rest run
    as the kernel and as its plain version, each timed, and are held to
    the bar of phase 2.  A run starts where fusion.sharded_kernel_window
    _body hands window_kernel.apply_window page 0's payload row (offset
    0 in the run's (pages, floats) payload tensor)."""

    def __init__(self, wk, seed: int, share: float):
        super().__init__(wk)
        self.rng = np.random.default_rng(seed)
        self.share = share
        self.run_start = False
        self.real_apply = wk.apply_window

    def _held(self, k: int) -> bool:
        first, self.run_start = self.run_start, False
        return first or k == 0 or self.rng.random() < self.share

    def __enter__(self):
        def apply(planes, n, structure, fv, *rest, **kw):
            if fv.storage_offset() == 0:
                self.run_start = True
            return self.real_apply(planes, n, structure, fv, *rest, **kw)

        self.wk.apply_window = apply
        return super().__enter__()

    def __exit__(self, *exc):
        self.wk.apply_window = self.real_apply
        return super().__exit__(*exc)


class PageTimer:
    """CUDA events around every per-page window-kernel launch (with its
    bound, launch_bound at the page width) and every page pass of
    ops/sharded.py (exchanges, and the plain in-page passes of the
    window chain and of single ops): no replay, no synchronise until
    ``totals``."""

    PASSES = ("apply_global_2x2", "batched_mixed_swap", "mixed_swap",
              "swap_bits_", "_relabel", "apply_diag", "apply_local_2x2")
    EXCHANGE = ("apply_global_2x2", "batched_mixed_swap", "mixed_swap",
                "swap_bits_", "_relabel")

    def __init__(self, wk, shb):
        self.wk, self.shb = wk, shb
        self.real = {"in_tile": wk.in_tile_sweep, "pair": wk.pair_sweep}
        self.real_pass = {k: getattr(shb, k) for k in self.PASSES}
        self.launches = []   # (entry, ev0, ev1, bytes_ms, ops_ms)
        self.passes = []     # (name, ev0, ev1)

    def _entry(self, name):
        def run(planes, n, bp, table, fv, iv, *span):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            self.real[name](planes, n, bp, table, fv, iv, *span)
            ev[1].record()
            first, count = span[-2], span[-1]
            idx = ([span[0]] if name == "pair" else []) + list(
                range(first, first + count))
            rows = table.cpu().tolist()
            b_ms, o_ms = launch_bound(n, [rows[i] for i in idx],
                                      iv.cpu().tolist(), planes.dtype)
            self.launches.append((name, ev[0], ev[1], b_ms, o_ms))
            return planes
        return run

    def _pass(self, name):
        real = self.real_pass[name]

        def run(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real(*args, **kw)
            ev[1].record()
            self.passes.append((name, ev[0], ev[1]))
            return out
        return run

    def __enter__(self):
        self.wk.in_tile_sweep = self._entry("in_tile")
        self.wk.pair_sweep = self._entry("pair")
        for k in self.PASSES:
            setattr(self.shb, k, self._pass(k))
        return self

    def __exit__(self, *exc):
        self.wk.in_tile_sweep = self.real["in_tile"]
        self.wk.pair_sweep = self.real["pair"]
        for k, fn in self.real_pass.items():
            setattr(self.shb, k, fn)

    def totals(self) -> dict:
        sync()
        out = {}
        for name in ("in_tile", "pair"):
            got = [x for x in self.launches if x[0] == name]
            out[name] = {
                "launches": len(got),
                "ms": sum(a.elapsed_time(b) for _, a, b, _, _ in got),
                "bound_ms": sum(max(bm, om) for *_, bm, om in got),
                "bytes_ms": sum(bm for *_, bm, _ in got),
                "ops_ms": sum(om for *_, om in got)}
        by = {}
        for name, a, b in self.passes:
            by.setdefault(name, [0, 0.0])
            by[name][0] += 1
            by[name][1] += a.elapsed_time(b)
        out["passes"] = {k: {"calls": c, "ms": ms} for k, (c, ms) in by.items()}
        out["exchange_ms"] = sum(by.get(k, [0, 0.0])[1] for k in self.EXCHANGE)
        return out


def pager_circuit(n: int, L: int, depth: int, seed: int) -> list:
    """A seeded depth-`depth` circuit of (method, args) that reaches every
    pager path: per layer a page-bit H, an RY on a page bit, CNOTs with a
    page-bit target and with a page-bit control, CZ and a controlled
    phase between page bits, T and RZ on page bits, a U and an H on
    in-page bits, and one Swap (local-local, mixed or page-page in
    turn)."""
    rng = np.random.default_rng(seed)
    loc = lambda: int(rng.integers(0, L))          # noqa: E731
    top = lambda: int(rng.integers(L, n))          # noqa: E731
    ang = lambda: float(rng.uniform(0, 2 * np.pi))  # noqa: E731
    ops = []
    for d in range(depth):
        g1, g2 = (int(x) for x in rng.choice(np.arange(L, n), 2,
                                              replace=False))
        ops += [("H", (top(),)), ("RY", (ang(), top())),
                ("CNOT", (loc(), top())), ("CNOT", (top(), loc())),
                ("CZ", (g1, g2)), ("CPhaseRootN", (int(rng.integers(2, 6)),
                                                    g1, g2)),
                ("T", (top(),)), ("RZ", (ang(), top())),
                ("U", (loc(), ang(), ang(), ang())), ("H", (loc(),)),
                ("CPhaseRootN", (3, loc(), top()))]
        a, b = (int(x) for x in rng.choice(L, 2, replace=False))
        ops.append(("Swap", [(a, b), (loc(), top()), (g1, g2)][d % 3]))
    return ops


def pages_fidelity(pages, planes) -> float:
    """Fidelity of a pager's pages (logical order: the table identity)
    to dense planes of the same ket, in float64 chunk by chunk."""
    step = 1 << 26
    re = im = na = nb = 0.0
    off = 0
    for page in pages:
        for s in range(0, page.shape[-1], step):
            e = min(s + step, page.shape[-1])
            a = page[:, s:e].double()
            b = planes[:, off + s:off + e].to(page.device).double()
            re += float(a[0] @ b[0] + a[1] @ b[1])
            im += float(a[0] @ b[1] - a[1] @ b[0])
            na += float(a[0] @ a[0] + a[1] @ a[1])
            nb += float(b[0] @ b[0] + b[1] @ b[1])
        off += page.shape[-1]
    return (re * re + im * im) / (na * nb)


def pager_closed_form(q, x: int) -> tuple:
    """(max abs diff, fidelity) of a pager's ket against the QFT of |x>,
    2^(-n/2) exp(2 pi i x rev(k) / 2^n), amplitude by amplitude on the
    card, 2^26 at a time (the table is restored to identity first)."""
    q._unmap()
    return pages_closed_form(q.page_planes, q.qubit_count, x)


def pages_closed_form(pages, n: int, x: int, pid0: int = 0,
                      n_pages: int = None) -> tuple:
    """pager_closed_form over a list of pages in logical order: pages
    pid0, pid0 + 1, ... of a ket of `n_pages` pages (all of them by
    default); the fidelity is that of those pages' amplitudes to the
    closed form's, each normalized."""
    L = n - ((n_pages or len(pages)).bit_length() - 1)
    nb = (n + 7) // 8
    amp = 2.0 ** (-n / 2)
    step = min(1 << 26, 1 << L)
    worst = re = im = na = ne = 0.0
    for p, page in enumerate(pages, start=pid0):
        dev = page.device
        rev8 = torch.tensor([int(f"{v:08b}"[::-1], 2) for v in range(256)],
                            dtype=torch.int64, device=dev)
        for s in range(0, 1 << L, step):
            k = torch.arange(s, s + step, dtype=torch.int64, device=dev)
            k |= p << L
            r = torch.zeros_like(k)
            for i in range(nb):
                r |= rev8[(k >> (8 * i)) & 255] << (8 * (nb - 1 - i))
            r >>= 8 * nb - n
            # x * r mod 2^n without passing 2^63: r in 16-bit halves
            m = (x * (r & 0xFFFF)
                 + (((x * (r >> 16)) & ((1 << (n - 16)) - 1)) << 16))
            m &= (1 << n) - 1
            ang = m.double() * (2 * np.pi / 2.0 ** n)
            er, ei = torch.cos(ang) * amp, torch.sin(ang) * amp
            a = page[:, s:s + step].double()
            worst = max(worst, float((a[0] - er).abs().max()),
                        float((a[1] - ei).abs().max()))
            re += float(er @ a[0] + ei @ a[1])
            im += float(er @ a[1] - ei @ a[0])
            na += float(a[0] @ a[0] + a[1] @ a[1])
            ne += float(er @ er + ei @ ei)
    return worst, (re * re + im * im) / (na * ne)


def page_launches(wk) -> dict:
    return dict(wk.DTYPE_LAUNCHES["float32"])


def pager_parity(card: str, dev, probe) -> dict:
    """Phase 29 (module docstring); returns its per-page launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = PAGER_PARITY_WIDTH, PAGER_PAGES
    L = n - G.bit_length() + 1
    ops = pager_circuit(n, L, PAGER_DEPTH, PAGER_SEED)
    release()
    q = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                    rng=QrackRandom(PAGER_SEED),
                                    rand_global_phase=False)
    check(q.devices == [torch.device("cuda", torch.cuda.current_device())]
          * G, f"pager pages not on the card: {q.devices}")
    wk.reset_launches()
    pg.reset_flushes()
    shb.reset_exchanges()
    t0 = time.time()
    with probe:
        probe.label = "pager_parity"
        for name, args in ops:
            getattr(q, name)(*args)
        q.Finish()
    wall = time.time() - t0
    launches = page_launches(wk)
    predicted = pg.FLUSHES["predicted_launches"]
    check(sum(launches.values()) == predicted and predicted > 0,
          f"per-page launches {launches} against the plans' {predicted}")
    check(launches["in_tile"] > 0 and launches["pair"] > 0,
          f"pager path skipped a kernel entry point: {launches}")
    exchanges = dict(shb.EXCHANGES)
    check(exchanges["global_2x2"] + exchanges["mixed_swap"]
          + exchanges["batched_swap"] > 0,
          f"pager path moved nothing between pages: {exchanges}")
    flushes = dict(pg.FLUSHES)
    d = qt.create_quantum_interface("cuda", n, rng=QrackRandom(PAGER_SEED),
                                    rand_global_phase=False)
    for name, args in ops:
        getattr(d, name)(*args)
    q._unmap()
    f = pages_fidelity(q.page_planes, d.device_planes)
    check(f >= 1 - 1e-5, f"pager against QEngineCUDA at w{n}: {f}")
    held = {k: probe.stats[k]["launches"] for k in ("in_tile", "pair")
            if k in probe.stats}
    emit({"phase": "pager_parity", "card": card, "width": n, "pages": G,
          "ops": len(ops), "fidelity_to_dense": f, "host_wall_s": wall,
          "launches": launches, "predicted_launches": predicted,
          "held_launches": held, "flushes": flushes,
          "exchanges": exchanges})
    del q, d
    release()
    return launches


def pager_qft(card: str, dev) -> dict:
    """Phase 30 (module docstring); returns the per-page launches of the
    engine path and RunFused (their first, checked runs)."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = PAGER_WIDTH, PAGER_PAGES
    release()
    q = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                    rng=QrackRandom(3),
                                    rand_global_phase=False)
    planes_bytes = torch.cuda.memory_allocated()
    circ = qft_qcircuit(n)
    out = {"phase": "pager_qft", "card": card, "width": n, "pages": G,
           "planes_gib": planes_bytes / 2 ** 30}
    launches = {}
    for path, run in (("engine", lambda: q.QFT(0, n)),
                      ("runfused", lambda: circ.RunFused(q))):
        q.SetPermutation(PAGER_PERM)
        wk.reset_launches()
        pg.reset_flushes()
        shb.reset_exchanges()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        q.Finish()
        peak = torch.cuda.max_memory_allocated() - base
        got = page_launches(wk)
        launches[path] = got
        predicted = pg.FLUSHES["predicted_launches"]
        check(sum(got.values()) == predicted and predicted > 0,
              f"{path}: per-page launches {got} against the plans' "
              f"{predicted}")
        check(peak <= PAGE_MEM_BAR,
              f"{path}: {peak / 2 ** 30:.3f} GiB above the planes "
              f"(bar {PAGE_MEM_BAR / 2 ** 30} GiB)")
        worst, f = pager_closed_form(q, PAGER_PERM)
        bar = 1e-4 * 2.0 ** (-n / 2)
        check(worst <= bar and f >= 1 - 1e-5,
              f"{path} w{n} QFT: max diff {worst} (bar {bar}), fidelity {f}")
        out[path] = {"launches": got, "predicted_launches": predicted,
                     "peak_above_planes_gib": peak / 2 ** 30,
                     "max_abs_diff": worst, "fidelity": f,
                     "flushes": dict(pg.FLUSHES),
                     "exchanges": dict(shb.EXCHANGES)}
        if path == "engine":
            q.IQFT(0, n)
            back = q.ProbAll(PAGER_PERM)
            check(back >= 1 - 1e-4, f"w{n} IQFT round trip: ProbAll {back}")
            out["iqft_prob_back"] = back
    # walls: 3 warm reps each (one warm-up run first)
    for path, run in (("engine", lambda: (q.QFT(0, n), q.page_planes)),
                      ("runfused", lambda: circ.RunFused(q))):
        walls = []
        for _ in range(4):
            q.SetPermutation(PAGER_PERM)
            walls.append(timed(run))
        out[path]["wall_ms"] = walls[1:]
    # one more run of each, every launch and page pass between events
    for path, run in (("engine", lambda: q.QFT(0, n)),
                      ("runfused", lambda: circ.RunFused(q))):
        q.SetPermutation(PAGER_PERM)
        shb.reset_exchanges()
        with PageTimer(wk, shb) as timer:
            run()
            q.Finish()
        tot = timer.totals()
        moved = shb.EXCHANGES["bytes"]
        out[path].update({
            "kernel_ms": tot["in_tile"]["ms"] + tot["pair"]["ms"],
            "kernel_bound_ms": (tot["in_tile"]["bound_ms"]
                                + tot["pair"]["bound_ms"]),
            "by_entry": {k: tot[k] for k in ("in_tile", "pair")},
            "exchange_ms": tot["exchange_ms"],
            "exchange_bytes": moved,
            "exchange_bound_ms": moved / PEAK_BYTES_S * 1e3,
            "page_passes": tot["passes"]})
        if path == "engine":
            PAGE_L30.update({k: tot[k] for k in ("in_tile", "pair")})
    emit(out)
    del q
    release()
    return launches


def pager_w33(card: str, dev) -> dict:
    """Phase 31 (module docstring); returns its per-page launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = PAGER_W33, PAGER_W33_PAGES
    release()
    q = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                    rng=QrackRandom(4),
                                    rand_global_phase=False)
    q.SetPermutation(PAGER_PERM33)
    wk.reset_launches()
    pg.reset_flushes()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    ms = timed(lambda: qft_qcircuit(n).RunFused(q))
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = page_launches(wk)
    predicted = pg.FLUSHES["predicted_launches"]
    check(sum(launches.values()) == predicted and predicted > 0,
          f"w{n}: per-page launches {launches} against {predicted}")
    check(peak <= PAGE_MEM_BAR,
          f"w{n}: {peak / 2 ** 30:.3f} GiB above the planes")
    worst, f = pager_closed_form(q, PAGER_PERM33)
    bar = 1e-4 * 2.0 ** (-n / 2)
    check(worst <= bar and f >= 1 - 1e-5,
          f"w{n} RunFused QFT: max diff {worst} (bar {bar}), fidelity {f}")
    emit({"phase": "pager_w33", "card": card, "width": n, "pages": G,
          "planes_gib": base / 2 ** 30, "runfused_ms": ms,
          "host_wall_s": wall, "peak_above_planes_gib": peak / 2 ** 30,
          "max_abs_diff": worst, "fidelity": f, "launches": launches,
          "predicted_launches": predicted})
    del q
    release()
    return launches


def pager_factory(card: str, dev) -> dict:
    """Phase 32 (module docstring); returns its per-page launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.engines.hybrid import QHybrid
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = PAGER_FACTORY_WIDTH
    out = {"phase": "pager_factory", "card": card, "width": n}
    total = {"in_tile": 0, "pair": 0}
    for layers in ("pager", "hybrid"):
        release()
        wk.reset_launches()
        t0 = time.time()
        q = qt.create_quantum_interface(layers, n, devices=[dev] * 2,
                                        rng=QrackRandom(5),
                                        rand_global_phase=False)
        eng = q._engine if isinstance(q, QHybrid) else q
        check(isinstance(eng, QPager) and eng.n_pages == 2
              and eng.devices[0].type == "cuda",
              f"{layers} at w{n} is not a 2-page pager on the card")
        q.H(0)
        for i in range(n - 1):
            q.CNOT(i, i + 1)
        p_top = q.Prob(n - 1)
        p0, p1 = q.ProbAll(0), q.ProbAll((1 << n) - 1)
        got = page_launches(wk)
        check(abs(p_top - 0.5) <= 1e-5 and abs(p0 - 0.5) <= 1e-5
              and abs(p1 - 0.5) <= 1e-5,
              f"{layers} w{n} GHZ: Prob(top) {p_top}, ends {p0}, {p1}")
        check(sum(got.values()) > 0, f"{layers} w{n} launched no kernel")
        for k in total:
            total[k] += got[k]
        out[layers] = {"prob_top": p_top, "prob_ends": [p0, p1],
                       "launches": got, "host_wall_s": time.time() - t0}
        del q, eng
    emit(out)
    release()
    return total


# ---------------------------------------------------------------------------
# the rest of the pager: split-index ops past 31 qubits, the whole-circuit
# programs over pages, the TurboQuant pager, QUnitMulti
# ---------------------------------------------------------------------------

def bcd_table(to_add: int) -> list:
    """INCBCD on one decimal digit as the permutation of its 16 values:
    a valid digit d goes to (d + to_add) mod 10, an invalid one stays."""
    return [(v + to_add) % 10 if v < 10 else v for v in range(16)]


def lda_as_gates(o, index_start: int, index_length: int, value_start: int,
                 value_length: int, values) -> None:
    """IndexedLDA into a zero value register as the gates that load it:
    for each index k, an X on each set bit of values[k] under the index
    register's controls at k (the sparse engine's own IndexedLDA returns
    the register's expectation, which builds the dense 2^n distribution)."""
    from qrack_tpu_torch import matrices as mat

    ctrls = tuple(range(index_start, index_start + index_length))
    for k, v in enumerate(values):
        for b in range(value_length):
            if (v >> b) & 1:
                o.MCMtrxPerm(ctrls, mat.X2, value_start + b, k)


def forced_parity(o, mask: int, result: bool) -> dict:
    """The closed form of ForceMParity over the oracle's nonzero list:
    the amplitudes of the forced parity, renormalized (0 elsewhere)."""
    par = np.array([bin(int(i) & mask).count("1") & 1 for i in o._idx])
    keep = par == int(bool(result))
    norm = np.sqrt(float(np.sum(np.abs(o._amp[keep]) ** 2)))
    return {int(i): (a / norm if k else 0.0)
            for i, a, k in zip(o._idx, o._amp, keep)}


def wide_sequence(n: int, rng) -> list:
    """The seeded op sequence of phase 33: (method, args, kind) with kind
    "diag" (a split factor pass) or "gather" (a ring gather); every
    register spans the page boundary at bit n - 2 (4 pages)."""
    t = n - 4           # the top nibble, bits n-4 .. n-1
    ang = lambda: float(rng.uniform(0.1, 3.0))   # noqa: E731
    perm16 = [int(v) for v in rng.permutation(16)]
    lda = [int(v) for v in rng.integers(0, 16, 8)]
    return [
        ("XMask", ((1 << (n - 1)) | (1 << (n - 3)) | (1 << 3),), "gather"),
        ("ZMask", ((1 << (n - 2)) | (1 << 2) | (1 << (n - 3)),), "diag"),
        ("PhaseParity", (ang(), (1 << (n - 1)) | (1 << 1) | (1 << 5)),
         "diag"),
        ("UniformParityRZ", ((1 << (n - 2)) | (1 << (n - 3)), ang()), "diag"),
        ("CUniformParityRZ", ((n - 1,), (1 << 2) | (1 << (n - 2)), ang()),
         "diag"),
        ("PhaseFlipIfLess", (int(rng.integers(3, 14)), t, 4), "diag"),
        ("INC", (int(rng.integers(1, 32)), t - 1, 5), "gather"),
        ("CINC", (int(rng.integers(1, 16)), 0, 4, (n - 1,)), "gather"),
        ("INCBCD", (int(rng.integers(1, 10)), t, 4), "gather"),
        ("ROL", (int(rng.integers(1, 6)), t - 2, 6), "gather"),
        ("Hash", (t, 4, perm16), "gather"),
        ("MUL", (3, t, 8, 3), "gather"),          # carry bits 8-10 at |0>
        ("DIV", (3, t, 8, 3), "gather"),
        ("POWModNOut", (2, 15, n - 3, 12, 3), "gather"),   # out 12-15
        ("IndexedLDA", (n - 3, 3, 16, 4, lda), "gather"),  # value 16-19
        ("ForceMParity", ((1 << (n - 1)) | (1 << 1), True), "diag"),
    ]


def pager_norm(q) -> float:
    from qrack_tpu_torch.ops import sharded as shb

    return float(sum(shb.page_probs(q.page_planes)))


def support_diff(q, o) -> float:
    """Largest |pager amplitude - oracle amplitude| over the oracle's
    support (the pager's norm bounds what lies elsewhere)."""
    worst = 0.0
    for i, a in zip(o._idx.tolist(), o._amp.tolist()):
        worst = max(worst, abs(q.GetAmplitude(int(i)) - a))
    return worst


def wide_ops(card: str, dev) -> dict:
    """Phase 33 (module docstring); returns the window kernel's per-page
    launches of the phase."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.engines.sparse import QEngineSparse
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = WIDE_WIDTH, PAGER_PAGES
    rng = np.random.default_rng(WIDE_SEED)
    release()
    wk.reset_launches()
    q = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                    rng=QrackRandom(WIDE_SEED),
                                    rand_global_phase=False)
    check(q._wide_alu, f"w{n} pager not on the split-index path")
    o = QEngineSparse(n, rng=QrackRandom(WIDE_SEED), rand_global_phase=False)
    planes_bytes = torch.cuda.memory_allocated()
    for e in (q, o):
        for b in (1, 2, 5, n - 3, n - 2, n - 1):
            e.H(b)
        e.T(1)
        e.RZ(0.7, n - 1)
        e.CNOT(n - 2, 6)
    q.Finish()
    prep = page_launches(wk)
    ops = []
    for name, args, kind in wide_sequence(n, rng):
        torch.cuda.reset_peak_memory_stats()
        ms = timed(lambda: getattr(q, name)(*args))
        peak = torch.cuda.max_memory_allocated() - planes_bytes
        if name == "ForceMParity":       # the last op: its closed form
            want = forced_parity(o, *args)
            diff = max(abs(q.GetAmplitude(i) - a) for i, a in want.items())
        else:
            if name == "INCBCD":
                o.Hash(args[1], args[2], bcd_table(args[0]))
            elif name == "IndexedLDA":
                lda_as_gates(o, *args)
            else:
                getattr(o, name)(*args)
            diff = support_diff(q, o)
        norm = pager_norm(q)
        bar = PAGE_MEM_BAR + (planes_bytes if kind == "gather" else 0)
        check(diff <= 1e-6 and abs(norm - 1) <= 1e-5,
              f"w{n} {name}: max diff {diff} over {o.nnz()} amplitudes, "
              f"norm {norm}")
        check(peak <= bar, f"w{n} {name}: {peak / 2 ** 30:.3f} GiB above "
                           f"the planes (bar {bar / 2 ** 30} GiB)")
        moved = (2 if kind == "diag" else 4) * 2 * (1 << n) * 4
        ops.append({"op": name, "kind": kind, "ms": ms,
                    "bound_ms": moved / PEAK_BYTES_S * 1e3,
                    "peak_above_planes_gib": peak / 2 ** 30,
                    "max_abs_diff": diff, "norm": norm, "support": o.nnz()})
    launches = page_launches(wk)
    check(sum(launches.values()) > 0, f"w{n} prep launched no kernel")
    out = {"phase": "wide_ops", "card": card, "width": n, "pages": G,
           "planes_gib": planes_bytes / 2 ** 30, "ops": ops,
           "launches": launches, "prep_launches": prep}
    del q, o
    release()

    # w33 on 8 pages: in-place ops against a GHZ-like closed form
    n33, G33 = PAGER_W33, PAGER_W33_PAGES
    q = qt.create_quantum_interface("pager", n33, devices=[dev] * G33,
                                    rng=QrackRandom(WIDE_SEED),
                                    rand_global_phase=False)
    planes_bytes = torch.cuda.memory_allocated()
    x = 1 | (1 << 15) | (1 << (n33 - 2)) | (1 << (n33 - 1))
    wk.reset_launches()
    q.H(0)
    for b in (15, n33 - 2, n33 - 1):
        q.CNOT(0, b)
    q.Finish()          # the prep's windows and page passes, untimed
    launches33 = page_launches(wk)
    check(sum(launches33.values()) > 0, f"w{n33} prep launched no kernel")
    z_mask = (1 << (n33 - 1)) | (1 << 7)          # odd on |x>
    r_mask, theta = (1 << 15) | (1 << (n33 - 2)) | (1 << 2), 0.45  # even
    f_mask = (1 << (n33 - 2)) | (1 << 3)          # odd on |x>: keeps |x>
    s = 2 ** -0.5
    want = [("ZMask", (z_mask,), {0: s, x: -s}),
            ("UniformParityRZ", (r_mask, theta),
             {0: s * np.exp(-1j * theta), x: -s * np.exp(-1j * theta)}),
            ("ForceMParity", (f_mask, True),
             {0: 0.0, x: -np.exp(-1j * theta)})]
    w33 = []
    for name, args, amps in want:
        torch.cuda.reset_peak_memory_stats()
        ms = timed(lambda: getattr(q, name)(*args))
        peak = torch.cuda.max_memory_allocated() - planes_bytes
        diff = max(abs(q.GetAmplitude(i) - a) for i, a in amps.items())
        norm = pager_norm(q)
        check(diff <= 1e-6 and abs(norm - 1) <= 1e-5,
              f"w{n33} {name}: diff {diff}, norm {norm}")
        check(peak <= PAGE_MEM_BAR,
              f"w{n33} {name}: {peak / 2 ** 30:.3f} GiB above the planes")
        w33.append({"op": name, "ms": ms,
                    "bound_ms": 2 * 2 * (1 << n33) * 4 / PEAK_BYTES_S * 1e3,
                    "peak_above_planes_gib": peak / 2 ** 30,
                    "max_abs_diff": diff, "norm": norm})
    launches33 = page_launches(wk)
    out["w33"] = {"width": n33, "pages": G33,
                  "planes_gib": planes_bytes / 2 ** 30, "ops": w33,
                  "launches": launches33}
    launches = {k: launches[k] + launches33[k] for k in launches}
    del q
    release()

    # the compressed engine's split phase program at w32, int8
    t = qt.create_quantum_interface("turboquant", n, bits=8,
                                    rng=QrackRandom(WIDE_SEED),
                                    rand_global_phase=False)
    a, b, c = 0, 20, n - 1
    for k in (a, b, c):
        t.H(k)
    tq_ms = {}
    tq_ms["ZMask"] = timed(lambda: t.ZMask(1 << a))            # |+> -> |->
    tq_ms["UniformParityRZ"] = timed(
        lambda: t.UniformParityRZ((1 << b) | (1 << c), 0.6))
    for k in (a, b, c):
        t.H(k)
    probs = {k: t.Prob(k) for k in (a, b, c, 7)}
    closed = {a: 1.0, b: np.sin(0.6) ** 2, c: np.sin(0.6) ** 2, 7: 0.0}
    worst = max(abs(probs[k] - closed[k]) for k in closed)
    check(worst <= 2e-2, f"w{n} turboquant split phases: Prob {probs} "
                         f"against {closed}")
    out["turboquant_w32"] = {"bits": 8, "ms": tq_ms, "prob": probs,
                             "closed_form": closed, "max_prob_diff": worst,
                             "resident_gib": t.resident_bytes() / 2 ** 30}
    del t
    release()
    emit(out)
    return launches


def page_programs(card: str, dev) -> dict:
    """Phase 34 (module docstring).  The programs are plain torch page
    passes (no kernel); the dense engine they are held to launches K1/K2,
    which the phase does not count for the pager."""
    import math

    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models import grover as grm
    from qrack_tpu_torch.models import rcs as rcsm
    from qrack_tpu_torch.models.qft import (basis_pages, basis_planes,
                                            make_sharded_qft_fn, qft_qcircuit)
    from qrack_tpu_torch.utils.rng import QrackRandom

    out = {"phase": "page_programs", "card": card}

    def run(fn, pages):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = timed(lambda: fn(pages))
        peak = torch.cuda.max_memory_allocated() - base
        check(peak <= PAGE_MEM_BAR,
              f"{peak / 2 ** 30:.3f} GiB above the pages")
        return ms, peak / 2 ** 30

    release()
    n = SHARDED_QFT_FN_WIDTH
    fn, devs = make_sharded_qft_fn([dev] * PAGER_PAGES, n)
    pages = basis_pages(n, PERM, devs)
    ms, peak = run(fn, pages)
    worst, f = pages_closed_form(pages, n, PERM)
    bar = 1e-4 * 2.0 ** (-n / 2)
    check(worst <= bar and f >= 1 - 1e-5,
          f"w{n} sharded QFT: max diff {worst} (bar {bar}), fidelity {f}")
    out["qft"] = {"width": n, "pages": PAGER_PAGES, "ms": ms,
                  "peak_above_planes_gib": peak, "max_abs_diff": worst,
                  "fidelity": f}
    del pages
    release()

    n = SHARDED_QFT_WIDTH
    circ = qft_qcircuit(n)
    fn, devs = circ.compile_sharded_fn([dev] * PAGER_PAGES, n)
    pages = basis_pages(n, PERM, devs)
    ms, peak = run(fn, pages)
    d = qt.create_quantum_interface("cuda", n, rng=QrackRandom(3),
                                    rand_global_phase=False)
    d.SetPermutation(PERM)
    dense_ms = timed(lambda: (circ.RunFused(d), d.device_planes))
    f = pages_fidelity(pages, d.device_planes)
    check(f >= 1 - 1e-5, f"compile_sharded_fn QFT w{n}: fidelity {f}")
    out["compile_sharded_qft"] = {"width": n, "pages": PAGER_PAGES,
                                  "ms": ms, "peak_above_planes_gib": peak,
                                  "fidelity_to_dense_runfused": f,
                                  "dense_runfused_ms": dense_ms}
    del pages, d
    release()

    n = WIDTH
    fn, devs = rcsm.make_sharded_rcs_fn([dev] * PAGER_PAGES, n,
                                        RCS_PAGE_DEPTH, RCS_SEED)
    pages = basis_pages(n, 0, devs)
    ms, peak = run(fn, pages)
    ref = rcsm.make_rcs_fn(n, RCS_PAGE_DEPTH, RCS_SEED)(
        basis_planes(n, 0, device=dev))
    f = pages_fidelity(pages, ref)
    check(f >= 1 - 1e-5, f"sharded RCS w{n}: fidelity {f}")
    out["rcs"] = {"width": n, "pages": PAGER_PAGES, "depth": RCS_PAGE_DEPTH,
                  "ms": ms, "peak_above_planes_gib": peak,
                  "fidelity_to_make_rcs_fn": f}
    del pages, ref
    release()

    n = SHARDED_GROVER_WIDTH
    target = int(np.random.default_rng(n).integers(1, 1 << n))
    fn, devs, iters = grm.make_sharded_grover_fn([dev] * PAGER_PAGES, n,
                                                 target, iters=GROVER_PAGE_ITERS)
    pages = basis_pages(n, 0, devs)
    ms, peak = run(fn, pages)
    L = n - (PAGER_PAGES.bit_length() - 1)
    amp = pages[target >> L][:, target & ((1 << L) - 1)].double()
    p = float(amp[0] ** 2 + amp[1] ** 2)
    closed = math.sin((2 * iters + 1) * math.asin(2.0 ** (-n / 2))) ** 2
    check(abs(p - closed) <= 1e-4 * closed,
          f"sharded Grover w{n}: success {p} against {closed}")
    out["grover"] = {"width": n, "pages": PAGER_PAGES, "iters": iters,
                     "ms": ms, "peak_above_planes_gib": peak,
                     "success": p, "closed_form": closed}
    del pages
    release()
    emit(out)
    return out


def tq_pager(card: str, dev) -> dict:
    """Phase 35 (module docstring).  The TurboQuant pager runs the plain
    chunk programs, as the JAX package's: no kernel launches (checked)."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = TQ_PAGER_WIDTH
    release()
    tqk.reset_launches()
    q = qt.create_quantum_interface("turboquant_pager", n, bits=8,
                                    devices=[dev] * PAGER_PAGES,
                                    rng=QrackRandom(35),
                                    rand_global_phase=False)
    check(q.n_pages == PAGER_PAGES and q._codes[0].device.type == "cuda",
          "the TurboQuant pager is not on the card")
    t0 = time.time()
    ghz_ms = timed(lambda: (q.H(0), [q.CNOT(i, i + 1) for i in range(n - 1)],
                            q._codes))
    read = sorted(int(k) for k in np.random.default_rng(TQ_PAGER_READS)
                  .choice(n, n // 2, replace=False))
    probs = [q.Prob(k) for k in read]
    ends = [q.ProbAll(0), q.ProbAll((1 << n) - 1)]
    wall = time.time() - t0
    worst = max(abs(p - 0.5) for p in probs + ends)
    check(worst <= 2e-2, f"w{n} TurboQuant pager GHZ: Prob {probs}, "
                         f"ends {ends}")
    out = {"phase": "tq_pager", "card": card, "width": n, "bits": 8,
           "pages": PAGER_PAGES, "ghz_ms": ghz_ms, "host_wall_s": wall,
           "max_prob_diff": worst, "prob_ends": ends, "read_qubits": read,
           "resident_bytes_per_page": q.resident_bytes_per_device(),
           "local_chunk_bits": q._local_chunk_bits()}
    del q
    release()

    n = TQ_PAGER_SMALL
    q = qt.create_quantum_interface("turboquant_pager", n, bits=8,
                                    devices=[dev] * PAGER_PAGES,
                                    rng=QrackRandom(36),
                                    rand_global_phase=False)
    d = qt.create_quantum_interface("cuda", n, rng=QrackRandom(36),
                                    rand_global_phase=False)
    L = n - (PAGER_PAGES.bit_length() - 1)
    ops = pager_circuit(n, L, 2, PAGER_SEED)
    for e in (q, d):
        for name, args in ops:
            getattr(e, name)(*args)
    f = fidelity(q._state, d.device_planes)
    check(f >= 0.99, f"w{n} TurboQuant pager against QEngineCUDA: {f}")
    launches = dict(tqk.LAUNCHES)
    check(sum(launches.values()) == 0,
          f"the TurboQuant pager launched a kernel: {launches}")
    out["w26"] = {"width": n, "ops": len(ops), "fidelity_to_dense": f,
                  "resident_bytes_per_page": q.resident_bytes_per_device()}
    out["kernel_launches"] = launches
    del q, d
    release()
    emit(out)
    return out


def unit_multi(card: str, dev) -> dict:
    """Phase 36 (module docstring); returns the window kernel's launches
    of the stack's units."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    h = UNIT_MULTI_HALF
    n = 2 * h
    release()
    # the same seed over either qubit list draws the same angles
    layers = [list(zip(random_layers(range(r * h, (r + 1) * h),
                                     UNIT_MULTI_DEPTH, UNIT_MULTI_SEED + r),
                       random_layers(range(h), UNIT_MULTI_DEPTH,
                                     UNIT_MULTI_SEED + r)))
              for r in range(2)]
    # the reference engines first, flushed, so that the count below is
    # the stack's alone
    dense = [qt.create_quantum_interface("cuda", h, rng=QrackRandom(36),
                                         rand_global_phase=False)
             for _ in range(2)]
    for r in range(2):
        for _, (_, name, args) in layers[r]:
            getattr(dense[r], name)(*args)
        dense[r].Finish()
    q = qt.create_quantum_interface("optimal_multi", n, device_ids=[0, 0],
                                    rng=QrackRandom(36),
                                    rand_global_phase=False)
    wk.reset_launches()
    t0 = time.time()
    for r in range(2):
        for (_, name, args), _ in layers[r]:
            getattr(q, name)(*args)
    q._flush_all()      # QUnit defers gates to the reads: push them now
    q.RedistributeQEngines()
    q.Finish()
    stack_s = time.time() - t0
    launches = page_launches(wk)
    engines = cuda_engines(q)
    check(len(engines) == 2 and all(e.qubit_count == h and
                                    e.device.type == "cuda" for e in engines),
          f"optimal_multi units are not two w{h} engines on the card: "
          f"{[(e.qubit_count, e.device) for e in engines]}")
    check(sum(launches.values()) > 0, "QUnitMulti's units launched no kernel")
    worst = 0.0
    for r in range(2):
        for k in range(h):
            worst = max(worst, abs(q.Prob(k + r * h) - dense[r].Prob(k)))
    idx = np.random.default_rng(n).integers(0, 1 << h, (UNIT_MULTI_AMPS, 2))
    got = np.array([q.GetAmplitude(int(a) | (int(b) << h)) for a, b in idx])
    want = np.array([dense[0].GetAmplitude(int(a))
                     * dense[1].GetAmplitude(int(b)) for a, b in idx])
    overlap = (abs(np.vdot(got, want)) ** 2
               / (np.vdot(got, got).real * np.vdot(want, want).real))
    check(worst <= 1e-5 and overlap >= 1 - 1e-5,
          f"optimal_multi registers against w{h} QEngineCUDA: Prob diff "
          f"{worst}, amplitude overlap {overlap}")
    table = [{"device_id": d.device_id, "capacity_bytes": d.capacity_bytes,
              "weight": d.weight, "used_bytes": d.used_bytes}
             for d in q.devices]
    check(sorted(d["used_bytes"] for d in table)[0] > 0,
          f"the two units share one row of the table: {table}")
    emit({"phase": "unit_multi", "card": card, "width": n,
          "register_width": h, "depth": UNIT_MULTI_DEPTH,
          "stack_host_wall_s": stack_s, "max_prob_diff": worst,
          "amplitude_overlap": overlap, "amplitudes": UNIT_MULTI_AMPS,
          "device_table": table,
          "placement": [{"qubits": e.qubit_count, "device": str(e.device)}
                        for e in engines],
          "launches": launches})
    del q, dense, engines
    release()
    return launches


def telemetry_hooks(dev, tmp: str) -> dict:
    """The small stacks of phase 37 that reach every hook the w30 and w32
    QFTs do not: QUnit over the stabilizer hybrid, QHybrid's grow and
    switch, the tree's switch, QUnitMulti, trajectories, the compressed
    engine, the float64 escalation, a checkpoint and a build.  Returns
    the compressed engine's kernel launches."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.checkpoint import container
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.noise import NoiseModel, depolarizing
    from qrack_tpu_torch.noise import run_trajectories
    from qrack_tpu_torch.ops import cuda_build
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.utils.rng import QrackRandom

    n = TELE_HOOK_WIDTH
    cuda_build.build([wk.SOURCE, tqk.SOURCE])   # both found built: hits
    o = qt.create_quantum_interface("optimal", n, rng=QrackRandom(37))
    for i in range(n):
        o.H(i)
    for i in range(n - 1):
        o.CNOT(i, i + 1)
    o.T(0)
    o.H(0)
    o.T(3)                 # off the tableau: the switch to the engine
    o.CNOT(0, n - 1)
    o.Prob(2)
    o.M(3)
    h = qt.create_quantum_interface("hybrid", 10, tpu_threshold_qubits=12)
    h.H(0)
    h.Allocate(10, 4)      # past the threshold: grows onto the card
    h.T(12)
    h.Dispose(10, 4, 0)    # back below it: switches to the host engine
    h.Prob(0)
    b = qt.create_quantum_interface(["bdt_hybrid", "hybrid"], 8,
                                    tpu_threshold_qubits=3,
                                    ratio_threshold=0.1)
    rng = np.random.default_rng(37)
    for i in range(8):
        b.H(i)
    for _ in range(3):
        for i in range(7):
            b.MCPhase([i], 1.0, np.exp(1j * rng.uniform(0, 3)), i + 1)
        for i in range(8):
            b.RY(float(rng.uniform(0, 3)), i)
    b.Prob(3)
    m = qt.create_quantum_interface("optimal_multi", 8, device_ids=[0, 0])
    m.H(0)
    m.CNOT(0, 1)
    m.T(1)
    m.RedistributeQEngines()
    run_trajectories(qft_qcircuit(10), NoiseModel(default=depolarizing(0.01)),
                     8, device=dev)
    tqk.reset_launches()
    t = qt.create_quantum_interface("turboquant", n, rng=QrackRandom(37))
    t.H(0)
    t.QFT(0, n)
    t.Prob(n - 1)
    tq_launches = dict(tqk.LAUNCHES)
    f = qt.create_quantum_interface("cuda", 12)
    f.H(0)
    f.EscalateToF64(1.0)
    path = os.path.join(tmp, "probe.qckpt")
    container.save_container(path, {"amps": np.arange(8)}, kind="probe")
    container.load_container(path, expect_kind="probe")
    del o, h, b, m, t, f
    release()
    return tq_launches


def trace_kernels(path: str, name: str) -> dict:
    """The device kernels of a torch.profiler Chrome trace: how many have
    `name` in their name and their summed ms, and the summed ms of all
    of them (one stream: the time the card was busy)."""
    with open(path) as fh:
        kernels = [e for e in json.load(fh)["traceEvents"]
                   if e.get("cat") == "kernel"]
    mine = [e for e in kernels if name in e.get("name", "")]
    return {"listed": len(mine),
            "ms": sum(e.get("dur", 0.0) for e in mine) / 1e3,
            "all_kernels": len(kernels),
            "all_ms": sum(e.get("dur", 0.0) for e in kernels) / 1e3}


def telemetry_phase(card: str, dev) -> dict:
    """Phase 37 (module docstring); returns its kernel launches: "dense"
    (K1/K2 of the w30 QFTs and the small stacks), "pager" (per page, the
    w32 QFT) and "tq" (K3-K5 of the small compressed engine)."""
    import tempfile

    import qrack_tpu_torch as qt
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.telemetry import roofline, sentinel
    from qrack_tpu_torch.utils.rng import QrackRandom
    from qrack_tpu_torch.utils.timing import event_ms

    tele.disable()
    tele.reset()
    release()
    out = {"phase": "telemetry", "card": card, "width": WIDTH}
    q = qt.create_quantum_interface("cuda", WIDTH)

    def qft():
        q.QFT(0, WIDTH)
        return q.device_planes

    def walls(reps: int) -> list:
        got = []
        for _ in range(reps + 1):      # one warm run first
            q.SetPermutation(PERM)
            got.append(event_ms(qft))
        return got[1:]

    def wall() -> float:
        q.SetPermutation(PERM)
        return event_ms(qft)

    # ---- no cost while disabled ---------------------------------------
    phase4 = list(PHASE4_WARM)
    out["phase4_warm_ms"] = phase4
    wk.reset_launches()
    disabled, ref = against_reference(wall)
    check(tele.snapshot()["counters"] == {},
          "disabled telemetry recorded counters")
    ref_ms = float(np.median(ref))
    off_ms = float(np.median(disabled))
    rel = (off_ms - ref_ms) / ref_ms
    # a cost is a slower wall, and a faster disabled wall costs nothing
    check(rel <= TELE_DISABLED_BAR,
          f"disabled w{WIDTH} QFT {off_ms:.2f} ms against the reference's "
          f"median {ref_ms:.2f} ms in the same seconds ({rel:+.2%}, bar "
          f"{TELE_DISABLED_BAR:.0%})")
    tele.enable()
    enabled = walls(3)
    on_ms = float(np.median(enabled))
    out.update({"disabled_ms": disabled, "disabled_median_ms": off_ms,
                "reference_ms": ref, "disabled_rel": rel,
                "disabled_rel_to_phase4": (
                    off_ms / float(np.median(phase4)) - 1.0
                    if phase4 else None),
                "enabled_ms": enabled,
                "enabled_median_ms": on_ms,
                "enabled_overhead_rel": (on_ms - off_ms) / off_ms})

    # ---- counts on the main path: one QFT, its own snapshot difference
    windows = []
    real_make = wk.make_window_fn
    requested = [0]
    real_mc = q.MCMtrxPerm

    def make(n, structure, *a, **k):
        windows.append(wk.plan_sweeps(structure, k.get("block_pow",
                                                       wk.DEFAULT_BLOCK_POW),
                                      n))
        return real_make(n, structure, *a, **k)

    def mc(*a, **k):
        requested[0] += 1
        return real_mc(*a, **k)

    q.SetPermutation(PERM)
    planes = q.device_planes
    before = tele.snapshot()["counters"]
    l0 = sum(wk.launches().values())
    wk.make_window_fn, q.MCMtrxPerm = make, mc
    try:
        with tele.span("chip.qft.w30", sync=planes):
            qft()
    finally:
        wk.make_window_fn = real_make
        del q.MCMtrxPerm
    launches = sum(wk.launches().values()) - l0
    snap = tele.snapshot()
    after = snap["counters"]

    def d(name):
        return after.get(name, 0) - before.get(name, 0)

    gates = sum(d(k) for k in after if k.startswith("gate.cuda.")
                and k.endswith(f".w{WIDTH}"))
    sweeps, kwin = d("fuse.kernel.sweeps"), d("fuse.kernel.windows")
    check(launches > 0 and sweeps == launches == sum(windows),
          f"fuse.kernel.sweeps {sweeps}, window kernel launches {launches}, "
          f"plans' sweeps {sum(windows)}")
    check(kwin == len(windows),
          f"fuse.kernel.windows {kwin}, windows through the kernel "
          f"{len(windows)}")
    check(gates == requested[0] == WIDTH * (WIDTH + 1) // 2,
          f"gate.cuda.*.w{WIDTH} {gates}, gates requested {requested[0]}")
    out["main_path"] = {"windows": kwin, "sweeps": sweeps,
                        "plans_sweeps": sum(windows), "launches": launches,
                        "gates_counted": gates,
                        "gates_requested": requested[0],
                        "xla_windows": d("fuse.xla.windows")}

    # ---- the roofline on the card --------------------------------------
    planned = d("roofline.cuda.fuse.flush.planned_bytes")
    all_sweeps = sweeps + d("fuse.xla.sweeps")
    check(planned == all_sweeps * sentinel.plane_pass_bytes(WIDTH, 4),
          f"planned bytes {planned} for {all_sweeps} sweeps")
    wall_s = snap["spans"]["chip.qft.w30"]["total_s"]
    fp = roofline.device_class(refresh=True)
    i = torch.cuda.current_device()
    kind = torch.cuda.get_device_name(i)
    check(fp["kind"] == kind and fp["platform"] == "cuda"
          and fp["hbm_bytes"] == torch.cuda.get_device_properties(i)
          .total_memory and fp["peak_gbps"] == sentinel.peak_gbps(kind),
          f"device class {fp} for {kind}")
    sample = roofline.record("chip.qft.w30", planned, wall_s, width=WIDTH,
                             stack="cuda")
    clamped = tele.snapshot()["counters"].get("roofline.honesty.clamped", 0)
    check(not sample["clamped"] and clamped == 0
          and sample["implied_hbm_gbps"] <= fp["peak_gbps"],
          f"roofline sample {sample} ({clamped} clamped)")
    out["roofline"] = {"planned_bytes": planned, "span_wall_ms": wall_s * 1e3,
                       "implied_gbps": sample["implied_hbm_gbps"],
                       "peak_frac": sample["hbm_roofline_frac"],
                       "clamped": clamped, "device_class": fp}

    with tempfile.TemporaryDirectory(prefix="qtt_tele_") as tmp:
        # ---- the torch.profiler bracket around one QFT -----------------
        q.SetPermutation(PERM)
        q.device_planes
        l0 = sum(wk.launches().values())
        with tele.profiler_bracket(os.path.join(tmp, "prof"),
                                   name="qft_w30") as trace:
            qft()
            sync()
        prof_launches = sum(wk.launches().values()) - l0
        listed = trace_kernels(trace, "window_tiles")
        check(prof_launches > 0 and listed["listed"] == prof_launches,
              f"profiler trace lists {listed} window kernels, the wrappers "
              f"counted {prof_launches}")
        # the card's busy time against the unprofiled enabled wall: the
        # idle share of the engine path
        out["profiler"] = {"window_kernels_listed": listed["listed"],
                           "launches": prof_launches,
                           "window_kernel_ms": listed["ms"],
                           "all_kernels": listed["all_kernels"],
                           "busy_ms": listed["all_ms"],
                           "idle_share": 1 - listed["all_ms"] / on_ms,
                           "trace_bytes": os.path.getsize(trace)}
        del q, planes
        release()

        # ---- every other hook, at small widths -------------------------
        tq_launches = telemetry_hooks(dev, tmp)
        dense = dict(page_launches(wk))

        # ---- counts on the pager ---------------------------------------
        n, G = PAGER_WIDTH, PAGER_PAGES
        p = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                        rng=QrackRandom(3),
                                        rand_global_phase=False)
        p.SetPermutation(PAGER_PERM)
        p.Finish()
        wk.reset_launches()
        pg.reset_flushes()
        shb.reset_exchanges()
        before = tele.snapshot()["counters"]
        t0 = time.time()
        p.QFT(0, n)
        p.Finish()
        pager_s = time.time() - t0
        p.GetAmplitude(PAGER_PERM)      # a host read of one amplitude
        after = tele.snapshot()["counters"]
        page = page_launches(wk)
        moved = dict(shb.EXCHANGES)
        tele_moved = {k: d(f"exchange.pager.{k}") for k in moved}
        check(tele_moved == moved and moved["bytes"] > 0,
              f"exchange.pager.* {tele_moved} against sharded.EXCHANGES "
              f"{moved}")
        check(d("roofline.pager.exchange.planned_bytes") == moved["bytes"],
              "the pager's roofline bytes are not its exchange bytes")
        psweeps = d("fuse.kernel.sweeps")
        per_page = G * (psweeps - moved["global_2x2"])
        check(sum(page.values()) == per_page
              == pg.FLUSHES["predicted_launches"] > 0,
              f"per-page launches {page}, {G} pages x (fuse.kernel.sweeps "
              f"{psweeps} - paged 2x2s {moved['global_2x2']}), plans "
              f"{pg.FLUSHES['predicted_launches']}")
        check(d("fuse.kernel.windows") == pg.FLUSHES["kernel_windows"],
              f"fuse.kernel.windows {d('fuse.kernel.windows')}, the pager's "
              f"kernel windows {pg.FLUSHES['kernel_windows']}")
        out["pager"] = {"width": n, "pages": G, "wall_s": pager_s,
                        "launches": page, "fuse_kernel_sweeps": psweeps,
                        "fuse_kernel_windows": d("fuse.kernel.windows"),
                        "exchanges": moved, "telemetry_exchanges": tele_moved,
                        "remap": {k[len("remap.pager."):]: d(k) for k in after
                                  if k.startswith("remap.pager.")},
                        "collective_bytes":
                            d("exchange.pager.collective_bytes"),
                        "host_fetch_bytes":
                            d("exchange.pager.host_fetch_bytes")}
        del p
        release()

        # ---- every hook reached; the exporters on the card -------------
        snap = tele.snapshot()
        missing = [f for f in TELE_REQUIRED
                   if not any(k.startswith(f) and v > 0
                              for k, v in snap["counters"].items())]
        check(not missing, f"phase 37 reached no counter of {missing}")
        jsonl = tele.write_jsonl(os.path.join(tmp, "telemetry.jsonl"))
        chrome = tele.write_chrome_trace(os.path.join(tmp, "trace.json"))
        with open(jsonl) as fh:
            back = json.loads(fh.read().splitlines()[-1])
        with open(chrome) as fh:
            spans = [e for e in json.load(fh)["traceEvents"]
                     if e["ph"] == "X" and e["name"] == "chip.qft.w30"]
        check(back["counters"] == snap["counters"]
              and len(spans) == 1 and spans[0]["args"]["synced"],
              "the JSONL or Chrome trace did not load back")
        out["exporters"] = {"jsonl_bytes": os.path.getsize(jsonl),
                            "chrome_bytes": os.path.getsize(chrome),
                            "counters": len(snap["counters"]),
                            "events": len(snap["events"])}
    tele.disable()
    tele.reset()
    out["tq_launches"] = tq_launches
    out["dense_launches"] = dense
    emit(out)
    return {"dense": dense, "pager": page, "tq": tq_launches}



# ---------------------------------------------------------------------------
# phase 38: the resilience plane
# ---------------------------------------------------------------------------

class CallLog:
    """The window kernel's launches of every call of ``owner.name`` (the
    dense engine's window dispatch ``fusion.flush_window``, or
    ``QPager._dispatch_ops``), in order, from the wrappers' own counts:
    a replayed window shows as one call repeated."""

    def __init__(self, owner, name: str, wk):
        self.owner, self.name, self.wk = owner, name, wk
        self.calls = []

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)
        wk, calls = self.wk, self.calls

        def rec(*a, **k):
            l0 = sum(wk.launches().values())
            out = real(*a, **k)
            calls.append(sum(wk.launches().values()) - l0)
            return out

        setattr(self.owner, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)
        return False


def replayed_once(got: list, clean: list):
    """The index i when `got` is `clean` with call i run twice (and
    nothing else changed), else None."""
    for i in range(len(clean)):
        if got == clean[:i + 1] + clean[i:]:
            return i
    return None


def plane_digest(tensors) -> tuple:
    """Two sums over the raw bits of float32 tensors read as int64 words
    (plain and position-weighted, wrapping), on their devices 2^26 words
    at a time: a read-only stand-in for keeping a copy of 32 GiB of
    pages to compare."""
    step = 1 << 26
    out = []
    for t in tensors:
        flat = t.reshape(-1).view(torch.int64)
        w = torch.arange(step, dtype=torch.int64, device=t.device) \
            * 2654435761 + 1
        s1 = torch.zeros((), dtype=torch.int64, device=t.device)
        s2 = torch.zeros_like(s1)
        for s in range(0, flat.numel(), step):
            x = flat[s:s + step]
            s1 += x.sum()
            s2 += (x * w[:x.numel()]).sum()
        out += [s1, s2]
    return tuple(int(v) for v in out)


def resilience_phase(card: str, dev) -> dict:
    """Phase 38 (module docstring); returns its kernel launches: "dense"
    (K1/K2 of the w30 QFTs, the loud end and the engines the chain moved
    onto), "pager" (K1/K2 per page: the w32 replay and its clean twin,
    the staircase and the shrink drill while paged) and "tq" (K3-K5 of
    the w24 compressed engine before its move)."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.engines import cpu as cpu_mod
    from qrack_tpu_torch.ops import fusion as fu
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.resilience import integrity as integ
    from qrack_tpu_torch.utils.rng import QrackRandom
    from qrack_tpu_torch.utils.timing import event_ms

    t_phase = time.time()
    out = {"phase": "resilience", "card": card, "width": WIDTH,
           "sections_s": {}}
    t_lap = [t_phase]

    def lap(name: str) -> None:
        now = time.time()
        out["sections_s"][name] = now - t_lap[0]
        t_lap[0] = now
    counts = {"dense": {"in_tile": 0, "pair": 0},
              "pager": {"in_tile": 0, "pair": 0},
              "tq": {k: 0 for k in tqk.LAUNCHES}}

    def launched(kind: str, fn):
        """fn() with its K1/K2 launches added to counts[kind] ("dense" for
        kind "tq") and its K3-K5 launches to counts["tq"]; returns
        (result, the delta of `kind`'s kernels)."""
        w0, t0_ = dict(wk.launches()), dict(tqk.LAUNCHES)
        r = fn()
        sync()
        dw = {k: v - w0[k] for k, v in wk.launches().items()}
        dt = {k: v - t0_[k] for k, v in tqk.LAUNCHES.items()}
        for k, v in dw.items():
            counts["dense" if kind == "tq" else kind][k] += v
        for k, v in dt.items():
            counts["tq"][k] += v
        return r, (dt if kind == "tq" else dw)

    def events(prefix: str) -> list:
        return [e["name"] for e in tele.snapshot()["events"]
                if e["name"].startswith(prefix)]

    def plane_reset() -> None:
        faults.clear()
        res.reset_breaker()
        res.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0,
                      validate=False)
        integ.reset()
        tele.disable()
        tele.reset()

    # QEngineCPU constructions, counted at the class: none may happen
    # unless a caller names the CPU rung
    cpu_built = [0]
    real_init = cpu_mod.QEngineCPU.__init__

    def counting_init(self, *a, **k):
        cpu_built[0] += 1
        real_init(self, *a, **k)

    res.disable()
    plane_reset()
    cpu_mod.QEngineCPU.__init__ = counting_init
    release()
    try:
        # ---- off: the w30 engine QFT costs nothing more ----------------
        q = qt.create_quantum_interface("cuda", WIDTH, rng=QrackRandom(3),
                                        rand_global_phase=False)

        def qft():
            q.QFT(0, WIDTH)
            return q.device_planes

        def walls(reps: int) -> list:
            got = []
            for _ in range(reps + 1):      # one warm run first
                q.SetPermutation(PERM)
                got.append(event_ms(qft))
            return got[1:]

        def wall() -> float:
            q.SetPermutation(PERM)
            return event_ms(qft)

        phase4 = list(PHASE4_WARM)
        (off, ref), _ = launched("dense", lambda: against_reference(wall))
        ref_ms = float(np.median(ref))
        off_ms = float(np.median(off))
        rel = (off_ms - ref_ms) / ref_ms
        check(rel <= RES_DISABLED_BAR,
              f"w{WIDTH} QFT with the plane off {off_ms:.2f} ms against "
              f"the reference's median {ref_ms:.2f} ms in the same seconds "
              f"({rel:+.2%}, bar {RES_DISABLED_BAR:.0%})")
        q.SetPermutation(PERM)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with CallLog(fu, "flush_window", wk) as clean_log:
            launched("dense", qft)
        off_peak = torch.cuda.max_memory_allocated() - base
        clean = q.device_planes.clone()
        out["off"] = {"phase4_warm_ms": phase4, "reference_ms": ref,
                      "off_ms": off, "off_rel": rel,
                      "off_rel_to_phase4": (
                          off_ms / float(np.median(phase4)) - 1.0
                          if phase4 else None),
                      "peak_above_planes_gib": off_peak / 2 ** 30,
                      "window_launches": clean_log.calls}
        del q
        release()

        # ---- armed, no fault: bit for bit, the same launches -----------
        res.enable()
        q = qt.create_quantum_interface("cuda", WIDTH, rng=QrackRandom(3),
                                        rand_global_phase=False)
        check(type(q).__name__ == "ResilientEngine",
              f"the armed factory built {type(q).__name__}")
        armed, _ = launched("dense", lambda: walls(1))
        # the second rep, its windows' launches logged
        q.SetPermutation(PERM)
        with CallLog(fu, "flush_window", wk) as log:
            armed += launched("dense", lambda: [event_ms(qft)])[0]
        armed_ms = float(np.median(armed))
        check(log.calls == clean_log.calls,
              f"armed windows launched {log.calls}, unarmed "
              f"{clean_log.calls}")
        check(torch.equal(q.device_planes, clean),
              "the armed w30 QFT differs from the unarmed one")
        lap("off_and_armed")
        out["armed"] = {"armed_ms": armed, "overhead_rel":
                        (armed_ms - off_ms) / off_ms,
                        "snapshot": integ.snapshot_placement(q.engine)}

        # ---- one amp-corrupt at cuda.fuse.flush: replayed, bit exact ---
        tele.enable()
        spec = faults.inject("cuda.fuse.flush", "amp-corrupt", after_n=0,
                             times=1)
        q.SetPermutation(PERM)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with CallLog(fu, "flush_window", wk) as log:
            (wall, _) = launched("dense", lambda: event_ms(qft))
        peak = torch.cuda.max_memory_allocated() - base
        c = tele.snapshot()["counters"]
        i = replayed_once(log.calls, clean_log.calls)
        check(spec.fired == 1 and c.get("integrity.violation", 0) >= 1
              and c.get("integrity.replay.repaired", 0) == 1,
              f"w{WIDTH} replay: fired {spec.fired}, counters "
              f"{ {k: v for k, v in c.items() if k.startswith('integrity')} }")
        check(i is not None and sum(log.calls) == sum(clean_log.calls)
              + clean_log.calls[i],
              f"w{WIDTH} replay launched {log.calls} against {clean_log.calls}")
        check(torch.equal(q.device_planes, clean),
              f"the replayed w{WIDTH} QFT differs from the unarmed one")
        out["replay_w30"] = {"wall_ms": wall, "replayed_window": i,
                             "replayed_launches": clean_log.calls[i],
                             "peak_above_planes_gib": peak / 2 ** 30,
                             "violations": c.get("integrity.violation")}
        plane_reset()

        # ---- a transient raise at cuda.fuse.flush, fired twice ---------
        tele.enable()
        spec = faults.inject("cuda.fuse.flush", "raise", after_n=0, times=2)
        q.SetPermutation(PERM)
        with CallLog(fu, "flush_window", wk) as log:
            launched("dense", qft)
        retries = events("resilience.retry.cuda.fuse.flush")
        check(spec.fired == 2 and len(retries) == 2
              and log.calls == clean_log.calls,
              f"transient: fired {spec.fired}, retries {len(retries)}, "
              f"launches {log.calls}")
        check(torch.equal(q.device_planes, clean),
              "the retried w30 QFT differs from the unarmed one")
        out["transient"] = {"fired": spec.fired, "retries": len(retries)}
        plane_reset()

        # ---- the loud end at w30: no CPU rung named --------------------
        res.enable()
        q.Finish()
        before = q.engine._state_raw.clone()
        faults.inject("cuda.fuse.flush", "device-loss", after_n=0,
                      times=None)
        q.H(WIDTH - 1)
        q.H(0)
        raised = None
        try:
            q.Prob(0)
        except res.DispatchGiveUp as e:
            raised = type(e.cause).__name__
        check(raised is not None and type(q.engine).__name__ == "QEngineCUDA"
              and torch.equal(q.engine._state_raw, before)
              and cpu_built[0] == 0,
              f"w{WIDTH} loud end: raised {raised}, engine "
              f"{type(q.engine).__name__}")
        out["loud_w30"] = {"raised": f"DispatchGiveUp({raised})"}
        lap("replay_transient_loud_w30")
        del q, clean, before
        release()
        plane_reset()

        # ---- the probe: a fresh process on the card, in the background
        # from here on (the walls above are taken without it) -----------
        probe_box = {}
        probe_thread = threading.Thread(
            target=lambda: probe_box.update(r=res.run_probe(timeout_s=120.0)),
            daemon=True)
        probe_thread.start()

        # ---- the w32 pager: replay from a 32 GiB snapshot on the card --
        n, G = PAGER_WIDTH, PAGER_PAGES
        res.enable()
        A = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                        rng=QrackRandom(3),
                                        rand_global_phase=False)
        A.SetPermutation(PAGER_PERM)
        A.Finish()
        placement = integ.snapshot_placement(A.engine)
        tele.enable()
        spec = faults.inject("cuda.fuse.flush", "amp-corrupt", after_n=0,
                             times=1)
        pg.reset_flushes()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with CallLog(pg.QPager, "_dispatch_ops", wk) as alog:
            (wall_a, da) = launched("pager", lambda: event_ms(
                lambda: (A.QFT(0, n), A.page_planes)))
        peak = torch.cuda.max_memory_allocated() - base
        predicted = pg.FLUSHES["predicted_launches"]
        c = tele.snapshot()["counters"]
        check(spec.fired == 1 and c.get("integrity.violation", 0) >= 1
              and c.get("integrity.replay.repaired", 0) == 1
              and sum(da.values()) == predicted,
              f"w{n} pager replay: fired {spec.fired}, launches {da} "
              f"against the plans' {predicted}")
        plane_reset()
        res.disable()
        B = qt.create_quantum_interface("pager", n, devices=[dev] * G,
                                        rng=QrackRandom(3),
                                        rand_global_phase=False)
        B.SetPermutation(PAGER_PERM)
        with CallLog(pg.QPager, "_dispatch_ops", wk) as blog:
            (wall_b, _) = launched("pager", lambda: event_ms(
                lambda: (B.QFT(0, n), B.page_planes)))
        i = replayed_once(alog.calls, blog.calls)
        check(i is not None, f"w{n} pager replay launched {alog.calls} "
                             f"against {blog.calls}")
        same = (A.engine._qmap == B._qmap and all(
            torch.equal(a, b) for a, b in zip(A.engine._pages_raw,
                                              B._pages_raw)))
        check(same, f"the replayed w{n} pager QFT differs from the clean one")
        out["replay_w32_pager"] = {
            "pages": G, "snapshot": placement, "wall_ms": wall_a,
            "clean_wall_ms": wall_b, "replayed_window": i,
            "replayed_launches": blog.calls[i], "launches": da,
            "peak_above_planes_gib": peak / 2 ** 30}
        del B
        release()

        # ---- the loud end at w32: no shrink fits, no dense rung --------
        res.enable()
        A.Finish()
        dig = plane_digest(A.engine._pages_raw)
        qmap = list(A.engine._qmap)
        faults.inject("cuda.fuse.flush", "device-loss", after_n=0,
                      times=None)
        A.H(n - 1)
        A.H(0)
        raised = None
        try:
            A.Prob(0)
        except res.DispatchGiveUp as e:
            raised = type(e.cause).__name__
        check(raised is not None and type(A.engine).__name__ == "QPager"
              and A.engine.n_pages == G and A.engine._qmap == qmap
              and plane_digest(A.engine._pages_raw) == dig
              and cpu_built[0] == 0,
              f"w{n} loud end: raised {raised}, engine "
              f"{type(A.engine).__name__}")
        out["loud_w32_pager"] = {"raised": f"DispatchGiveUp({raised})",
                                 "digest_equal": True}
        lap("w32_pager")
        del A
        release()
        plane_reset()

        # ---- the staircase on the card: 4 -> 2 -> 1 pages -> cuda -----
        sn, sg = RES_STAIR_WIDTH, RES_STAIR_PAGES

        def stair_prefix(e):
            for t in (0, sn // 4, sn // 2, 3 * sn // 4, sn - 2, sn - 1):
                e.H(t)
                e.RZ(0.3 * (t + 1), t)
            e.CNOT(sn - 1, 3)

        res.enable()
        P = qt.create_quantum_interface("pager", sn, devices=[dev] * sg,
                                        rng=QrackRandom(3),
                                        rand_global_phase=False)
        stair_prefix(P)
        launched("pager", P.Finish)
        tele.enable()
        spec = faults.inject("pager.dispatch", "device-loss", after_n=0,
                             times=None)
        t0 = time.time()
        launched("pager", lambda: (P.INC(5, sn // 4, sn // 2), P.Finish()))
        stair_s = time.time() - t0
        moves = events("resilience.failover.")
        check(moves == ["resilience.failover.pager_to_pager_shrunk"] * 2
              + ["resilience.failover.pager_to_cuda"]
              and type(P.engine).__name__ == "QEngineCUDA"
              and spec.fired == 3,
              f"staircase: moves {moves}, engine {type(P.engine).__name__}, "
              f"fired {spec.fired}")
        _, dd = launched("dense", lambda: (P.QFT(0, sn), P.Finish()))
        check(dd["in_tile"] + dd["pair"] > 0,
              f"no K1/K2 launch on the QEngineCUDA after the move: {dd}")
        plane_reset()
        res.disable()
        R = qt.create_quantum_interface("cuda", sn, rng=QrackRandom(3),
                                        rand_global_phase=False)
        stair_prefix(R)
        R.INC(5, sn // 4, sn // 2)
        launched("dense", lambda: (R.QFT(0, sn), R.Finish()))
        f = fidelity(P.engine.device_planes, R.device_planes)
        check(f >= 1 - 1e-5, f"staircase against a clean engine: {f}")
        check(cpu_built[0] == 0,
              f"the staircase built {cpu_built[0]} CPU engines")
        out["staircase"] = {"width": sn, "pages": sg, "moves": moves,
                            "seconds": stair_s, "fidelity": f,
                            "launches_after_move": dd,
                            "cpu_engines_built": cpu_built[0]}
        lap("staircase")
        del P, R
        release()

        # ---- shrink on an exchange fault, grow back at the boundary ----
        res.enable()
        tele.enable()

        def shrink_prefix(e):
            for t in (0, sn // 6, sn // 3, sn // 2, 3 * sn // 4):
                e.H(t)
            e.CNOT(0, 1)

        S = qt.create_quantum_interface("pager", sn, devices=[dev] * sg,
                                        remap="off", rng=QrackRandom(3),
                                        rand_global_phase=False)
        shrink_prefix(S)
        launched("pager", S.Finish)
        shb.reset_exchanges()
        spec = faults.inject("pager.exchange", "raise", after_n=0, times=3)
        S.H(sn - 1)                      # a page-bit target, remap off
        launched("pager", lambda: S.Prob(0))
        shrunk_to = S.engine.n_pages
        p_top = S.Prob(sn - 1)           # the next call boundary
        grown_to = S.engine.n_pages
        exchanges = dict(shb.EXCHANGES)
        c = tele.snapshot()["counters"]
        check(spec.fired == 3 and shrunk_to == sg // 2 and grown_to == sg
              and c.get("elastic.repage.shrink") == 1
              and c.get("elastic.repage.expand") == 1
              and exchanges["global_2x2"] == 1
              and abs(p_top - 0.5) < 1e-5,
              f"shrink/grow: fired {spec.fired}, pages {shrunk_to} then "
              f"{grown_to}, exchanges {exchanges}, Prob {p_top}")
        plane_reset()
        res.disable()
        T = qt.create_quantum_interface("pager", sn, devices=[dev] * sg,
                                        remap="off", rng=QrackRandom(3),
                                        rand_global_phase=False)
        shrink_prefix(T)
        T.H(sn - 1)
        T.Finish()
        f = fidelity(torch.cat(S.engine.page_planes, dim=1),
                     torch.cat(T.page_planes, dim=1))
        check(f >= 1 - 1e-6, f"shrink/grow against a clean pager: {f}")
        out["shrink_grow"] = {"pages": [sg, shrunk_to, grown_to],
                              "exchanges": exchanges,
                              "fidelity": f}
        lap("shrink_grow")
        del S, T
        release()

        # ---- a named CPU rung at w20 -----------------------------------
        res.enable()
        tele.enable()
        ops = random_layers(range(RES_CPU_WIDTH), 2, RES_SEED)
        W = qt.create_quantum_interface("cuda", RES_CPU_WIDTH,
                                        rng=QrackRandom(7),
                                        rand_global_phase=False,
                                        failover_cpu=True)
        half = len(ops) // 2
        for _l, name, args in ops[:half]:
            getattr(W, name)(*args)
        launched("dense", W.Finish)
        built0 = cpu_built[0]
        faults.inject("cuda.fuse.flush", "raise", after_n=0, times=None)
        for _l, name, args in ops[half:]:
            getattr(W, name)(*args)
        launched("dense", lambda: W.Prob(0))
        moves = events("resilience.failover.")
        check(type(W.engine).__name__ == "QEngineCPU"
              and moves == ["resilience.failover.cuda_to_cpu"]
              and cpu_built[0] - built0 == 1,
              f"the named CPU rung: engine {type(W.engine).__name__}, "
              f"moves {moves}, CPU engines {cpu_built[0] - built0}")
        with faults.suspended():
            got = W.GetQuantumState()
        plane_reset()
        res.disable()
        o = qt.QEngineCPU(RES_CPU_WIDTH, rng=QrackRandom(7),
                          rand_global_phase=False)
        for _l, name, args in ops:
            getattr(o, name)(*args)
        want = o.GetQuantumState()
        f = float(abs(np.vdot(want, got)) ** 2)
        check(f >= 1 - 1e-5, f"the CPU rung against the oracle: {f}")
        out["cpu_rung"] = {"width": RES_CPU_WIDTH, "moves": moves,
                           "fidelity": f}
        lap("cpu_rung")
        del W, o
        release()

        # ---- TurboQuant: the precision ladder onto the dense engine ----
        res.enable()
        tele.enable()
        Q = qt.create_quantum_interface("turboquant", RES_TQ_WIDTH, bits=8,
                                        rng=QrackRandom(5),
                                        rand_global_phase=False)

        def tq_ops(e):
            e.H(0)
            e.Prob(0)              # a one-gate window: tq_gate_low (K3)
            e.T(RES_TQ_WIDTH - 4)
            e.Prob(0)              # a lone diagonal: tq_diag (K4)
            for t in range(RES_TQ_WIDTH):
                if t < 12:
                    e.H(t)
                e.RZ(0.1 * (t + 1), t)
            e.Prob(0)              # multi-op windows: tq_window (K5)

        built0 = cpu_built[0]
        _, dq = launched("tq", lambda: tq_ops(Q))
        check(all(v > 0 for v in dq.values()),
              f"K3-K5 before the move: {dq}")
        faults.inject("turboquant.dispatch", "raise", after_n=0, times=None)
        Q.H(3)
        Q.CNOT(2, 7)
        _, dmove = launched("dense", lambda: Q.Prob(3))
        moves = events("resilience.failover.")
        _, dd = launched("dense", lambda: (Q.QFT(0, RES_TQ_WIDTH), Q.Finish()))
        check(type(Q.engine).__name__ == "QEngineCUDA"
              and moves == ["resilience.failover.turboquant_to_cuda"]
              and dd["in_tile"] + dd["pair"] > 0
              and cpu_built[0] == built0,
              f"TurboQuant: engine {type(Q.engine).__name__}, moves {moves}, "
              f"K1/K2 after {dd}")
        plane_reset()
        res.disable()
        R = qt.create_quantum_interface("cuda", RES_TQ_WIDTH,
                                        rng=QrackRandom(5),
                                        rand_global_phase=False)
        tq_ops(R)
        R.H(3)
        R.CNOT(2, 7)
        R.QFT(0, RES_TQ_WIDTH)
        R.Finish()
        f = fidelity(Q.engine.device_planes, R.device_planes)
        check(f >= 0.99, f"TurboQuant's move against the dense run: {f}")
        out["turboquant"] = {"width": RES_TQ_WIDTH, "tq_launches": dq,
                             "moves": moves, "dense_after": dd,
                             "fidelity": f}
        lap("turboquant")
        del Q, R
        release()

        # ---- watchdog, breaker, probe ---------------------------------
        res.enable()
        res.configure(timeout_s=RES_HANG_S, max_retries=0)
        Hq = qt.create_quantum_interface("cuda", RES_CPU_WIDTH)
        Hq.H(0)
        Hq.Finish()
        faults.inject("cuda.device_get", "hang", after_n=0, times=None)
        t0 = time.time()
        cause = None
        try:
            Hq.GetAmplitude(0)
        except res.DispatchGiveUp as e:
            cause = e.cause
        hang_s = time.time() - t0
        check(isinstance(cause, res.DispatchTimeout)
              and hang_s <= RES_HANG_S + RES_HANG_SLACK_S,
              f"hang: {cause!r} after {hang_s:.2f} s")
        del Hq
        plane_reset()
        tele.enable()
        br = res.reset_breaker(res.CircuitBreaker(threshold=3,
                                                  cooldown_s=0.5))
        res.configure(max_retries=0)
        x = torch.ones(1 << 20, device=dev)
        calls = [0]

        def op():
            calls[0] += 1
            return x * 2.0

        faults.inject("cuda.compile", "raise", after_n=0, times=3)
        for _ in range(3):
            try:
                res.call_guarded("cuda.compile", op)
            except res.DispatchGiveUp:
                pass
        opened = br.state
        refused = False
        try:
            res.call_guarded("cuda.compile", op)
        except res.BreakerOpen:
            refused = True
        time.sleep(0.55)
        y = res.call_guarded("cuda.compile", op)
        names = events("resilience.breaker.")
        check(opened == "open" and refused and br.state == "closed"
              and calls[0] == 1 and float(y[0]) == 2.0
              and names == ["resilience.breaker.trip",
                            "resilience.breaker.half_open",
                            "resilience.breaker.close"],
              f"breaker: {opened}, refused {refused}, calls {calls[0]}, "
              f"events {names}")
        plane_reset()
        lap("hang_breaker")
        probe_thread.join(150.0)
        probe = probe_box.get("r")
        check(probe is not None and probe.ok,
              f"probe: {probe.output[-400:] if probe else 'no result'}")
        out.update({"hang_s": hang_s, "breaker_events": names,
                    "probe_s": probe.duration_s,
                    "cpu_engines_built": cpu_built[0],
                    "launches": counts})
    finally:
        cpu_mod.QEngineCPU.__init__ = real_init
        res.disable()
        plane_reset()
        res.configure()
        release()
    out["seconds"] = time.time() - t_phase
    out["budget_s"] = RES_PHASE_S
    emit(out)
    return counts


# ---------------------------------------------------------------------------
# the checkpoint plane (phase 39)
# ---------------------------------------------------------------------------

def ckpt_tail(q, n: int, seed: int) -> None:
    """A fixed seeded tail of H, T and CNOT gates: 3n of them."""
    rng = np.random.default_rng(seed)
    for _ in range(3 * n):
        k, t = int(rng.integers(0, 3)), int(rng.integers(0, n))
        if k == 0:
            q.H(t)
        elif k == 1:
            q.T(t)
        else:
            q.CNOT(t, (t + 1 + int(rng.integers(0, n - 1))) % n)


def ckpt_dir(nbytes: int) -> str:
    """A fresh directory for the phase's files under QRACK_SMOKE_TMP, else
    the system's temporary directory; raises naming it when its free
    space is under CKPT_ROOM times the `nbytes` written at once."""
    import shutil
    import tempfile

    root = os.environ.get("QRACK_SMOKE_TMP") or tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    check(free >= CKPT_ROOM * nbytes,
          f"{root} has {free} bytes free; phase 39 writes {nbytes} at once "
          f"and needs {CKPT_ROOM}x that (set QRACK_SMOKE_TMP to a "
          "directory on a larger local disk)")
    return tempfile.mkdtemp(prefix="qrack-ckpt-", dir=root)


def gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9 if seconds > 0 else float("inf")


def checkpoint_phase(card: str, dev) -> dict:
    """Phase 39 (module docstring); returns its kernel launches: "dense"
    (K1/K2 of the w30 engines, the w24 stack's units and the engine the
    failover chain moved onto), "pager" (K1/K2 per page of the w28 and
    w20 pagers) and "tq" (K3-K5 of the w28 compressed engines)."""
    import shutil

    import qrack_tpu_torch as qt
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.checkpoint import container as ckc
    from qrack_tpu_torch.checkpoint import registry as reg
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.utils.rng import QrackRandom

    t_phase = time.time()
    out = {"phase": "checkpoint", "card": card, "sections_s": {}}
    t_lap = [t_phase]

    def lap(name: str) -> None:
        now = time.time()
        out["sections_s"][name] = now - t_lap[0]
        t_lap[0] = now
    counts = {"dense": {"in_tile": 0, "pair": 0},
              "pager": {"in_tile": 0, "pair": 0},
              "tq": {k: 0 for k in tqk.LAUNCHES}}

    def launched(kind: str, fn):
        """fn() with its K1/K2 launches added to counts[kind] and its K3-K5
        launches to counts["tq"]; returns (result, the K1/K2 delta)."""
        w0, t0_ = dict(wk.launches()), dict(tqk.LAUNCHES)
        r = fn()
        sync()
        dw = {k: v - w0[k] for k, v in wk.launches().items()}
        for k, v in dw.items():
            counts[kind][k] += v
        for k, v in tqk.LAUNCHES.items():
            counts["tq"][k] += v - t0_[k]
        return r, dw

    def held_first(label: str, fn):
        """fn() with the first in-tile and the first pair launch of its
        K1/K2 held to plain (SweepProbe: kernel and plain version on the
        same input, timed, at the bar of phase 2)."""
        p = SweepProbe(wk)
        p.label, p.every = label, 1 << 62
        with p:
            r = fn()
        sync()
        for name in ("in_tile", "pair"):
            s = p.stats.get(name)
            check(s is not None and s["launches"] == 1,
                  f"{label}: no {name} launch held to plain ({p.stats})")
        out.setdefault("held", {})[label] = {
            name: {k: p.stats[name][k] for k in
                   ("ms", "plain_ms", "bound_ms", "max_abs_err",
                    "max_rel_err")} for name in ("in_tile", "pair")}
        return r

    release()
    # the larger file at once: the dense planes' or the pager's
    # complex128 pages
    tmp = ckpt_dir(max(2 * 4 * (1 << CKPT_DENSE_WIDTH),
                       16 * (1 << CKPT_PAGER_WIDTH)) + (1 << 20))
    out["dir"] = tmp
    try:
        # ---- a. the float32 dense engine: save, load into a fresh one ----
        n = CKPT_DENSE_WIDTH
        a = qt.create_quantum_interface("cuda", n, init_state=PERM,
                                        rng=QrackRandom(CKPT_SEED),
                                        rand_global_phase=False)
        launched("dense", lambda: (a.QFT(0, n), a.Finish()))
        digest = plane_digest([a.device_planes])
        path = os.path.join(tmp, "dense.qckpt")
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        snap = reg.capture(a)           # save_state = capture + save_snapshot
        cap_s = time.perf_counter() - t0
        raw = sum(x.nbytes for x in snap["arrays"].values())
        nbytes = reg.save_snapshot(snap, path)
        save = dict(ckc.LAST_SAVE)
        save_peak = torch.cuda.max_memory_allocated() - base
        del snap
        check(plane_digest([a.device_planes]) == digest,
              f"the capture changed the w{n} planes")
        b = qt.create_quantum_interface("cuda", n, rng=QrackRandom(991),
                                        rand_global_phase=False)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        snap = reg.load_snapshot(path)  # load_state = load_snapshot + ...
        load = dict(ckc.LAST_LOAD)
        t0 = time.perf_counter()
        reg.restore_into(b, snap)       # ... restore_into (or build)
        sync()
        up_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() - base
        del snap
        os.unlink(path)
        for peak, what in ((save_peak, "save"), (load_peak, "load")):
            check(peak <= CKPT_MEM_BAR,
                  f"w{n} {what} took {peak} bytes of device memory above "
                  f"the planes (bar {CKPT_MEM_BAR})")
        check(b.dtype == torch.float32 and b.device.type == "cuda",
              f"the w{n} load landed as {b.dtype} on {b.device}")

        def cont(q):
            q.IQFT(0, n)
            ckpt_tail(q, n, CKPT_SEED)
            q.Finish()
        launched("dense", lambda: cont(a))
        _, dw = launched("dense", lambda: held_first(
            f"w{n} continuation", lambda: cont(b)))
        check(dw["in_tile"] > 0 and dw["pair"] > 0,
              f"the w{n} continuation skipped a kernel entry point: {dw}")
        check(torch.equal(a.device_planes, b.device_planes),
              f"the w{n} continuation from the file differs from the live "
              "engine's")
        ma, mb = a.MAll(), b.MAll()
        check(ma == mb, f"w{n} MAll {ma} against {mb} from the file")
        out["dense"] = {
            "width": n, "file_bytes": nbytes, "planes_bytes": raw,
            "capture_ms": cap_s * 1e3, "capture_gbps": gbps(raw, cap_s),
            # the digests run on threads beside the write and the read:
            # their own ms, and the wait for them past the write/read
            "hash_ms": save["hash_s"] * 1e3,
            "hash_gbps": gbps(raw, save["hash_s"]),
            "hash_wait_ms": save["hash_wait_s"] * 1e3,
            "write_ms": save["write_s"] * 1e3,
            "write_gbps": gbps(nbytes, save["write_s"]),
            "read_ms": load["read_s"] * 1e3,
            "read_gbps": gbps(nbytes, load["read_s"]),
            "load_hash_ms": load["hash_s"] * 1e3,
            "load_hash_gbps": gbps(raw, load["hash_s"]),
            "load_hash_wait_ms": load["hash_wait_s"] * 1e3,
            "upload_ms": up_s * 1e3, "upload_gbps": gbps(raw, up_s),
            "save_peak_above_planes_gib": save_peak / 2 ** 30,
            "load_peak_above_planes_gib": load_peak / 2 ** 30,
            "mall": ma}
        del a, b
        release()
        lap(f"dense_w{n}")

        # ---- b. w26 pager on 4 pages: into 4, build, into 2 ------------
        n = CKPT_PAGER_WIDTH

        def pager(pages: int, seed: int):
            return qt.create_quantum_interface(
                "pager", n, devices=[dev] * pages, rng=QrackRandom(seed),
                rand_global_phase=False)
        p = pager(CKPT_PAGER_PAGES, CKPT_SEED)
        p.SetPermutation(CKPT_PAGER_PERM)

        def prefix():
            p.QFT(0, n)
            for t in range(n - 4, n):
                p.H(t)
            p.Finish()
        launched("pager", prefix)
        check(p._map_nonid(), f"the w{n} prefix left the placement table "
                              "identity")
        path = os.path.join(tmp, "pager.qckpt")
        nbytes = reg.save_state(p, path)
        psave = dict(ckc.LAST_SAVE)
        qmap = list(p._qmap)

        def pcont(q):
            q.IQFT(0, n)
            ckpt_tail(q, n, CKPT_SEED + 1)
            q.Finish()
        launched("pager", lambda: pcont(p))
        loads = {}
        # the into-4 load and the build share one read and hash of the
        # file (load_snapshot); the into-2 load reads it again
        t0 = time.perf_counter()
        shared = reg.load_snapshot(path)
        loads["shared_read"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                **ckc.LAST_LOAD}

        def load(label: str, into=None, snap=None):
            t0 = time.perf_counter()
            if snap is None:
                q = reg.load_state(path, into=into)
                read = dict(ckc.LAST_LOAD)
            else:
                q = (reg.restore_into(into, snap) if into is not None
                     else reg.build(snap))
                read = {"shared_read": True}
            loads[label] = {"ms": (time.perf_counter() - t0) * 1e3, **read}
            check(q.devices == [p.devices[0]] * q.n_pages,
                  f"the {label} pager landed on {q.devices}")
            return q

        def same(q, label: str) -> None:
            check(q.n_pages == CKPT_PAGER_PAGES and q._qmap == p._qmap
                  and all(torch.equal(x, y) for x, y in
                          zip(p._pages_raw, q._pages_raw)),
                  f"the w{n} {label} continuation differs from the live "
                  "pager's")
        q4 = load("into_4", pager(CKPT_PAGER_PAGES, 991), shared)
        check(q4._qmap == qmap, f"the w{n} load lost the placement table")
        launched("pager", lambda: held_first(f"w{n} pager continuation",
                                             lambda: pcont(q4)))
        same(q4, "into_4")
        qb = load("build", snap=shared)
        del shared
        check(qb.n_pages == CKPT_PAGER_PAGES and qb._qmap == qmap,
              f"the w{n} build holds {qb.n_pages} pages")
        launched("pager", lambda: pcont(qb))
        same(qb, "build")
        mp, m4 = p.MAll(), q4.MAll()
        check(mp == m4, f"w{n} pager MAll {mp} against {m4} from the file")
        loads["mall"] = mp
        q2 = load("into_2", pager(2, 992))
        launched("pager", lambda: pcont(q2))
        # against the build's pages (equal to the live pager's), both in
        # logical order
        qb._unmap()
        q2._unmap()
        fid = fidelity(torch.cat(qb._pages_raw, dim=1),
                       torch.cat(q2._pages_raw, dim=1))
        check(fid >= 1 - 1e-6, f"w{n} 4 -> 2-page load: fidelity {fid} "
                               "after the continuation")
        loads["into_2"]["fidelity"] = fid
        del q2
        os.unlink(path)
        out["pager"] = {"width": n, "pages": CKPT_PAGER_PAGES,
                        "file_bytes": nbytes,
                        "hash_ms": psave["hash_s"] * 1e3,
                        "hash_wait_ms": psave["hash_wait_s"] * 1e3,
                        "write_ms": psave["write_s"] * 1e3, "loads": loads}
        del p, q4, qb
        release()
        lap(f"pager_w{n}")

        # ---- c. w28 int8 TurboQuant: codes bit for bit ------------------
        n = CKPT_TQ_WIDTH
        t = qt.create_quantum_interface("turboquant", n, bits=8,
                                        init_state=PERM,
                                        rng=QrackRandom(CKPT_SEED),
                                        rand_global_phase=False)
        launched("dense", lambda: (t.QFT(0, n), t.Finish()))
        path = os.path.join(tmp, "tq.qckpt")
        codes, scales = t.host_codes()
        nbytes = reg.save_state(t, path)
        u = reg.load_state(path)
        os.unlink(path)
        uc, us = u.host_codes()
        check(np.array_equal(uc, codes) and np.array_equal(us, scales),
              f"the w{n} TurboQuant load differs from the saved codes")
        del codes, scales, uc, us

        def tcont(q):
            q.H(3)
            q.Prob(3)            # a one-gate window: tq_gate_low (K3)
            q.T(2)
            q.Prob(2)            # a lone diagonal: tq_diag (K4)
            q.IQFT(0, n)         # multi-op windows: tq_window (K5)
            ckpt_tail(q, n, CKPT_SEED + 2)
            q.Finish()
        for q in (t, u):
            launched("dense", lambda: tcont(q))
        tc_, ts_ = t.host_codes()
        uc, us = u.host_codes()
        check(np.array_equal(tc_, uc) and np.array_equal(ts_, us),
              f"the w{n} TurboQuant continuation from the file differs "
              "from the live engine's")
        check(all(v > 0 for v in counts["tq"].values()),
              f"the w{n} TurboQuant runs skipped a kernel: {counts['tq']}")
        out["turboquant"] = {"width": n, "bits": 8, "file_bytes": nbytes}
        del t, u, tc_, ts_, uc, us
        release()
        lap("turboquant_w28")

        # ---- d. the "optimal" stack at w24 ------------------------------
        n = CKPT_STACK_WIDTH

        def stack(seed: int):
            return qt.create_quantum_interface("optimal", n,
                                               rng=QrackRandom(seed),
                                               rand_global_phase=False)
        s = stack(CKPT_SEED)

        def sprefix():
            s.H(0)
            for q_ in range(n - 1):
                s.CNOT(q_, q_ + 1)
            for q_ in range(0, n, 5):
                s.T(q_)
                s.RY(0.3 + 0.1 * q_, q_)
            # the shards of the non-Clifford gates meet a CNOT: the
            # tableau switches to the dense engine on the card
            s.CNOT(0, 5)
            s.H(5)
            s.CNOT(5, 1)
            s.CNOT(n - 1, 0)
            s.Finish()
        launched("dense", sprefix)
        units = cuda_engines(s)
        check(units and all(e.device.type == "cuda" for e in units),
              f"the w{n} stack put no unit on the card")
        path = os.path.join(tmp, "stack.qckpt")
        nbytes = reg.save_state(s, path)
        s2 = reg.load_state(path, into=stack(991))
        os.unlink(path)
        check(all(e.device.type == "cuda" for e in cuda_engines(s2)),
              f"the w{n} stack's load left a unit off the card")

        def scont(q):
            q.H(n - 1)
            q.CNOT(n - 1, 3)
            q.T(3)
            q.CNOT(2, n - 2)
            q.Finish()
        for q in (s, s2):
            launched("dense", lambda: scont(q))
        check(np.array_equal(s.GetQuantumState(), s2.GetQuantumState()),
              f"the w{n} stack's continuation from the file differs")
        ma, mb = s.MAll(), s2.MAll()
        check(ma == mb, f"w{n} stack MAll {ma} against {mb}")
        out["stack"] = {"width": n, "file_bytes": nbytes,
                        "cuda_units": len(units)}
        del s, s2
        release()
        lap("stack_w24")

        # ---- e. the failover snapshot file at w20 -----------------------
        n = CKPT_FAILOVER_WIDTH
        fdir = os.path.join(tmp, "failover")
        os.environ["QRACK_TPU_FAILOVER_PERSIST"] = fdir
        try:
            res.enable()
            res.configure(max_retries=0, backoff_s=0.0)
            res.reset_breaker()
            tele.enable()
            tele.reset()
            f = qt.create_quantum_interface("pager", n, devices=[dev] * 2,
                                            rng=QrackRandom(CKPT_SEED),
                                            rand_global_phase=False)
            f.SetPermutation(CKPT_FAILOVER_PERM)
            launched("pager", lambda: (f.QFT(0, n), f.Finish()))
            before = f.GetQuantumState()
            faults.inject("pager.device_get", "raise", after_n=0,
                          times=None)
            amp = f.GetAmplitude(5)
            faults.clear()
            check(type(f.engine).__name__ == "QEngineCUDA",
                  f"the w{n} chain ended on {type(f.engine).__name__}")
            check(amp == before[5], f"w{n} read after the moves {amp} "
                                    f"against {before[5]}")
            files = sorted(os.listdir(fdir))
            c = tele.snapshot()["counters"]
            moves = c.get("resilience.failovers", 0)
            check(len(files) == moves == 2,
                  f"{len(files)} snapshot files for {moves} moves: {files}")
            for name in files:
                back = reg.load_state(os.path.join(fdir, name))
                check(np.array_equal(back.GetQuantumState(), before),
                      f"{name} differs from the ket before the call")
                del back
            launched("dense", lambda: (f.QFT(0, n), f.Finish()))
            # a poisoned ket: the capture is refused, no file written
            g = qt.create_quantum_interface("pager", n, devices=[dev] * 2,
                                            rng=QrackRandom(CKPT_SEED),
                                            rand_global_phase=False)
            g.H(0)
            g.Finish()
            g.engine._pages_raw[1][0, 7] = float("nan")
            shutil.rmtree(fdir)
            faults.inject("pager.device_get", "nan-poison", after_n=0,
                          times=None)
            try:
                g.GetAmplitude(0)
            except res.FAILOVER_ERRORS:
                pass
            faults.clear()
            c = tele.snapshot()["counters"]
            rejected = c.get("resilience.failover.persist_rejected", 0)
            check(rejected >= 1, "the poisoned ket's capture was not "
                                 "rejected")
            check(not os.path.exists(fdir) or not os.listdir(fdir),
                  "a poisoned ket's snapshot was written")
            out["failover"] = {"width": n, "files": len(files),
                               "moves": moves, "rejected": rejected,
                               "events": [e["name"] for e in
                                          tele.snapshot()["events"]
                                          if e["name"].startswith(
                                              "resilience.failover")]}
            del f, g
        finally:
            os.environ.pop("QRACK_TPU_FAILOVER_PERSIST", None)
            faults.clear()
            res.disable()
            res.reset_breaker()
            res.configure()
            tele.disable()
            tele.reset()
        release()
        lap("failover_w20")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = counts
    out["seconds"] = time.time() - t_phase
    out["budget_s"] = CKPT_PHASE_S
    emit(out)
    return counts

def route_bricks(n: int, dev) -> tuple:
    """(layers, widest cone, [(layers, widest cone width, its stack)]):
    the deepest brickwork_qcircuit(n, layers) of ROUTE_WIDE_LAYERS whose
    widest single-qubit cone (the middle qubit's) the router still sends
    to the dense rung at its own width."""
    from qrack_tpu_torch.lightcone.engine import compact_over
    from qrack_tpu_torch.models.algorithms import brickwork_qcircuit
    from qrack_tpu_torch.route import decide

    seen, best = [], None
    for layers in ROUTE_WIDE_LAYERS:
        compact, _ = compact_over(brickwork_qcircuit(n, layers), (n // 2,))
        stack = decide(compact, compact.qubit_count).stack
        seen.append((layers, compact.qubit_count, stack))
        if stack == "dense":
            best = (layers, compact.qubit_count)
    check(best is not None, f"no brickwork depth keeps a dense cone: {seen}")
    return best[0], best[1], seen


def draw_repeats(fn, reps: int) -> int:
    """Distinct results of `reps` calls of fn() (each a hashable)."""
    return len({fn() for _ in range(reps)})


def route_phase(card: str, dev) -> dict:
    """Phase 40 (module docstring); returns its kernel launches: "dense"
    (K1/K2 by plane dtype: the routed and direct w30 engines, every dense
    cone, the escalated w24 engine, the repeat checks' w20 engines and
    the routed w20 sessions) and "tq" (K3-K5 of the routed w30 QFT)."""
    import math
    import shutil

    import qrack_tpu_torch as qt
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.checkpoint import load_state, save_state
    from qrack_tpu_torch.layers.qcircuit import QCircuit
    from qrack_tpu_torch.models.algorithms import (brickwork_qcircuit,
                                                   brickwork_theta,
                                                   ghz_qcircuit)
    from qrack_tpu_torch.models.qft import basis_planes, qft_qcircuit
    from qrack_tpu_torch.noise import trajectories as traj
    from qrack_tpu_torch.ops import gatekernels as gk
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.route import MisrouteError
    from qrack_tpu_torch.route import cost
    from qrack_tpu_torch.utils.rng import QrackRandom

    t_phase = time.time()
    out = {"phase": "route", "card": card, "sections_s": {}}
    t_lap = [t_phase]

    def lap(name: str) -> None:
        now = time.time()
        out["sections_s"][name] = now - t_lap[0]
        t_lap[0] = now
    counts = {"dense": {dt: {"in_tile": 0, "pair": 0}
                        for dt in wk.DTYPE_LAUNCHES},
              "tq": {k: 0 for k in tqk.LAUNCHES}}

    def launched(fn):
        """fn() with its K1/K2 launches (by dtype) and K3-K5 launches
        added to counts; returns (result, K1/K2 delta, K3-K5 delta)."""
        w0 = {dt: dict(c) for dt, c in wk.DTYPE_LAUNCHES.items()}
        t0_ = dict(tqk.LAUNCHES)
        r = fn()
        sync()
        dw = {"in_tile": 0, "pair": 0}
        for dt, c in wk.DTYPE_LAUNCHES.items():
            for k, v in c.items():
                counts["dense"][dt][k] += v - w0[dt][k]
                dw[k] += v - w0[dt][k]
        dt_ = {k: v - t0_[k] for k, v in tqk.LAUNCHES.items()}
        for k, v in dt_.items():
            counts["tq"][k] += v
        return r, dw, dt_

    def fresh(layers, n, **kw):
        return qt.create_quantum_interface(layers, n,
                                           rng=QrackRandom(ROUTE_SEED),
                                           rand_global_phase=False, **kw)

    saved_env = {k: os.environ.pop(k, None) for k in
                 ("QRACK_ROUTE", "QRACK_ROUTE_DENSE_MAX_QB",
                  "QRACK_ROUTE_HBM_BYTES")}
    release()
    try:
        # ---- a. the w28 QFT under the default knobs: TurboQuant -------
        n = ROUTE_TQ_WIDTH
        circ = qft_qcircuit(n)
        _free, total = torch.cuda.mem_get_info()
        budget = cost.hbm_budget_bytes(cost.RouteKnobs.for_device(dev))
        check(budget == total, f"the route budget {budget} is not the "
                               f"card's memory {total}")
        t0 = time.perf_counter()
        r = fresh("route", n, init_state=PERM)
        _, dw, dtq = launched(lambda: (circ.RunFused(r), r.Finish()))
        wall = time.perf_counter() - t0
        check(r.current_stack() == "turboquant"
              and r._decision.layers == ("turboquant",),
              f"the w{n} QFT routed to {r._decision}")
        check(sum(dtq.values()) > 0,
              f"the routed w{n} QFT launched no TurboQuant kernel: {dtq}")
        rng = np.random.default_rng(ROUTE_SEED)
        ks = [int(k) for k in rng.integers(0, (1 << n) // 4096,
                                           ROUTE_TQ_PAGES) * 4096]
        got = np.concatenate([r.GetAmplitudePage(k, 4096) for k in ks])
        want = np.concatenate([[qft_closed_form(PERM, k + j, n)
                                for j in range(4096)] for k in ks])
        f_cf = float(abs(np.vdot(want, got)) ** 2
                     / (np.vdot(want, want).real * np.vdot(got, got).real))
        check(f_cf >= ROUTE_TQ_BAR,
              f"routed w{n} TurboQuant QFT against the closed form: "
              f"fidelity {f_cf} (bar {ROUTE_TQ_BAR})")
        out["a_turboquant"] = {
            "width": n, "stack": r.current_stack(),
            "layers": list(r._decision.layers),
            "budget_bytes": budget,
            "turboquant_bytes": cost.hbm_bytes("turboquant",
                                               cost._WidthOnly(n)),
            "wall_s": wall, "tq_launches": dtq, "k1k2_launches": dw,
            "closed_form_fidelity": f_cf,
            "closed_form_amps": 4096 * len(ks)}
        del r
        release()
        lap(f"a_turboquant_w{n}")

        # ---- b. QRACK_ROUTE_DENSE_MAX_QB=30: dense, as a direct engine --
        n = WIDTH
        circ = qft_qcircuit(n)
        os.environ["QRACK_ROUTE_DENSE_MAX_QB"] = str(n)
        t0 = time.perf_counter()
        plan = fresh("route", n, init_state=PERM).plan(circ)
        plan_ms = (time.perf_counter() - t0) * 1e3
        check(plan.stack == "dense" and plan.layers == ("cuda",),
              f"the pinned w{n} QFT planned {plan}")
        walls, deltas, planes = [], [], []
        # direct, routed, direct: both walls include construction
        for layers in ("cuda", "route", "cuda"):
            t0 = time.perf_counter()
            q = fresh(layers, n, init_state=PERM)
            _, dw, _t = launched(lambda: (circ.RunFused(q), q.device_planes))
            walls.append((time.perf_counter() - t0) * 1e3)
            deltas.append(dw)
            planes.append(q.device_planes)
            del q
            if len(planes) == 3:
                planes[2] = torch.equal(planes[0], planes[2])
        del os.environ["QRACK_ROUTE_DENSE_MAX_QB"]
        check(deltas[0] == deltas[1] == deltas[2]
              and sum(deltas[1].values()) > 0 and planes[2],
              f"routed w{n} K1/K2 launches {deltas[1]} against the "
              f"direct engine's {deltas[0]}, {deltas[2]}")
        same = torch.equal(planes[1], planes[0])
        err = 0.0 if same else held_to_plain(
            planes[1], planes[0], f"routed w{n} dense")[0]
        out["b_dense"] = {"width": n, "launches": deltas[1],
                          "bit_for_bit": same, "max_abs_diff": err,
                          "routed_wall_ms": walls[1],
                          "direct_wall_ms": [walls[0], walls[2]],
                          "admission_ms": walls[1] - min(walls[0],
                                                         walls[2]),
                          "plan_ms": plan_ms}
        del planes
        release()
        lap("b_dense_w30")

        # ---- c. the w100 GHZ: stabilizer, no kernel --------------------
        n = ROUTE_GHZ
        results = []
        for k in range(4):
            g = qt.create_quantum_interface(
                "route", n, rng=QrackRandom(ROUTE_SEED + k))
            _, dw, dtq = launched(lambda: ghz_qcircuit(n).Run(g))
            check(g.current_stack() == "stabilizer",
                  f"the w{n} GHZ routed to {g.current_stack()}")
            results.append(g.MAll())
            check(sum(dw.values()) + sum(dtq.values()) == 0,
                  f"the w{n} GHZ launched a kernel: {dw} {dtq}")
        check(all(m in (0, (1 << n) - 1) for m in results),
              f"w{n} GHZ MAll results disagree within: {results}")
        out["c_ghz"] = {"width": n, "stack": "stabilizer",
                        "mall_all_ones": [m != 0 for m in results]}
        lap("c_ghz_w100")

        # ---- d. the README's w50 brickwork through "route" -------------
        tele.enable()
        tele.reset()
        n = ROUTE_LC_WIDTH
        r = fresh("route", n)
        brickwork_qcircuit(n).Run(r)
        check(r.current_stack() == "lightcone",
              f"the w{n} brickwork routed to {r.current_stack()}")
        t0 = time.perf_counter()
        probs, dw, _t = launched(lambda: [r.Prob(q) for q in range(n)])
        first_s = time.perf_counter() - t0
        c1 = dict(tele.snapshot()["counters"])
        t0 = time.perf_counter()
        again, dw2, _t = launched(lambda: [r.Prob(q) for q in range(n)])
        second_s = time.perf_counter() - t0
        c = tele.snapshot()["counters"]
        tele.disable()
        tele.reset()
        hits = c.get("lightcone.cache.hit", 0) - c1.get(
            "lightcone.cache.hit", 0)
        check(again == probs, f"the w{n} second pass read other values")
        check(dw2 == {"in_tile": 0, "pair": 0} and hits == n
              and c["lightcone.cache.miss"] == c1["lightcone.cache.miss"],
              f"the w{n} second pass rebuilt a cone: {dw2} {c1} {c}")
        check(sum(dw.values()) > 0, f"the w{n} cones launched no kernel")
        stacks = sorted({e.current_stack() for e in r._engine._cones.values()})
        rc = fresh("route", n, device="cpu")
        brickwork_qcircuit(n).Run(rc)
        cpu = [rc.Prob(q) for q in range(n)]
        d_cpu = max(abs(a - b) for a, b in zip(probs, cpu))
        d_cf = max(abs(p - math.sin(brickwork_theta(q) / 2.0) ** 2)
                   for q, p in enumerate(probs))
        check(d_cpu <= 1e-6 and d_cf <= 1e-6,
              f"w{n} Prob reads off the CPU cones by {d_cpu}, off the "
              f"closed form by {d_cf}")
        out["d_lightcone_w50"] = {
            "width": n, "reads": n, "cone_stacks": stacks,
            "widest_cone": max(len(k[0]) for k in r._engine._cones),
            "launches": dw, "reads_per_s": n / first_s,
            "cached_reads_per_s": n / second_s,
            "cache_misses_first_pass": c1["lightcone.cache.miss"],
            "cache_hits_second_pass": hits,
            "max_diff_to_cpu": d_cpu, "max_diff_to_closed_form": d_cf}
        del r, rc
        release()
        lap("d_lightcone_w50")

        # ---- e. a w100 brickwork on "lightcone", dense cones -----------
        n = ROUTE_WIDE
        layers, widest, seen = route_bricks(n, dev)
        lc = fresh("lightcone", n)
        brickwork_qcircuit(n, layers).Run(lc)
        sync()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        probs, dw, _t = launched(lambda: [lc.Prob(q % n)
                                          for q in range(ROUTE_WIDE_READS)])
        read_s = time.perf_counter() - t0
        cache = torch.cuda.memory_allocated() - base
        cones = lc._cones
        by_width = {}
        for (order, _digest), e in cones.items():
            check(e.current_stack() == "dense",
                  f"a w{len(order)} cone routed to {e.current_stack()}")
            by_width[len(order)] = by_width.get(len(order), 0) + 1
        check(max(by_width) == widest, f"widest cone {max(by_width)}, "
                                       f"predicted {widest}")
        d_cf = max(abs(p - math.sin(brickwork_theta(q) / 2.0) ** 2)
                   for q, p in enumerate(probs))
        check(d_cf <= 1e-6, f"w{n} brickwork reads off the closed form "
                            f"by {d_cf}")
        replays = []
        for q in range(0, n, ROUTE_REPLAY_EVERY):
            compact, order = lc._slice((q,))
            eng = cones[(tuple(order), compact.structure_digest())]
            m = compact.qubit_count
            plain = compact.compile_fn(m)(basis_planes(m, 0, device=dev))
            err, rel = held_to_plain(eng.device_planes, plain,
                                     f"w{m} cone of qubit {q}")
            replays.append({"qubit": q, "width": m, "max_abs_diff": err})
        out["e_lightcone_w100"] = {
            "width": n, "brick_layers": layers, "depths_tried": seen,
            "reads": ROUTE_WIDE_READS, "cones": len(cones),
            "cones_by_width": by_width, "launches": dw,
            "reads_per_s": ROUTE_WIDE_READS / read_s,
            "cache_bytes": cache, "max_diff_to_closed_form": d_cf,
            "plain_replays": replays}
        del lc, cones
        release()
        lap("e_lightcone_w100")

        # ---- f. a misroute: escalated once; a refusal ------------------
        tele.enable()
        tele.reset()
        n = ROUTE_MISROUTE_WIDTH
        hard = QCircuit(n)
        hard.append_1q(0, mat.u3_mtrx(0.3, 0.1, 0.2))
        hard.append_ctrl((1,), 2, mat.u3_mtrx(0.7, 0.4, 0.5), 1)
        again = QCircuit(n)
        for q in range(0, n, 3):
            again.append_1q(q, mat.u3_mtrx(0.9, 0.2, 0.1 * q))
            again.append_ctrl((q,), (q + 1) % n, mat.X2, 1)
        r = fresh("route", n)
        d = fresh("cuda", n)
        ghz_qcircuit(n).Run(r)
        check(r.current_stack() == "stabilizer",
              f"the w{n} GHZ routed to {r.current_stack()}")
        for circ_ in (hard, again):
            launched(lambda: circ_.Run(r))
        check(r.current_stack() == "dense" and r._escalated,
              f"the w{n} misroute left the stack {r.current_stack()}")
        for circ_ in (ghz_qcircuit(n), hard, again):
            launched(lambda: circ_.Run(d))
        f_esc = fidelity(r.device_planes, d.device_planes)
        c = tele.snapshot()["counters"]
        check(c.get("route.misroute.escalated") == 1
              and c.get("route.misroutes") == 1,
              f"the w{n} misroute escalated "
              f"{c.get('route.misroute.escalated')} times")
        check(f_esc >= 1 - 1e-6, f"the escalated w{n} state against the "
                                 f"direct engine: fidelity {f_esc}")
        del r, d
        w = ROUTE_REFUSED_WIDTH
        g = fresh("route", w)
        ghz_qcircuit(w).Run(g)
        wide = QCircuit(w)
        wide.append_1q(0, mat.u3_mtrx(0.3, 0.1, 0.2))
        try:
            wide.Run(g)
            refused = False
        except MisrouteError:
            refused = True
        amp = complex(g.GetAmplitude(0))
        check(refused and g.current_stack() == "stabilizer"
              and abs(abs(amp) - 2 ** -0.5) < 1e-9,
              f"the w{w} general circuit was not refused cleanly "
              f"({refused}, {g.current_stack()}, {amp})")
        tele.disable()
        tele.reset()
        out["f_misroute"] = {"width": n, "escalated": 1,
                             "fidelity_to_direct": f_esc,
                             "refused_width": w}
        del g
        release()
        lap("f_misroute")

        # ---- g. repeatable draws: MultiShotMeasureMask and the rest ----
        n = ROUTE_REPEAT_WIDTH
        powers = [1 << b for b in range(n)]
        u_host = np.random.default_rng(ROUTE_SEED).random(ROUTE_SHOTS)
        bits = torch.arange(n, device=dev)
        draws = {}
        for dtype in ("float32", "float64", "bfloat16", "float16"):
            q = fresh("cuda", n, dtype=dtype, init_state=PERM % (1 << n))
            launched(lambda: (q.QFT(0, n), [q.T(t) for t in range(0, n, 3)],
                              q.CNOT(n - 1, 0), q.H(n // 2), q.Finish()))
            st = q._state
            u = torch.as_tensor(u_host, dtype=st.dtype, device=dev)
            old = draw_repeats(lambda: tuple(gk.cumsum_mask_keys(
                st, u, bits).cpu().tolist()), ROUTE_REPEATS)

            def new():
                q.rng.seed(ROUTE_SEED)
                return tuple(sorted(q.MultiShotMeasureMask(
                    powers, ROUTE_SHOTS).items()))
            new_n = draw_repeats(new, ROUTE_REPEATS)
            # the trajectories' terminal draw on a batch of 8 such kets
            batch = torch.stack([st] * 8)
            ub = torch.as_tensor(u_host[:8], device=dev)
            readout = draw_repeats(lambda: tuple(traj.readout(
                batch, ub)[1].cpu().tolist()), ROUTE_REPEATS)
            check(new_n == 1, f"{dtype} MultiShotMeasureMask drew "
                              f"{new_n} key sets in {ROUTE_REPEATS} calls")
            draws[dtype] = {"cumsum_distinct": old,
                            "multishot_distinct": new_n,
                            "traj_readout_distinct": readout}
            del q, st, batch
        lc = fresh("lightcone", ROUTE_LC_REPEAT)
        brickwork_qcircuit(ROUTE_LC_REPEAT).Run(lc)

        def lc_draw():
            # the draw is the cone engine's, from its own stream
            for cone in lc._cones.values():
                cone.rng.seed(ROUTE_SEED)
            return tuple(sorted(lc.MultiShotMeasureMask(
                [1 << b for b in range(10, 14)], ROUTE_SHOTS).items()))
        launched(lc_draw)   # builds the cone
        _n, dw, _t = launched(lambda: draw_repeats(lc_draw, ROUTE_REPEATS))
        check(_n == 1, f"the light-cone read drew {_n} key sets")
        draws["lightcone_multishot_distinct"] = _n
        # the pager's ProbMaskAll over 30 calls, and against the host
        p = fresh("pager", n, devices=[dev] * 4, init_state=PERM % (1 << n))
        p.QFT(0, n)
        p.H(n - 1)
        p.T(n - 1)
        p.Finish()
        mask = (1 << (n - 1)) | (1 << (n - 2)) | 0b101
        reads = [p.ProbMaskAll(mask) for _ in range(ROUTE_REPEATS)]
        ket = np.abs(p.GetQuantumState()) ** 2
        idx = np.arange(1 << n)
        key = np.zeros(1 << n, dtype=np.int64)
        for j, b in enumerate(b for b in range(n) if (mask >> b) & 1):
            key |= ((idx >> b) & 1) << j
        host = np.bincount(key, weights=ket, minlength=16)
        draws["pager_prob_mask_all"] = {
            "distinct": len({r_.tobytes() for r_ in reads}),
            "max_diff_between_calls": float(max(
                np.abs(r_ - reads[0]).max() for r_ in reads)),
            "max_diff_to_host": float(max(
                np.abs(r_ - host).max() for r_ in reads))}
        check(draws["pager_prob_mask_all"]["max_diff_to_host"] <= 1e-6,
              f"pager ProbMaskAll off the host: {draws}")
        out["g_repeats"] = {"width": n, "calls": ROUTE_REPEATS,
                            "shots": ROUTE_SHOTS, **draws}
        del lc, p
        release()
        lap("g_repeats")

        # ---- h. checkpoints of a routed and a light-cone session -------
        tmp = ckpt_dir(64 << 20)
        try:
            n = ROUTE_CKPT_WIDTH
            r = fresh("route", n, init_state=PERM % (1 << n))
            launched(lambda: qft_qcircuit(n).Run(r))
            check(r.current_stack() == "dense", f"the w{n} session routed "
                                                f"to {r.current_stack()}")
            path = os.path.join(tmp, "routed.qckpt")
            save_state(r, path)
            r2 = load_state(path)
            check(r2.current_stack() == "dense"
                  and r2._decision.layers == ("cuda",)
                  and r2.device_planes.device.type == dev.type,
                  f"the routed load landed as {r2._decision}")

            def cont(e):
                e.H(3)
                e.CNOT(3, n - 1)
                e.RY(0.4, 7)
                e.T(n - 1)
                e.Finish()
            for e in (r, r2):
                launched(lambda: cont(e))
            check(torch.equal(r.device_planes, r2.device_planes)
                  and r.MAll() == r2.MAll(),
                  f"the routed w{n} continuation from the file differs")
            lc = fresh("lightcone", ROUTE_LC_REPEAT)
            brickwork_qcircuit(ROUTE_LC_REPEAT).Run(lc)
            launched(lambda: [lc.Prob(q) for q in range(0, 24, 4)])
            lc.M(12)
            warm = [lc.Prob(q) for q in (11, 12, 13)]
            path = os.path.join(tmp, "lightcone.qckpt")
            save_state(lc, path)
            # restore-INTO a session built as the saver was (the
            # recovery path: the cones' stacks take its keywords)
            lc2 = load_state(path, into=fresh("lightcone", ROUTE_LC_REPEAT))
            check(sorted(lc2._cones) == sorted(lc._cones)
                  and all(torch.equal(lc._cones[k].device_planes,
                                      lc2._cones[k].device_planes)
                          for k in lc._cones),
                  "the light-cone load's cones differ from the saved ones")
            check([lc2.Prob(q) for q in (11, 12, 13)] == warm,
                  "the light-cone load read other values")

            def lcont(e):
                e.H(12)
                e.CNOT(12, 13)
                e.RY(0.3, 11)
                return ([e.Prob(q) for q in range(10, 16)],
                        e.MultiShotMeasureMask([1 << 12, 1 << 13], 256))
            a_, b_ = (launched(lambda: lcont(e))[0] for e in (lc, lc2))
            check(a_ == b_, f"the light-cone continuation from the file "
                            f"differs: {a_} against {b_}")
            out["h_checkpoint"] = {"routed_width": n,
                                   "lightcone_width": ROUTE_LC_REPEAT,
                                   "lightcone_cones": len(lc._cones)}
            del r, r2, lc, lc2
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        release()
        lap("h_checkpoint")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tele.disable()
        tele.reset()
    out["launches"] = counts
    out["seconds"] = time.time() - t_phase
    out["budget_s"] = ROUTE_PHASE_S
    emit(out)
    return counts


def cluster_worker(kind: str) -> dict:
    """One rank of phase 41 (``chip_smoke.py --cluster-worker <kind>``,
    the rank and the rendezvous in the QRACK_* environment): "nccl" runs
    (a), "gloo" runs (b)-(e).  Returns its RESULT dict."""
    from qrack_tpu_torch.parallel import cluster

    cluster.init_cluster(local_device_ids=[0], backend=kind)
    out = {"rank": cluster.process_index(), "ranks": cluster.process_count(),
           "backend": cluster.backend()}
    if kind == "nccl":
        out["a"] = cluster_nccl()
    else:
        out["b"], kept = cluster_qft()
        out["c"] = cluster_program()
        out["d"] = cluster_tq()
        out["e"] = cluster_ckpt()
        out["f"] = cluster_armed(kept)
        del kept
        out["g"] = cluster_staircase()
        out["h"] = cluster_struct()
    cluster._dist().destroy_process_group()
    return out



def _cluster_pager(n: int, homes, **kw):
    from qrack_tpu_torch.parallel import QPager
    from qrack_tpu_torch.utils.rng import QrackRandom

    return QPager(n, devices=homes, rng=QrackRandom(CLUSTER_SEED),
                  rand_global_phase=False, remap="on", **kw)


def _local_closed_form(q, x: int) -> tuple:
    """(max abs diff, fidelity) of this rank's pages of a cluster pager
    against the QFT of |x> (the table restored first: an exchange)."""
    from qrack_tpu_torch.ops import sharded as shb

    q._unmap()
    local = shb.local_pages(q.page_planes)
    return pages_closed_form([pg for _p, pg in local], q.qubit_count, x,
                             pid0=local[0][0], n_pages=q.n_pages)


def cluster_nccl() -> dict:
    """Phase 41 (a): a w28 pager of 4 pages on a group of one (nccl):
    the remap-on QFT through the cluster path against the one-process
    pager's, page by page, in the same process."""
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import cluster

    n, G = CLUSTER_NCCL_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    circ = qft_qcircuit(n)
    res = {}
    for name, devs in (("cluster", homes),
                       ("one_process", [h.device for h in homes])):
        q = _cluster_pager(n, devs)
        q.SetPermutation(PERM)
        w0 = dict(wk.launches())
        t0 = time.perf_counter()
        circ.Run(q)
        q.Finish()
        wall = time.perf_counter() - t0
        res[name] = {"q": q, "wall_s": wall,
                     "launches": {k: v - w0[k]
                                  for k, v in wk.launches().items()}}
    a, b = res["cluster"]["q"], res["one_process"]["q"]
    check(a._on_cluster and not any(shb.is_remote(p)
                                    for p in a.page_planes),
          "the nccl pager is not a cluster "
          "pager of one process")
    equal = (list(a._qmap) == list(b._qmap) and all(
        torch.equal(x, y) for x, y in zip(a.page_planes, b.page_planes)))
    check(equal, f"w{n} cluster pager on nccl differs from the one-process "
                 "pager")
    p3 = (a.Prob(3), b.Prob(3))
    amp = (a.GetAmplitude(PERM), b.GetAmplitude(PERM))
    check(p3[0] == p3[1] and amp[0] == amp[1],
          f"w{n} cluster reads {p3} {amp} differ from the one-process ones")
    worst, f = pager_closed_form(a, PERM)
    bar = 1e-4 * 2.0 ** (-n / 2)
    check(worst <= bar and f >= 1 - 1e-5,
          f"w{n} nccl QFT: max diff {worst} (bar {bar}), fidelity {f}")
    b._unmap()   # as the closed form left a: the draw reads physical pages
    m = (a.MAll(), b.MAll())
    check(m[0] == m[1], f"w{n} MAll {m}")
    got = res["cluster"]["launches"]
    check(got["in_tile"] + got["pair"] > 0
          and got == res["one_process"]["launches"],
          f"w{n} per-page launches {got} against the one-process "
          f"{res['one_process']['launches']}")
    return {"width": n, "pages": G, "bit_for_bit": equal, "prob3": p3[0],
            "max_abs_diff": worst, "fidelity": f, "mall": m[0],
            "launches": got,
            "wall_s": {k: v["wall_s"] for k, v in res.items()}}


def cluster_qft() -> tuple:
    """Phase 41 (b): the remap-on batched QFT of |PERM> through
    QCircuit.Run on 4 pages over two gloo ranks on one card.  Returns
    its results and this rank's pages at the closed form ({page id:
    copy}), which (f) is held to."""
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import cluster
    from qrack_tpu_torch.parallel import pager as pg

    n, G = CLUSTER_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    circ = qft_qcircuit(n)
    q = _cluster_pager(n, homes)
    check(any(shb.is_remote(p) for p in q.page_planes)
          and len(shb.local_pages(q.page_planes)) == G // 2,
          f"rank {cluster.process_index()} holds the wrong pages")
    q.SetPermutation(PERM)
    q.Finish()
    shb.reset_exchanges()
    pg.reset_flushes()
    tele.reset()
    tele.enable()
    w0 = dict(wk.launches())
    t0 = time.perf_counter()
    circ.Run(q)
    q.Finish()
    wall = time.perf_counter() - t0
    moved = dict(shb.TRANSPORT_S)
    c = tele.snapshot()["counters"]
    tele.disable()
    tele.reset()
    launches = {k: v - w0[k] for k, v in wk.launches().items()}
    ex = dict(shb.EXCHANGES)
    predicted = pg.FLUSHES["predicted_launches"]
    check(launches["in_tile"] + launches["pair"] == predicted > 0,
          f"w{n} per-page launches {launches} against the plans' "
          f"{predicted}")
    check(c.get("remap.pager.batched", 0) >= 1 and ex["wire_bytes"] > 0,
          f"w{n} QFT: no batched prologue over the wire ({c}, {ex})")
    worst, f = _local_closed_form(q, PERM)
    bar = 1e-4 * 2.0 ** (-n / 2)
    check(worst <= bar and f >= 1 - 1e-5,
          f"w{n} two-rank QFT: max diff {worst} (bar {bar}), fidelity {f}")
    kept = {i: page.clone() for i, page in shb.local_pages(q.page_planes)}
    p3 = q.Prob(3)
    m = q.MAll()
    out = {"width": n, "pages": G, "wall_s": wall, "launches": launches,
           "predicted_launches": predicted, "max_abs_diff": worst,
           "fidelity": f, "prob3": p3, "mall": m,
           "remap_batched": int(c.get("remap.pager.batched", 0)),
           "remap_pairs": int(c.get("remap.pager.pairs", 0)),
           "collective_bytes": float(
               c.get("exchange.pager.collective_bytes", 0.0)),
           "wire_bytes": ex["wire_bytes"], "staged_bytes": ex["staged_bytes"],
           "staging_s": moved["staging"], "wire_s": moved["wire"],
           # each rate over its own seconds: the host copies through the
           # pinned buffers (both ways), and the gloo wire alone
           "staging_gbps": ex["staged_bytes"] / max(moved["staging"], 1e-9)
           / 1e9,
           "wire_gbps": ex["wire_bytes"] / max(moved["wire"], 1e-9) / 1e9,
           "exchanges": ex}
    del q
    release()
    return out, kept


def cluster_program() -> dict:
    """Phase 41 (c): make_sharded_qft_fn over the two ranks' pages."""
    from qrack_tpu_torch.models.qft import basis_pages, make_sharded_qft_fn
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.parallel import cluster

    n, G = CLUSTER_PROGRAM_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    fn, _ = make_sharded_qft_fn(homes, n)
    pages = basis_pages(n, PERM, homes)
    shb.reset_exchanges()
    t0 = time.perf_counter()
    fn(pages)
    sync()
    wall = time.perf_counter() - t0
    local = shb.local_pages(pages)
    worst, f = pages_closed_form([pg for _p, pg in local], n, PERM,
                                 pid0=local[0][0], n_pages=G)
    bar = 1e-4 * 2.0 ** (-n / 2)
    check(worst <= bar and f >= 1 - 1e-5,
          f"w{n} page-list QFT over two ranks: max diff {worst} (bar "
          f"{bar}), fidelity {f}")
    check(shb.EXCHANGES["wire_bytes"] > 0, "the page-list QFT crossed no "
          "rank")
    out = {"width": n, "wall_s": wall, "max_abs_diff": worst,
           "fidelity": f, "wire_bytes": shb.EXCHANGES["wire_bytes"]}
    del pages
    release()
    return out


def cluster_tq() -> dict:
    """Phase 41 (d): the TurboQuant pager over the two ranks (16-bit
    codes): marginals and MAll, and the codes against the one-process
    TurboQuant pager's in the same process."""
    from qrack_tpu_torch.parallel import cluster
    from qrack_tpu_torch.parallel.turboquant_pager import QPagerTurboQuant
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = CLUSTER_TQ_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    kw = dict(bits=16, n_pages=G, rand_global_phase=False)
    tqs = [QPagerTurboQuant(n, devices=d, rng=QrackRandom(CLUSTER_SEED), **kw)
           for d in (homes, [h.device for h in homes])]
    t0 = time.perf_counter()
    for t in tqs:
        for i in range(n):
            t.H(i)
        t.CNOT(0, n - 1)     # a page-bit target: codes cross the ranks
        t.T(n - 1)
        t.CZ(n - 2, n - 1)
        t.Finish()
    wall = time.perf_counter() - t0
    probs = [tqs[0].Prob(k) for k in (3, n - 2, n - 1)]
    check(max(abs(p - 0.5) for p in probs) < 1e-3,
          f"w{n} TurboQuant pager over two ranks: marginals {probs}")
    same = [np.array_equal(x, y) for x, y in zip(tqs[0].host_codes(),
                                                  tqs[1].host_codes())]
    check(all(same), f"w{n} TurboQuant pager codes differ from the "
                     "one-process pager's")
    m = [t.MAll() for t in tqs]
    check(m[0] == m[1], f"w{n} TurboQuant MAll {m}")
    return {"width": n, "bits": 16, "marginals": probs, "mall": m[0],
            "codes_equal_one_process": True, "wall_s": wall}


def cluster_ckpt() -> dict:
    """Phase 41 (e): a w24 cluster pager saved on each rank, loaded into
    a fresh cluster pager (each local page torch.equal) and into a
    one-process pager on the card."""
    import tempfile

    from qrack_tpu_torch.checkpoint import load_state, save_state
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.parallel import cluster

    n, G = CLUSTER_CKPT_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    q = _cluster_pager(n, homes)
    q.SetPermutation(PERM & ((1 << n) - 1))
    qft_qcircuit(n).Run(q)
    q.H(n - 1)
    q.Finish()
    root = os.environ.get("QRACK_SMOKE_TMP") or tempfile.gettempdir()
    path = os.path.join(root, f"cluster_w{n}.rank{cluster.process_index()}"
                              ".qckpt")
    try:
        nbytes = save_state(q, path)
        r = _cluster_pager(n, homes)
        load_state(path, into=r)
        pairs = zip(shb.local_pages(q.page_planes),
                    shb.local_pages(r.page_planes))
        into = (list(r._qmap) == list(q._qmap)
                and all(torch.equal(a, b) for (_i, a), (_j, b) in pairs))
        one = load_state(path)
        check(not getattr(one, "_on_cluster", True)
              and one.device.type == "cuda", "the one-process load is "
              "not a one-process pager on the card")
        one_equal = (list(one._qmap) == list(q._qmap) and all(
            torch.equal(pg, one.page_planes[p])
            for p, pg in shb.local_pages(q.page_planes)))
    finally:
        if os.path.exists(path):
            os.unlink(path)
    check(into and one_equal, f"w{n} cluster checkpoint: into a cluster "
          f"pager {into}, into one process {one_equal}")
    return {"width": n, "file_bytes": nbytes, "into_cluster_equal": into,
            "one_process_equal": one_equal}


def _plane() -> None:
    """The resilience plane of phase 41 (f)-(h) from clean, armed with
    telemetry on."""
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.resilience import integrity as integ

    faults.clear()
    res.reset_breaker()
    res.configure(max_retries=2, backoff_s=0.0, timeout_s=0.0)
    integ.reset()
    tele.reset()
    tele.enable()
    res.enable()


def _unplane() -> dict:
    """Disarm phase 41's plane; the resilience, integrity and elastic
    counters it recorded (without the faulting rank's own records)."""
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.resilience import integrity as integ

    c = {k: v for k, v in tele.snapshot()["counters"].items()
         if k.startswith(("resilience.", "integrity.", "elastic."))
         and not k.startswith(CLUSTER_LOCAL)}
    faults.clear()
    res.disable()
    res.reset_breaker()
    res.configure()
    integ.reset()
    tele.disable()
    tele.reset()
    return c


def cluster_armed(kept: dict) -> dict:
    """Phase 41 (f): (b)'s QFT with the resilience plane armed over the
    two ranks, twice: a transient pager.exchange raise armed on rank 1
    alone (it fires in the closed form's unmap), then an amp-corrupt of
    a window's output pinned to a page of rank 1, armed there alone.
    Each leg's pages are held to (b)'s (`kept`)."""
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import cluster
    from qrack_tpu_torch.parallel import pager as pg
    from qrack_tpu_torch.resilience import faults

    n, G = CLUSTER_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    circ = qft_qcircuit(n)
    last = cluster.process_index() == cluster.process_count() - 1
    legs = {}
    for leg in ("raise", "amp-corrupt"):
        _plane()
        q = _cluster_pager(n, homes)
        q.SetPermutation(PERM)
        q.Finish()
        planes = sum(shb._page_bytes(p) for _i, p in
                     shb.local_pages(q.page_planes))
        if last and leg == "raise":
            faults.inject("pager.exchange", "raise", after_n=0, times=1)
        elif last:
            faults.inject("cuda.fuse.flush", "amp-corrupt", after_n=2,
                          times=1, page=G - 1, n_pages=G)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pg.reset_flushes()
        a0 = dict(cluster.AGREEMENTS)
        w0 = dict(wk.launches())
        t0 = time.perf_counter()
        circ.Run(q)
        q.Finish()
        wall = time.perf_counter() - t0
        above = torch.cuda.max_memory_allocated() - base
        launches = {k: v - w0[k] for k, v in wk.launches().items()}
        predicted = pg.FLUSHES["predicted_launches"]
        worst, f = _local_closed_form(q, PERM)
        bar = 1e-4 * 2.0 ** (-n / 2)
        check(worst <= bar and f >= 1 - 1e-5,
              f"w{n} armed two-rank QFT ({leg}): max diff {worst} (bar "
              f"{bar}), fidelity {f}")
        local = shb.local_pages(q.page_planes)
        equal_b = all(torch.equal(p, kept[i]) for i, p in local)
        check(equal_b, f"w{n} armed QFT ({leg}): pages differ from (b)'s")
        check(launches["in_tile"] + launches["pair"] == predicted > 0,
              f"w{n} armed per-page launches {launches} against the "
              f"plans' {predicted}")
        c = _unplane()
        legs[leg] = {
            "wall_s": wall, "launches": launches,
            "predicted_launches": predicted,
            "max_abs_diff": worst, "fidelity": f, "pages_equal_b": equal_b,
            "planes_bytes": planes, "above_planes_bytes": above,
            "agreements": cluster.AGREEMENTS["calls"] - a0["calls"],
            "agreement_s": cluster.AGREEMENTS["seconds"] - a0["seconds"],
            "retries": int(sum(v for k, v in c.items()
                               if k.startswith("resilience.retry."))),
            "failures": int(sum(v for k, v in c.items()
                                if k.startswith("resilience.failure."))),
            "repaired": int(c.get("integrity.replay.repaired", 0)),
            "strikes": int(c.get("integrity.quarantine.strike", 0)),
            "counters": c}
        del q, local
        release()
    return {"width": n, "pages": G, "legs": legs,
            "launches": {k: sum(l["launches"][k] for l in legs.values())
                         for k in ("in_tile", "pair")}}


def cluster_staircase() -> dict:
    """Phase 41 (g): a w26 QFT over the two ranks' 4 pages, then a
    persistent device loss at pager.device_get: the pager shrinks 4 -> 2
    (onto rank 0's slots) -> 1 page, then each rank builds a QEngineCUDA
    replica of the gathered ket; the faults cleared, the degraded pager
    grows back to 4 pages over both ranks.  Each move's wire bytes and
    seconds are logged."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import cluster
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = CLUSTER_STAIR_WIDTH, CLUSTER_PAGES
    homes = cluster.global_page_devices(G)
    moves = []
    real = {"repage": shb.repage, "gather": shb.all_gather_pages}

    def logged(name):
        def run(*a, **k):
            sync()
            w0, t0 = shb.EXCHANGES["wire_bytes"], time.perf_counter()
            out = real[name](*a, **k)
            sync()
            moves.append({"move": name,
                          "wire_bytes": shb.EXCHANGES["wire_bytes"] - w0,
                          "s": time.perf_counter() - t0})
            return out
        return run

    _plane()
    w0 = dict(wk.launches())
    shb.repage, shb.all_gather_pages = logged("repage"), logged("gather")
    try:
        q = qt.create_quantum_interface(
            "pager", n, devices=homes, n_pages=G,
            rng=QrackRandom(CLUSTER_SEED), rand_global_phase=False,
            remap="on")
        q.SetPermutation(PERM & ((1 << n) - 1))
        qft_qcircuit(n).Run(q)
        q.Finish()
        pager = q.engine
        faults.inject("pager.device_get", "device-loss", after_n=0,
                      times=None)
        t0 = time.perf_counter()
        p3 = q.Prob(3)
        stair_s = time.perf_counter() - t0
        kind = type(q.engine).__name__
        check(kind == "QEngineCUDA" and pager.n_pages == 1,
              f"w{n} staircase ended on {kind} with a pager of "
              f"{pager.n_pages} page(s)")
        worst, f = pages_closed_form([q.engine._state_raw], n,
                                     PERM & ((1 << n) - 1), n_pages=1)
        bar = 1e-4 * 2.0 ** (-n / 2)
        check(worst <= bar and f >= 1 - 1e-5,
              f"w{n} replica: max diff {worst} (bar {bar}), fidelity {f}")
        draws = [int(q.MAll()) for _ in range(2)]
        del q
        release()
        faults.clear()
        t0 = time.perf_counter()
        grew = pager.maybe_reexpand()
        expand_s = time.perf_counter() - t0
        here = len(shb.local_pages(pager.page_planes))
        check(grew and pager.n_pages == G and here == G // 2,
              f"w{n} re-expansion: {grew}, {pager.n_pages} pages, {here} "
              "here")
        worst2, f2 = _local_closed_form(pager, PERM & ((1 << n) - 1))
        check(worst2 <= bar and f2 >= 1 - 1e-5,
              f"w{n} re-expanded pager: max diff {worst2}, fidelity {f2}")
    finally:
        shb.repage, shb.all_gather_pages = real["repage"], real["gather"]
    c = _unplane()
    launches = {k: v - w0[k] for k, v in wk.launches().items()}
    del pager
    release()
    return {"width": n, "prob3": p3, "draws": draws, "staircase_s": stair_s,
            "expand_s": expand_s, "moves": moves,
            "max_abs_diff": max(worst, worst2), "fidelity": min(f, f2),
            "shrinks": int(c.get("elastic.repage.shrink", 0)),
            "expands": int(c.get("elastic.repage.expand", 0)),
            "failovers": int(c.get("resilience.failovers", 0)),
            "launches": launches}


def cluster_struct() -> dict:
    """Phase 41 (h) at w24, each held bit for bit against the
    one-process pager in this worker: a quarantine re-page onto a spare
    slot of rank 1; Compose, Decompose, Dispose and Allocate across a
    page-count change; the TurboQuant pager's dense float32 plane."""
    from qrack_tpu_torch.ops import sharded as shb
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.parallel import QPager, cluster
    from qrack_tpu_torch.parallel.turboquant_pager import QPagerTurboQuant
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.resilience import integrity as integ
    from qrack_tpu_torch.utils.rng import QrackRandom

    n, G = CLUSTER_STRUCT_WIDTH, CLUSTER_PAGES
    homes8 = cluster.global_page_devices(2 * G)
    card = shb.local_device(homes8)     # this rank's card
    w0 = dict(wk.launches())
    out = {"width": n}

    def same(a, b) -> bool:
        a._unmap()
        b._unmap()
        return (a.n_pages == b.n_pages and all(
            torch.equal(p, b.page_planes[i])
            for i, p in shb.local_pages(a.page_planes)))

    # the quarantine re-page: 8 slots, 4 a rank; the pages on rank 0's
    got = []
    for devs in (homes8, [card] * (2 * G)):
        _plane()
        q = QPager(n, devices=devs, n_pages=G, remap="off",
                   rng=QrackRandom(CLUSTER_SEED), rand_global_phase=False)
        for i in range(n):
            q.H(i)
        q.Prob(0)   # the layer's window runs before the strikes
        for k in range(3):
            faults.inject("pager.exchange", "amp-corrupt", after_n=0,
                          times=1, page=2, n_pages=G)
            q.H(n - 1 if k % 2 else n - 2)
            q.Prob(0)
            faults.clear()
        quarantined = sorted(integ.quarantined())
        q.maybe_reexpand()
        q.CNOT(0, n - 1)
        q.Prob(0)
        got.append((q, quarantined, list(q.page_slots)))
        _unplane()
    (a, qa, sa), (b, qb, sb) = got
    ranks = [a._slot_ranks[s] for s in sa]
    check(qa == qb == [2] and sa == sb == [0, 1, 3, 4] and ranks[-1] == 1
          and same(a, b), f"w{n} quarantine re-page: {qa} {sa} ranks "
          f"{ranks}, one process {qb} {sb}")
    out["quarantine"] = {"slots": sa, "ranks": ranks, "equal": True}
    del got, a, b
    release()

    # Compose, Decompose, Dispose and Allocate: down to one qubit (4 ->
    # 2 pages) and back
    homes = cluster.global_page_devices(G)
    got = []
    for devs in (homes, [card] * G):
        q = QPager(n, devices=devs, n_pages=G, rng=QrackRandom(5),
                   rand_global_phase=False)
        for i in range(n):
            q.RY(0.3 + 0.05 * i, i)
        q.CNOT(0, 1)
        q.CNOT(2, 3)
        dest = QPager(2, devices=[card], n_pages=1)
        q.Decompose(2, dest)
        q.Dispose(3, 1, 0)
        q.Dispose(1, n - 4, 1)
        pages_low = q.n_pages
        q.Allocate(1, n - 4)
        q.H(3)
        q.CNOT(3, 0)
        side = QPager(2, devices=devs, n_pages=G, rng=QrackRandom(6),
                      rand_global_phase=False)
        side.H(0)
        side.CNOT(0, 1)
        q.Compose(side)
        q.Allocate(2, 1)
        q.CNOT(n - 1, 2)
        got.append((q, pages_low, dest.GetQuantumState()))
    (a, la, da), (b, lb, db) = got
    check(la == lb == G // 2 and a.n_pages == G and same(a, b)
          and np.array_equal(da, db) and a.MAll() == b.MAll(),
          f"w{n} structural ops over the ranks differ from one process "
          f"(pages {la}/{lb} at one qubit)")
    out["structure"] = {"pages_at_one_qubit": la, "pages_after": a.n_pages,
                        "equal": True}
    del got, a, b
    release()

    # the TurboQuant pager's dense float32 plane, gathered onto each rank
    got = []
    for devs in (homes, [card] * G):
        t = QPagerTurboQuant(n, devices=devs, bits=16, n_pages=G,
                             rng=QrackRandom(CLUSTER_SEED),
                             rand_global_phase=False)
        for i in range(n):
            t.H(i)
        t.CNOT(0, n - 1)
        t.INC(5, 0, n)
        got.append(t.host_codes())
    check(all(np.array_equal(x, y) for x, y in zip(*got)),
          f"w{n} TurboQuant dense plane over the ranks: codes differ")
    out["tq_dense"] = {"equal": True}
    del got
    release()
    out["launches"] = {k: v - w0[k] for k, v in wk.launches().items()}
    return out


def _launch_cohort(kind: str, ranks: int) -> list:
    """Start `ranks` copies of ``chip_smoke.py --cluster-worker <kind>``
    on one rendezvous; their processes in rank order."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, QRACK_COORDINATOR=f"localhost:{port}",
                   QRACK_NUM_PROCESSES=str(ranks),
                   QRACK_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cluster-worker",
             kind], env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    return procs


def _cohort_results(kind: str, procs: list, deadline: float) -> list:
    """The RESULT dicts of a cohort's workers, in rank order.  A worker
    that fails or outlives the deadline fails the phase."""
    outs = []
    for rank, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 41 {kind} rank {rank} passed "
                                 f"{CLUSTER_TIMEOUT_S} s")
        check(p.returncode == 0, f"phase 41 {kind} rank {rank} failed "
                                 f"({p.returncode}):\n{err[-4000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(len(lines) == 1, f"phase 41 {kind} rank {rank} printed no "
                               f"result:\n{out[-2000:]}")
        outs.append(json.loads(lines[0][len("RESULT "):]))
    return outs


def cluster_phase(card: str, dev) -> dict:
    """Phase 41 (module docstring); returns its per-page K1/K2 launches
    (every rank's)."""
    t_phase = time.time()
    release()
    # the NCCL group of one starts beside the gloo cohort (the run
    # budget's second cut: most of its seconds are a process reaching
    # the card); every worker is stopped before the phase returns
    procs = {"nccl": _launch_cohort("nccl", 1),
             "gloo": _launch_cohort("gloo", CLUSTER_RANKS)}
    deadline = time.time() + CLUSTER_TIMEOUT_S
    try:
        nccl = _cohort_results("nccl", procs["nccl"], deadline)[0]
        t_a = time.time() - t_phase
        ranks = _cohort_results("gloo", procs["gloo"], deadline)
    finally:
        for p in procs["nccl"] + procs["gloo"]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check([r["rank"] for r in ranks] == list(range(CLUSTER_RANKS))
          and all(r["backend"] == "gloo" for r in ranks),
          f"phase 41 ranks {[(r['rank'], r['backend']) for r in ranks]}")
    b = [r["b"] for r in ranks]
    for key in ("prob3", "mall"):
        check(len({x[key] for x in b}) == 1,
              f"w{CLUSTER_WIDTH} two-rank {key} differs: {[x[key] for x in b]}")
    for x in b:
        check(x["launches"]["in_tile"] + x["launches"]["pair"] > 0,
              f"a rank launched no per-page kernel: {x['launches']}")
    d = [r["d"] for r in ranks]
    check(len({x["mall"] for x in d}) == 1,
          f"w{CLUSTER_TQ_WIDTH} TurboQuant MAll differs: "
          f"{[x['mall'] for x in d]}")
    # (f)-(h): every rank took the same decisions
    f_ = [r["f"] for r in ranks]
    for leg in ("raise", "amp-corrupt"):
        got = [x["legs"][leg] for x in f_]
        check(all(x["counters"] == got[0]["counters"] for x in got),
              f"(f) {leg}: the ranks' resilience counters differ: "
              f"{[x['counters'] for x in got]}")
        want = ({"retries": 1, "repaired": 0, "strikes": 0}
                if leg == "raise" else
                {"retries": 0, "repaired": 1, "strikes": 1})
        check(all(all(x[k] == v for k, v in want.items()) for x in got),
              f"(f) {leg}: retries/replays/strikes "
              f"{[(x['retries'], x['repaired'], x['strikes']) for x in got]}"
              f" against {want}")
    g = [r["g"] for r in ranks]
    check(len({tuple(x["draws"]) for x in g}) == 1
          and len({x["prob3"] for x in g}) == 1
          and all(x["shrinks"] == 2 and x["expands"] == 1
                  and x["failovers"] == 3 for x in g),
          f"(g) the staircase differs between the ranks: "
          f"{[(x['draws'], x['shrinks'], x['expands']) for x in g]}")
    # the bytes each move sent over the wire, summed over the ranks: the
    # shrink 4 -> 2 moves rank 1's half of the float32 ket onto rank 0,
    # 2 -> 1 stays on rank 0, the replica sends the whole ket to the
    # other rank, the re-expansion half of it back
    ket = 8 << CLUSTER_STAIR_WIDTH
    moves = [(m["move"], sum(x["moves"][i]["wire_bytes"] for x in g))
             for i, m in enumerate(g[0]["moves"])]
    want = [("repage", ket // 2), ("repage", 0),
            ("gather", ket * (CLUSTER_RANKS - 1)), ("repage", ket // 2)]
    check(moves == want, f"(g) moves and their wire bytes {moves} "
                         f"against {want}")
    launches = {k: nccl["a"]["launches"][k]
                + sum(r[leg]["launches"][k] for r in ranks
                      for leg in ("b", "f", "g", "h"))
                for k in ("in_tile", "pair")}
    seconds = time.time() - t_phase
    emit({"phase": "cluster", "card": card, "a_nccl": nccl["a"],
          "ranks": [{k: r[k] for k in ("rank", "b", "c", "d", "e", "f",
                                       "g", "h")}
                    for r in ranks],
          "f_wall_s": {leg: [x["legs"][leg]["wall_s"] for x in f_]
                       for leg in ("raise", "amp-corrupt")},
          "f_above_planes_bytes": {
              leg: [x["legs"][leg]["above_planes_bytes"] for x in f_]
              for leg in ("raise", "amp-corrupt")},
          "g_moves": [x["moves"] for x in g],
          "b_wall_s": [x["wall_s"] for x in b],
          "b_wire_bytes": [x["wire_bytes"] for x in b],
          "b_staged_bytes": [x["staged_bytes"] for x in b],
          "b_staging_s": [x["staging_s"] for x in b],
          "b_wire_s": [x["wire_s"] for x in b],
          "b_staging_gbps": [x["staging_gbps"] for x in b],
          "b_wire_gbps": [x["wire_gbps"] for x in b],
          "launches": launches, "a_seconds": t_a, "seconds": seconds,
          "budget_s": CLUSTER_PHASE_S})
    return launches


# ---------------------------------------------------------------------------
# phase 42: the serving plane
# ---------------------------------------------------------------------------

class _env:
    """Set environment variables for a block (a service reads its knobs
    at construction) and put the old values back after it."""

    def __init__(self, **values):
        self.values = values
        self.old = {}

    def __enter__(self):
        for k, v in self.values.items():
            self.old[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serve_store_dir() -> str:
    """The serving store of phase 42, made before phase 1: its
    kernel_cache is the build directory of the whole run
    (QRACK_TPU_KERNEL_CACHE, inherited by every process the script
    starts), so the warm-start child of (d) finds the libraries built."""
    import tempfile

    root = os.environ.get("QRACK_SMOKE_TMP") or tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="qrack-serve-", dir=root)


def serve_wave(n: int, seed: int):
    """A seeded circuit of SERVE_WAVE_GATES gates on `n` qubits: RY/RZ
    singles, CNOTs and CZs (phase 42 (b) and (e))."""
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit

    rng = np.random.Generator(np.random.PCG64(seed))
    c = QCircuit(n)
    for _ in range(SERVE_WAVE_GATES):
        r = float(rng.random())
        t = int(rng.integers(0, n))
        if r < 0.6:
            th = float(rng.uniform(0, 2 * np.pi))
            m = (mat.u3_mtrx(th, 0.0, 0.0) if r < 0.3
                 else np.diag([1.0, np.exp(1j * th)]))
            c.append_1q(t, m)
        else:
            ctl = (t + 1 + int(rng.integers(0, n - 1))) % n
            c.append_ctrl((ctl,), t, mat.X2 if r < 0.8 else mat.Z2, 1)
    return c


def serve_tenant(n: int, tail_seed: int):
    """Phase 42 (c)'s tenant: the shared state-prep of the prefix-cache
    tests (H on every qubit, two CX rings each with an RY layer) and a
    tail of its own (a CX ring, then RY on every qubit)."""
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit

    def ry(th):
        c, s = np.cos(th / 2.0), np.sin(th / 2.0)
        return np.array([[c, -s], [s, c]], dtype=np.complex128)

    def ring(circ):
        for q in range(n - 1):
            circ.append_ctrl((q,), q + 1, mat.X2, 1)

    circ = QCircuit()
    rng = np.random.default_rng(7)
    for q in range(n):
        circ.append_1q(q, mat.H2)
    for _ in range(2):
        ring(circ)
        for q in range(n):
            circ.append_1q(q, ry(rng.uniform(0.0, 2.0 * np.pi)))
    ring(circ)
    rng = np.random.default_rng(tail_seed)
    for q in range(n):
        circ.append_1q(q, ry(rng.uniform(0.0, 2.0 * np.pi)))
    return circ


def planes_sha(planes) -> str:
    import hashlib

    return hashlib.sha256(planes.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def serve_worker(store: str, device: str = DEVICE) -> dict:
    """Phase 42 (d)'s child, on the parent's store: reach the card, wait
    for a line on stdin (the parent's go), then recover with prewarm,
    count the kernel libraries' and the batch program's cache hits, hash
    the recovered kets, and run the first job."""
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.ops import cuda_build
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.serve import QrackService

    torch.zeros(1, device=device)   # reach the card, then wait for go
    sys.stdin.readline()
    tele.enable()
    n = SERVE_WARM_WIDTH
    t0 = time.time()
    with _env(QRACK_SERVE_PREFIX="0"):
        svc = QrackService(engine_layers="cuda", device=device,
                           checkpoint_dir=store, recover=True, prewarm=True,
                           batch_window_ms=2000.0, max_batch=2,
                           queue_budget_ms=600_000.0, tick_s=0.05)
    try:
        t_ready = time.time() - t0
        cuda_build.build([wk.SOURCE, tqk.SOURCE])
        warm = {k: v for k, v in tele.snapshot()["counters"].items()
                if k.startswith(("compile.", "checkpoint.warmstart."))}
        sids = sorted(svc.sessions.ids())
        shas = {s: planes_sha(svc.call(s, lambda e: e.device_planes,
                                       mutates=False).result(120))
                for s in sids}
        wk.reset_launches()
        for h in [svc.submit(s, qft_qcircuit(n)) for s in sids]:
            h.result(300)
        sync()
        launches = dict(wk.launches())
        after = {k: v for k, v in tele.snapshot()["counters"].items()
                 if k.startswith("compile.serve_batch")}
        finite = all(bool(torch.isfinite(svc.call(
            s, lambda e: e.device_planes, mutates=False).result(120)).all())
            for s in sids)
    finally:
        svc.close()
    return {"sids": sids, "shas": shas, "warm": warm, "after": after,
            "launches": launches, "finite": finite, "ready_s": t_ready,
            "seconds": time.time() - t0}


def serve_phase(card: str, dev, store: str) -> dict:
    """Phase 42 (module docstring); returns its K1/K2 launches by plane
    dtype (the service-driven runs of (a)-(e) and the child of (d))."""
    import qrack_tpu_torch as qt
    from qrack_tpu_torch import resilience as res
    from qrack_tpu_torch import telemetry as tele
    from qrack_tpu_torch.models.qft import basis_planes, qft_qcircuit
    from qrack_tpu_torch.ops import window_kernel as wk
    from qrack_tpu_torch.resilience import faults
    from qrack_tpu_torch.resilience import integrity as integ
    from qrack_tpu_torch.serve import QrackService, batcher
    from qrack_tpu_torch.serve import prefix_cache as pc

    release()
    t_phase = time.time()
    out = {"phase": "serve", "card": card, "sections_s": {}}
    t_lap = [t_phase]

    def lap(name: str) -> None:
        now = time.time()
        out["sections_s"][name] = now - t_lap[0]
        t_lap[0] = now

    counts = {dt: {"in_tile": 0, "pair": 0} for dt in wk.DTYPE_LAUNCHES}

    def served(fn):
        """fn() with its K1/K2 launches (by dtype) added to counts."""
        w0 = {dt: dict(c) for dt, c in wk.DTYPE_LAUNCHES.items()}
        r = fn()
        sync()
        for dt, c in wk.DTYPE_LAUNCHES.items():
            for k, v in c.items():
                counts[dt][k] += v - w0[dt][k]
        return r

    def settle(handles):
        for h in handles:
            h.result(300)
        return handles

    def bar_check(got, want, what):
        err, _rel = held_to_plain(got, want, what)
        return err, bool(torch.equal(got, want))

    kw = {"device": str(dev), "queue_budget_ms": 600_000.0, "tick_s": 0.05}
    n, B = SERVE_WIDTH, SERVE_TENANTS
    child = None
    plane_bytes = 2 * 4 << n
    tele.enable()
    tele.reset()
    try:
        # ---- (d) the warm start: a service abandoned without drain ------
        nw = SERVE_WARM_WIDTH
        tele.reset()
        with _env(QRACK_SERVE_PREFIX="0"):
            svc = QrackService(engine_layers="cuda", checkpoint_dir=store,
                               hold_lease=False, checkpoint_every_job=True,
                               batch_window_ms=2000.0, max_batch=2, **kw)
        try:
            wsids = [svc.create_session(nw, seed=SERVE_SEED + k,
                                        rand_global_phase=False)
                     for k in range(2)]
            for k, sid in enumerate(wsids):
                svc.call(sid, lambda e, k=k: e.X(k)).result(300)
            served(lambda: settle([svc.submit(s, qft_qcircuit(nw))
                                   for s in wsids]))
            shas = {s: planes_sha(svc.call(s, lambda e: e.device_planes,
                                           mutates=False).result(300))
                    for s in wsids}
            recorded = len(svc.program_manifest)
        finally:
            # abandoned: no drain, no close; its every-job snapshots and
            # the manifest are all a successor gets
            svc.scheduler.stop()
            svc.executor.stop()
            batcher.set_manifest(None)
            del svc
            release()
        # the child starts now and reaches the card while (c), (e), (a)
        # and (b) run; it touches the store and the card only once told
        # to go, after (b)
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-worker",
             store, str(dev)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lap("d_parent")

        # ---- (c) the prefix cache: 1 materialization, 7 hits ---------------
        np_ = SERVE_PREFIX_WIDTH
        tele.reset()
        with _env(QRACK_SERVE_PREFIX="1"):
            svc = QrackService(engine_layers="cuda", batch_window_ms=2.0,
                               **kw)
        try:
            # one lookup of a ninth tenant (host only, a miss) makes the
            # shared prep popular, so the first tenant materializes it
            check(svc.prefix_cache.plan(serve_tenant(np_, B), np_) is None,
                  "(c) the priming lookup planned a split")
            fps = {}
            c_fid = []
            for t in range(B):
                sid = svc.create_session(np_, seed=t, rand_global_phase=False)
                served(lambda: svc.submit(sid, serve_tenant(np_, t)
                                          ).result(300))
                if t == 0:
                    entry = next(iter(svc.prefix_cache._entries.values()))
                    fps["insert"] = entry.fingerprint
                got = svc.call(sid, lambda e: e.device_planes,
                               mutates=False).result(300)
                ref = basis_planes(np_, 0, device=dev)
                serve_tenant(np_, t).compile_fn_pallas(np_)(ref)
                c_fid.append(fidelity(got, ref))
                del got, ref
            fps["after"] = pc.fingerprint_host(pc.host_planes(entry.planes))
            c = tele.snapshot()["counters"]
        finally:
            svc.close()
            del svc
            release()
        check(c.get("serve.prefix.insert") == 1
              and c.get("serve.prefix.miss") == 2
              and c.get("serve.prefix.hit") == B - 1
              and c.get("serve.prefix.cow") == B - 1
              and fps["after"] == fps["insert"]
              and min(c_fid) >= 1 - 1e-6,
              f"(c) prefix counters "
              f"{ {k: v for k, v in c.items() if k.startswith('serve.prefix')} }"
              f", fingerprint kept {fps['after'] == fps['insert']}, "
              f"fidelities {c_fid}")
        out["c"] = {"width": np_, "tenants": B,
                    "counters": {k: v for k, v in c.items()
                                 if k.startswith("serve.prefix.")},
                    "fingerprint_kept": True, "min_fidelity": min(c_fid)}
        lap("c")

        # ---- (e) the canary: clean, then an amp-corrupt caught ----------
        ne = SERVE_CANARY_WIDTH
        tele.reset()
        integ.reset()
        with _env(QRACK_SERVE_CANARY_RATE="1.0"):
            svc = QrackService(engine_layers="cuda", batch_window_ms=2.0,
                               **kw)
        try:
            sid = svc.create_session(ne, seed=SERVE_SEED,
                                     rand_global_phase=False)
            served(lambda: svc.submit(sid, serve_wave(ne, SERVE_SEED + 7)
                                      ).result(300))
            faults.inject("serve.dispatch", "amp-corrupt", after_n=0,
                          times=1)
            try:
                served(lambda: svc.submit(sid, serve_wave(ne, SERVE_SEED + 8)
                                          ).result(300))
            finally:
                faults.clear()
                res.disable()
            deadline = time.time() + 120
            while svc.canary.checked < 2 and time.time() < deadline:
                svc.canary.drain(timeout=1.0)
                time.sleep(0.05)
            checked, mism = svc.canary.checked, svc.canary.mismatches
            strikes = dict(integ.strikes())
        finally:
            svc.close()
            del svc
            integ.reset()
            res.reset_breaker()
            release()
        card_idx = torch.cuda.current_device()
        check(checked == 2 and mism == 1,
              f"(e) canary checked {checked}, mismatches {mism}")
        check(strikes == {card_idx: 1},
              f"(e) the canary's strikes {strikes}: not one on the card "
              f"({card_idx})")
        out["e"] = {"width": ne, "checked": checked, "mismatches": mism,
                    "strikes": strikes}
        lap("e")

        # ---- (a) eight co-batched tenants, one w30 fold ---------------
        with _env(QRACK_SERVE_PREFIX="0"):
            svc = QrackService(engine_layers="cuda", batch_window_ms=5000.0,
                               max_batch=B, **kw)
        try:
            sids = [svc.create_session(n, seed=SERVE_SEED + k,
                                       rand_global_phase=False)
                    for k in range(B)]
            for k, sid in enumerate(sids):
                svc.call(sid, lambda e, k=k: (e.X(k), e.device_planes)
                         ).result(300)
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            circ = qft_qcircuit(n)
            real_run = batcher.run_batch
            events = []

            def timed(jobs, engines):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                r = real_run(jobs, engines)
                ev[1].record()
                events.append(ev)
                return r

            batcher.run_batch = timed
            tele.reset()
            try:
                wk.reset_launches()      # the main path's counts from 0
                t0 = time.perf_counter()
                handles = served(lambda: settle(
                    [svc.submit(s, qft_qcircuit(n)) for s in sids]))
                wall_s = time.perf_counter() - t0
                main = dict(wk.launches())
            finally:
                batcher.run_batch = real_run
            peak_above = torch.cuda.max_memory_allocated() - base
            c = tele.snapshot()["counters"]
            check(c.get("serve.batch.dispatches") == 1
                  and c.get("serve.batch.jobs") == B,
                  f"(a) {B} w{n} jobs took {c.get('serve.batch.dispatches')}"
                  f" dispatches of {c.get('serve.batch.jobs')} jobs")
            prog = batcher._PROGRAMS._od[batcher.program_key(
                circ, n, B, torch.float32, dev)]
            planned = prog.planned_sweeps(B)
            check(prog.fold_width(B) == n + (B - 1).bit_length()
                  and main["in_tile"] + main["pair"] == planned,
                  f"(a) the fold launched {main}, planned {planned} sweeps "
                  f"of one w{prog.fold_width(B)} fold")
            check(peak_above <= 2 * B * plane_bytes + SERVE_MEM_SLACK,
                  f"(a) {peak_above} bytes above the sessions' planes "
                  f"(bar {2 * B * plane_bytes + SERVE_MEM_SLACK})")
            batch_ms = events[0][0].elapsed_time(events[0][1])
            waits = [h.queue_wait_s for h in handles]
            lats = [h.latency_s for h in handles]
            fn = circ.compile_fn_pallas(n)
            errs, equal = [], []
            for k, sid in enumerate(sids):
                ref = basis_planes(n, 1 << k, device=dev)
                fn(ref)
                got = svc.call(sid, lambda e: e.device_planes,
                               mutates=False).result(300)
                e_, q_ = bar_check(got, ref, f"(a) tenant {k}'s w{n} ket "
                                   "against its solo compile_fn_pallas")
                errs.append(e_)
                equal.append(q_)
                del ref, got
            # the batch's parts, timed apart on the sessions' planes
            # (after the main path's counts were read): the program's
            # build on the host, then the fold as the service's first
            # batch met it (its 16 GiB freshly allocated: the cache
            # emptied first), the stack again warm, and the kernels of
            # one solo w27 lane with the same packed operands
            planes = [svc.call(s, lambda e: e.device_planes,
                               mutates=False).result(300) for s in sids]
            release()
            h0 = time.perf_counter()
            batcher.FoldProgram(circ, n, torch.float32, dev)
            sync()
            build_ms = (time.perf_counter() - h0) * 1e3
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            fold = torch.stack(planes, dim=1)
            ev[1].record()
            wk.apply_window(fold.view(2, B << n), prog.fold_width(B),
                            prog.structure, prog.fv, prog.iv, prog.table,
                            prog.block_pow)
            ev[2].record()
            lanes = [fold[:, i].clone() for i in range(B)]
            ev[3].record()
            del fold, lanes
            ev[4].record()
            fold = torch.stack(planes, dim=1)
            ev[5].record()
            sync()
            stack_cold_ms = ev[0].elapsed_time(ev[1])
            fold_ms = ev[1].elapsed_time(ev[2])
            bind_cold_ms = ev[2].elapsed_time(ev[3])
            stack_ms = ev[4].elapsed_time(ev[5])
            del fold
            lane = planes[0].clone()
            solo_k = []
            for _k in range(B):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                wk.apply_window(lane, n, prog.structure, prog.fv, prog.iv,
                                prog.table, prog.block_pow)
                e1.record()
                sync()
                solo_k.append(e0.elapsed_time(e1))
            del lane, planes
            release()
            # eight solo w27 RunFused walls, each on its tenant's basis
            solo = qt.create_quantum_interface("cuda", n, device=dev,
                                               rand_global_phase=False)
            solo_ms, solo_host_s = [], []
            for k in range(B):
                solo.SetPermutation(1 << k)
                solo.device_planes
                sync()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                h0 = time.perf_counter()
                e0.record()
                circ.RunFused(solo)
                solo.device_planes
                e1.record()
                sync()
                solo_host_s.append(time.perf_counter() - h0)
                solo_ms.append(e0.elapsed_time(e1))
            del solo
            out["a"] = {
                "width": n, "tenants": B, "fold_width": prog.fold_width(B),
                "launches": main, "planned_sweeps": planned,
                "wall_s": wall_s, "batch_ms": batch_ms,
                "program_build_ms": build_ms,
                "stack_cold_ms": stack_cold_ms, "stack_ms": stack_ms,
                "fold_kernels_ms": fold_ms, "bind_cold_ms": bind_cold_ms,
                "solo_runfused_ms": solo_ms,
                "solo_runfused_sum_ms": sum(solo_ms),
                "solo_runfused_host_s": solo_host_s,
                "solo_kernels_ms": solo_k,
                "solo_kernels_sum_ms": sum(solo_k),
                "fold_over_solo_kernels": fold_ms / sum(solo_k),
                "fold_over_solo_runfused": fold_ms / sum(solo_ms),
                "bytes_bound_ms": planned * 2 * B * plane_bytes
                / PEAK_BYTES_S * 1e3,
                "above_planes_bytes": peak_above,
                "above_bar_bytes": 2 * B * plane_bytes + SERVE_MEM_SLACK,
                "max_abs_err": max(errs), "torch_equal": equal,
                "queue_wait_p50_s": float(np.percentile(waits, 50)),
                "queue_wait_p99_s": float(np.percentile(waits, 99)),
                "latency_p50_s": float(np.percentile(lats, 50)),
                "latency_p99_s": float(np.percentile(lats, 99))}
            lap("a")

            # ---- (b) pipelined exactly-once under one sync fault ---------
            waves = [serve_wave(n, SERVE_SEED + 100 + w) for w in range(2)]
            pre = [svc.call(s, lambda e: e.device_planes.clone(),
                            mutates=False).result(300) for s in sids]
            res.configure(max_retries=0, backoff_s=0.0, timeout_s=0.0)
            res.reset_breaker()
            tele.reset()
            spec = faults.inject("serve.device_get", "raise", after_n=0,
                                 times=1)
            try:
                t0 = time.perf_counter()
                served(lambda: settle([svc.submit(s, c_) for c_ in waves
                                       for s in sids]))
                b_wall = time.perf_counter() - t0
            finally:
                faults.clear()
                res.disable()
                res.configure()
                res.reset_breaker()
            c = tele.snapshot()["counters"]
            check(spec.fired == 1 and c.get("serve.batch.failovers") == 1
                  and c.get("serve.batch.replay.in_place") == B
                  and c.get("serve.overlap.staged", 0) >= 1
                  and c.get("serve.jobs.failed", 0) == 0,
                  f"(b) fired {spec.fired}, counters "
                  f"{ {k: v for k, v in c.items() if k.startswith('serve.')} }")
            fns = [w.compile_fn_pallas(n) for w in waves]
            b_errs, b_equal = [], []
            for k, sid in enumerate(sids):
                ref = pre[k]
                for f_ in fns:
                    f_(ref)
                got = svc.call(sid, lambda e: e.device_planes,
                               mutates=False).result(300)
                e_, q_ = bar_check(got, ref, f"(b) tenant {k}'s ket against "
                                   "an unfaulted run of both waves")
                b_errs.append(e_)
                b_equal.append(q_)
                pre[k] = None
                del ref, got
            out["b"] = {"jobs": 2 * B, "wall_s": b_wall,
                        "counters": {k: v for k, v in c.items()
                                     if k.startswith(("serve.batch.",
                                                      "serve.overlap."))},
                        "max_abs_err": max(b_errs), "torch_equal": b_equal}
            lap("b")
        finally:
            svc.close()
            del svc
            release()

        # ---- (d) the child's result ------------------------------------
        t0 = time.time()
        stdout, stderr = child.communicate("go\n",
                                           timeout=SERVE_CHILD_TIMEOUT_S)
        out["d_child_after_go_s"] = time.time() - t0
        check(child.returncode == 0,
              f"(d) the warm-start child failed: {stderr[-3000:]}")
        got = json.loads([x for x in stdout.splitlines()
                          if x.startswith("RESULT ")][-1][len("RESULT "):])
        warm = got["warm"]
        check(got["sids"] == sorted(wsids)
              and all(got["shas"][s] == shas[s] for s in wsids),
              f"(d) recovered kets differ: {got['shas']} against {shas}")
        check(warm.get("compile.kernel.window_kernel.hit", 0) >= 1
              and warm.get("compile.kernel.turboquant_kernel.hit", 0) >= 1
              and not any(k.startswith("compile.kernel.")
                          and k.endswith(".miss") for k in warm)
              and warm.get("compile.serve_batch.miss") == recorded
              and got["after"].get("compile.serve_batch.hit") == 1
              and got["finite"],
              f"(d) warm start: {warm}, after the first job {got['after']}")
        for k, v in got["launches"].items():
            counts["float32"][k] += v
        out["d"] = {"width": nw, "recorded": recorded, "child": got}
        lap("d")
    finally:
        tele.disable()
        tele.reset()
        if child is not None and child.poll() is None:
            child.kill()
            child.communicate()
    check(counts["float32"]["in_tile"] > 0 and counts["float32"]["pair"] > 0,
          f"phase 42 launched K1 or K2 no time: {counts['float32']}")
    out["launches"] = counts
    out["seconds"] = time.time() - t_phase
    out["budget_s"] = SERVE_PHASE_S
    emit(out)
    return counts


# ---------------------------------------------------------------------------
# phase 43: the fleet
# ---------------------------------------------------------------------------

def fleet_ghz(n: int):
    """H on qubit 0 and a CNOT chain: the w64 GHZ of the tableau session."""
    from qrack_tpu_torch import matrices as mat
    from qrack_tpu_torch.layers.qcircuit import QCircuit

    c = QCircuit(n)
    c.append_1q(0, mat.H2)
    for q in range(n - 1):
        c.append_ctrl((q,), q + 1, mat.X2, 1)
    return c


class FleetRun:
    """Phase 43's supervisor, started before phase 42 so that its workers
    boot while that phase runs.  The workers' store holds a copy of the
    kernel libraries the run built (its kernel_cache), so no worker runs
    nvcc."""

    def __init__(self):
        import shutil
        import tempfile

        from qrack_tpu_torch.fleet import FleetSupervisor
        from qrack_tpu_torch.ops import cuda_build
        from qrack_tpu_torch.ops import turboquant_kernel as tqk
        from qrack_tpu_torch.ops import window_kernel as wk

        tmp = os.environ.get("QRACK_SMOKE_TMP") or tempfile.gettempdir()
        free = shutil.disk_usage(tmp).free
        check(free >= CKPT_ROOM * FLEET_DISK_BYTES,
              f"{tmp} has {free} bytes free; phase 43's snapshots need "
              f"{CKPT_ROOM}x {FLEET_DISK_BYTES} (set QRACK_SMOKE_TMP to a "
              "directory on a larger local disk)")
        self.root = tempfile.mkdtemp(prefix="qrack-fleet-", dir=tmp)
        cache = os.path.join(self.root, "store", "kernel_cache")
        os.makedirs(cache)
        for src in (wk.SOURCE, tqk.SOURCE):
            for path in (cuda_build.library_path(src),
                         cuda_build.log_path(src)):
                shutil.copy2(path, os.path.join(cache, path.name))
        self.sup = FleetSupervisor(
            FLEET_WORKERS, self.root, ready_timeout_s=FLEET_READY_TIMEOUT_S,
            extra_env={"QRACK_TPU_TELEMETRY": "1",
                       "QRACK_SERVE_PREFIX": "0",
                       "QRACK_SERVE_CANARY_RATE": "0",
                       "QRACK_SERVE_QUEUE_BUDGET_MS": "600000"})
        self.error = None
        self.thread = threading.Thread(target=self._start, daemon=True,
                                       name="fleet-start")
        self.t0 = time.monotonic()
        self.thread.start()

    def _start(self) -> None:
        try:
            self.sup.start()
        except BaseException as e:  # noqa: BLE001 — re-raised by join
            self.error = e

    def join(self) -> float:
        """Wait for every worker to be ready; the seconds since the
        spawn."""
        self.thread.join(FLEET_READY_TIMEOUT_S + 60.0)
        check(not self.thread.is_alive(), "phase 43's fleet never started")
        if self.error is not None:
            raise self.error
        return time.monotonic() - self.t0

    def close(self) -> None:
        import shutil

        self.thread.join(FLEET_READY_TIMEOUT_S + 60.0)
        self.sup.stop()
        shutil.rmtree(self.root, ignore_errors=True)


def fleet_phase(card: str, dev, run: FleetRun) -> dict:
    """Phase 43 (module docstring); returns the workers' K1/K2 launches by
    plane dtype, summed over every worker incarnation."""
    import signal

    import qrack_tpu_torch as qt
    from qrack_tpu_torch.checkpoint import container
    from qrack_tpu_torch.checkpoint.store import CheckpointStore
    from qrack_tpu_torch.fleet import FleetFrontDoor
    from qrack_tpu_torch.models.qft import qft_qcircuit
    from qrack_tpu_torch.serve import QrackService
    from qrack_tpu_torch.serve.batcher import FoldProgram

    release()
    t_phase = time.time()
    out = {"phase": "fleet", "card": card, "sections_s": {}}
    t_lap = [t_phase]

    def lap(name: str) -> None:
        now = time.time()
        out["sections_s"][name] = now - t_lap[0]
        t_lap[0] = now

    out["start_to_ready_s"] = run.join()
    sup = run.sup
    out["boot_to_ready_s"] = {k: w["boot_to_ready_s"] for k, w
                              in sup.stats()["workers"].items()}
    lap("ready")
    mem = {}

    def mem_at(tag: str) -> None:
        """The card's used bytes (every process) and this process's
        reserved ones (its reference runs and loads): the workers hold
        the difference, less this process's context."""
        free, total = torch.cuda.mem_get_info()
        mem[tag] = {"used": total - free,
                    "here_reserved": torch.cuda.memory_reserved()}

    widths = {"A": FLEET_WIDTH, "B": FLEET_WIDTH, "S": FLEET_SMALL_WIDTH,
              "D": FLEET_WIDTH}
    seeds = {k: FLEET_SEED + i for i, k in enumerate(widths)}
    front = FleetFrontDoor(sup)
    store = CheckpointStore(sup.store_dir)
    with _env(QRACK_SERVE_PREFIX="0"):   # as the workers run
        ref = QrackService(engine_layers="cuda", device=str(dev),
                           tick_s=0.05, queue_budget_ms=600_000.0)
    sid, rsid, jobs, done, planned = {}, {}, {k: [] for k in widths}, {}, [0]

    def job(k: str):
        c = (qft_qcircuit(widths[k]) if not jobs[k] else
             serve_wave(widths[k], FLEET_SEED + 100 * len(jobs[k])
                        + seeds[k]))
        jobs[k].append(c)
        prog = FoldProgram(c, widths[k], torch.float32, dev)
        planned[0] += prog.planned_sweeps(1)
        return c

    def settle_wal(keys) -> None:
        """Wait for the sessions' last jobs to settle: a job's result
        frame comes before its every-job snapshot and the removal of its
        WAL entry."""
        deadline = time.monotonic() + 120
        while store.wal_pending_tags(sids=[sid[k] for k in keys]):
            check(time.monotonic() < deadline, f"{keys}' jobs never settled")
            time.sleep(0.01)

    def apply_all(keys) -> None:
        """One next job on each session, the sessions in parallel, each
        settled."""
        circs = {k: job(k) for k in keys}
        errs = []

        def one(k):
            try:
                front.apply(sid[k], circs[k])
            except BaseException as e:  # noqa: BLE001
                errs.append((k, e))

        ts = [threading.Thread(target=one, args=(k,)) for k in keys]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        check(not errs and not any(t.is_alive() for t in ts),
              f"phase 43 apply failed: {errs}")
        settle_wal(keys)

    def reference(k: str):
        """The uninterrupted in-process run of session k's jobs."""
        if k not in rsid:
            rsid[k] = ref.create_session(widths[k], seed=seeds[k],
                                         rand_global_phase=False)
            done[k] = 0
        for c in jobs[k][done[k]:]:
            ref.apply(rsid[k], c, timeout=600)
        done[k] = len(jobs[k])
        return ref.call(rsid[k], lambda e: e.device_planes,
                        mutates=False).result(600)

    def settled(k: str):
        """Session k's planes from its every-job snapshot (the WAL entry
        goes after the snapshot is written), loaded in this process."""
        settle_wal([k])
        store.reload()
        t0 = time.perf_counter()
        eng = store.load(sid[k], device=dev)
        planes = eng.device_planes
        sync()
        wall = time.perf_counter() - t0
        load = dict(container.LAST_LOAD)
        return planes, {"read_s": load["read_s"], "bytes": load["bytes"],
                        "upload_and_build_s": wall - load["read_s"]}

    def exact(keys, what: str) -> dict:
        got = {}
        for k in keys:
            if widths[k] == FLEET_SMALL_WIDTH:
                a = np.asarray(front.get_state(sid[k]))
                want = reference(k)
                b = np.asarray(ref.get_state(rsid[k], timeout=600))
                if not np.array_equal(a, b):
                    snap = settled(k)[0]
                    check(False,
                          f"{what}: session {k}'s get_state differs from the "
                          f"uninterrupted run by {np.abs(a - b).max()} "
                          f"(fidelity {abs(np.vdot(a, b)) ** 2}); its "
                          f"snapshot {'equals' if torch.equal(snap, want) else 'differs from'}"
                          f" the run's planes by {chunked_max(snap, want)}; "
                          f"norms {np.vdot(a, a).real}, {np.vdot(b, b).real}")
                got[k] = True
                continue
            planes, load = settled(k)
            want = reference(k)
            check(torch.equal(planes, want),
                  f"{what}: session {k}'s snapshot differs from the "
                  f"uninterrupted run by {chunked_max(planes, want)}")
            got[k] = load
            del planes, want
        return got

    try:
        # ---- the sessions: two w26, one w20, one w64 GHZ on the tableau
        for k in ("A", "B", "S"):
            sid[k] = front.create_session(widths[k], seed=seeds[k],
                                          rand_global_phase=False)
        g = front.create_session(FLEET_STAB_WIDTH, layers="stabilizer",
                                 seed=FLEET_SEED)
        front.apply(g, fleet_ghz(FLEET_STAB_WIDTH))
        owners0 = {k: sup.owner_of(v) for k, v in sid.items()}
        check(owners0["A"] != owners0["B"],
              f"the two w{FLEET_WIDTH} sessions share a worker: {owners0}")
        apply_all(["A", "B", "S"])
        mem_at("sessions")
        lap("sessions")

        # ---- (a) kill -9 the owner of A with A's job in flight ---------
        victim = sup.owner_of(sid["A"])
        vpid = sup.stats()["workers"][victim]["pid"]
        # the victim's launches so far: its beats may miss the last ones
        pre_kill_info = sup.client(victim).info()
        pre_kill = pre_kill_info["kernels"]
        c_inflight = job("A")
        box = {}

        def inflight():
            box["out"] = front.apply(sid["A"], c_inflight)

        t_in = threading.Thread(target=inflight)
        t_in.start()
        deadline = time.monotonic() + 120
        while not store.wal_pending_tags(sids=[sid["A"]]):
            check(time.monotonic() < deadline, "(a) A's job never journaled")
            time.sleep(0.001)
        mem_at("before_kill")
        t_kill = time.monotonic()
        os.kill(vpid, signal.SIGKILL)
        while not sup.stats()["deaths"]:
            check(time.monotonic() < deadline + 60, "(a) no death detected")
            time.sleep(0.005)
        mem_at("after_detect")
        t_in.join(600)
        t_return = time.monotonic()
        check(not t_in.is_alive() and box.get("out") == {
            "resubmits": 0, "adopted": True},
            f"(a) the in-flight apply returned {box.get('out')}")
        while sup.stats()["deaths"][0]["adopted_at"] is None:
            check(time.monotonic() < deadline + 120, "(a) no adoption")
            time.sleep(0.005)
        mem_at("after_adopt")
        apply_all(["A"])
        t_first = time.monotonic()
        death = sup.stats()["deaths"][0]
        adopter = sup.owner_of(sid["A"])
        check(adopter != victim, f"(a) A still on {victim}")
        adopt = sup.client(adopter).info()["last_adopt"]
        check(not adopt["recovered_stale"],
              f"(a) the adoption found stale sessions: {adopt}")
        check(adopt["wal_replayed"] + adopt["wal_deduped"] == 1,
              f"(a) the adoption landed the in-flight job "
              f"{adopt['wal_replayed']} + {adopt['wal_deduped']} times")
        a_exact = exact(["A", "S"], "(a)")
        # the victim's restart ran beside the checks
        deadline = time.monotonic() + FLEET_READY_TIMEOUT_S
        while {w["state"] for w in sup.stats()["workers"].values()} \
                != {"healthy"}:
            check(time.monotonic() < deadline,
                  f"(a) {victim} never came back: {sup.stats()['workers']}")
            time.sleep(0.05)
        st = sup.stats()["workers"][victim]
        check(st["crashes"] == 1 and st["restarts"] >= 1,
              f"(a) {victim} crashes {st['crashes']}, restarts "
              f"{st['restarts']}")
        mem_at("after_a")
        ld = adopt["load"] or {}
        out["a"] = {
            "victim": victim, "pid": vpid, "adopter": adopter,
            "sessions_moved": len(death["sessions"]),
            "detected_ms": (death["detected_at"] - t_kill) * 1e3,
            "adopted_ms": (death["adopted_at"] - t_kill) * 1e3,
            "inflight_return_ms": (t_return - t_kill) * 1e3,
            "first_result_ms": (t_first - t_kill) * 1e3,
            "adoption_recover_s": adopt["recover_s"],
            "adoption_loads": ld.get("loads"),
            "adoption_read_s": ld.get("read_s"),
            "adoption_hash_wait_s": ld.get("hash_wait_s"),
            "adoption_read_bytes": ld.get("bytes"),
            "adoption_read_gbps": (ld["bytes"] / ld["read_s"] / 1e9
                                   if ld.get("read_s") else None),
            "wal_replayed": adopt["wal_replayed"],
            "wal_deduped": adopt["wal_deduped"],
            "restarted_boot_to_ready_s": st["boot_to_ready_s"],
            "snapshot_load_here": a_exact["A"]}
        lap("a")

        # ---- (b) a rolling restart with all four sessions live -------
        # (c)'s third worker boots beside it: the restart lists its
        # workers when it starts, so the boot waits for the first drain
        before = {k: sup.owner_of(v) for k, v in sid.items()}
        before["G"] = sup.owner_of(g)
        names = set(sup.worker_names())
        boot = {}

        def booting():
            deadline = time.monotonic() + 60
            while all(w["state"] == "healthy"
                      for w in sup.stats()["workers"].values()):
                if time.monotonic() > deadline:
                    boot["ok"] = "the rolling restart never drained"
                    return
                time.sleep(0.005)
            t0 = time.monotonic()
            boot["ok"] = sup.boot_worker()
            boot["s"] = time.monotonic() - t0

        t_boot = threading.Thread(target=booting)
        t_boot.start()
        rr = sup.rolling_restart()
        moved = set()
        for name, r in rr.items():
            check(not r["needed_kill"], f"(b) {name} needed SIGKILL")
            moved |= set(r["migrated"])
        check(moved >= set(sid.values()) | {g},
              f"(b) sessions not migrated: {set(sid.values()) - moved}")
        apply_all(["A", "B", "S"])
        check(abs(front.prob(g, FLEET_STAB_WIDTH - 1) - 0.5) < 1e-9,
              "(b) the GHZ lost its correlation")
        b_exact = exact(["A", "B", "S"], "(b)")
        mem_at("after_b")
        out["b"] = {"parts_s": {n: r["parts_s"] for n, r in rr.items()},
                    "migrated": {n: len(r["migrated"]) for n, r in rr.items()},
                    "owners_before": before,
                    "boot_to_ready_s": {
                        n: w["boot_to_ready_s"]
                        for n, w in sup.stats()["workers"].items()},
                    "snapshot_load_here": b_exact["A"]}
        lap("b")

        # ---- (c) the third worker, booted beside (b); D is created on
        # a live worker and served, and D's owner retired onto a peer
        t_boot.join(FLEET_READY_TIMEOUT_S + 60)
        check(boot.get("ok") is True, f"(c) boot_worker failed: {boot}")
        booted = sorted(set(sup.worker_names()) - names)
        sid["D"] = front.create_session(FLEET_WIDTH, seed=seeds["D"],
                                        rand_global_phase=False)
        apply_all(["D"])
        boot_s = boot["s"]
        retired = sup.owner_of(sid["D"])
        rpid = sup.stats()["workers"][retired]["pid"]
        t0 = time.monotonic()
        sd = sup.scale_down(retired)
        sd_s = time.monotonic() - t0
        check(sd is not None and sid["D"] in sd["migrated"]
              and retired not in sup.worker_names(),
              f"(c) scale_down({retired}) returned {sd}")
        apply_all(["D"])
        c_exact = exact(["D"], "(c)")
        m = sup.metrics(write=True)
        check(f"{retired}:{rpid}" in m["workers"],
              f"(c) the retired {retired}'s metrics left the merge")
        with open(sup.telemetry_path) as f:
            recs = [json.loads(x) for x in f]
        check(any(f"{retired}:{rpid}" in r.get("workers", {}) for r in recs
                  if r.get("kind") == "fleet"),
              "(c) the retired worker's metrics are not in the fleet JSONL")
        mem_at("after_c")
        out["c"] = {"booted": booted, "boot_worker_s": boot_s,
                    "retired": retired, "scale_down_s": sd_s,
                    "migrated": sd["migrated"],
                    "snapshot_load_here": c_exact["D"]}
        lap("c")

        # ---- every ket against a direct QEngineCUDA run --------------
        direct = {}
        for k in ("A", "B", "D", "S"):
            if widths[k] == FLEET_WIDTH:
                planes = settled(k)[0]
            else:
                ket = np.asarray(front.get_state(sid[k]))
                planes = torch.from_numpy(np.stack(
                    [ket.real, ket.imag]).astype(np.float32)).to(dev)
            eng = qt.create_quantum_interface("cuda", widths[k], device=dev,
                                              rand_global_phase=False)
            for c in jobs[k]:
                c.Run(eng)
            err, _ = held_to_plain(planes, eng.device_planes,
                                   f"session {k} against a direct "
                                   "QEngineCUDA run")
            direct[k] = err
            del planes, eng
            release()
        mall = front.measure_all(g)
        check(mall in (0, (1 << FLEET_STAB_WIDTH) - 1),
              f"the w{FLEET_STAB_WIDTH} GHZ measured {mall}")
        lap("direct")

        # ---- the workers: deaths, kernel cache hits, launches -------
        deaths = sup.stats()["deaths"]
        check([(d["worker"], d["pid"], d["reason"]) for d in deaths]
              == [(victim, vpid, "exit")],
              f"deaths other than the injected kill: {deaths}")
        infos = {n: sup.client(n).info() for n in sup.worker_names()}
        # every incarnation's kernel cache counters, from its beats (the
        # killed and the retired ones included)
        hits = sup.incarnation_counters("compile.kernel.")
        key = f"{victim}:{vpid}"
        if not hits.get(key):
            hits[key] = {k: v for k, v in
                         pre_kill_info["telemetry"]["counters"].items()
                         if k.startswith("compile.kernel.")}
        merged = sup.metrics()["counters"]
        misses = {k: v for k, v in merged.items()
                  if k.startswith("compile.kernel.") and k.endswith(".miss")}
        check(not misses, f"a worker built a kernel library: {misses}")
        launches = sup.kernel_launches()
        if sum(launches.get(key, {}).get("window", {}).get(
                "float32", {}).values()) < sum(pre_kill.get("window", {}).get(
                "float32", {}).values()):
            launches[key] = pre_kill
        total = {"in_tile": 0, "pair": 0}
        per_worker = {}
        for key, k in launches.items():
            f32 = k.get("window", {}).get("float32", {})
            per_worker[key] = dict(f32)
            for e in total:
                total[e] += f32.get(e, 0)
        for key, f32 in per_worker.items():
            if f32.get("in_tile", 0) + f32.get("pair", 0) == 0:
                continue
            check(hits.get(key, {}).get("compile.kernel.window_kernel.hit",
                                        0) >= 1,
                  f"{key} launched with no kernel cache hit: "
                  f"{hits.get(key)}")
        check(total["in_tile"] > 0 and total["pair"] > 0,
              f"phase 43 launched K1 or K2 no time: {total}")
        out["workers"] = {
            "kernel_cache": hits, "launches": per_worker,
            # beside the served jobs' planned sweeps: the launches add
            # each boot's prewarm (every recorded program once) and the
            # adopter's WAL replay
            "launches_total": total, "planned_sweeps": planned[0],
            "device_bytes": {n: i["device_bytes"] for n, i in infos.items()},
            "ttfr_s": {n: i["ttfr_s"] for n, i in infos.items()}}
        out["direct_max_abs_err"] = direct
        out["deaths"] = [{"worker": d["worker"], "reason": d["reason"]}
                         for d in deaths]
        out["device_used_bytes"] = mem
    finally:
        ref.close()
        run.close()
        release()
    out["seconds"] = time.time() - t_phase
    out["budget_s"] = FLEET_PHASE_S
    emit(out)
    return {"float32": total}


def cuda_engines(q) -> list:
    """Every QEngineCUDA reachable from a stack (its units' engines)."""
    from qrack_tpu_torch.engines.cuda import QEngineCUDA
    from qrack_tpu_torch.engines.hybrid import QHybrid

    seen, out, todo = set(), [], [q]
    while todo:
        o = todo.pop()
        if o is None or id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, QEngineCUDA):
            out.append(o)
            continue
        if isinstance(o, QHybrid):
            todo.append(o._engine)
        for attr in ("engine", "stab"):
            todo.append(getattr(o, attr, None))
        for s in getattr(o, "shards", None) or []:
            todo.append(getattr(s, "unit", None))
    return out



def page_entries(probe, launches: dict) -> list:
    """The kernels-line entries of K1 and K2 in their per-page form:
    launches over the pager phases; times, plain times and errors over
    the launches PageProbe held to plain (phase 29, pages of 2^28); the
    w32 engine path's every launch (pages of 2^30) beside its bound."""
    kernels = []
    for name, k in (("in_tile", "K1"), ("pair", "K2")):
        s = probe.stats.get(name, {})
        l30 = PAGE_L30.get(name, {})
        kernels.append({
            "name": f"window_{name}_per_page", "id": k, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[name],
            "form": "per page (qrack_tpu/ops/fusion.py:787)",
            "launches": launches[name],
            "probed_launches": s.get("launches", 0),
            "max_abs_err": s.get("max_abs_err"),
            "max_rel_err": s.get("max_rel_err"),
            "ms": s.get("ms"), "plain_ms": s.get("plain_ms"),
            "bound_ms": s.get("bound_ms"),
            "bound_by": "bytes" if s.get("bytes_ms", 0) >= s.get("ops_ms", 0)
            else "operations",
            "library_ms": None,
            "l30_launches": l30.get("launches"), "l30_ms": l30.get("ms"),
            "l30_bound_ms": l30.get("bound_ms")})
    return kernels


def dtype_entries(probe, launches: dict) -> list:
    """The kernels-line entries of the float64, bfloat16 and float16 forms
    of K1 and K2: launches over the paths that run them, times and errors
    over the launches `probe` held to plain."""
    from qrack_tpu_torch.ops.gatekernels import dtype_name

    kernels = []
    for dt in FPPOW_DTYPES:
        name = dtype_name(dt)
        for entry, k in (("in_tile", "K1"), ("pair", "K2")):
            s = probe.stats[f"{entry}_{name}"]
            kernels.append({
                "name": f"window_{entry}_{name}", "id": k, "dtype": name,
                "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[entry],
                "launches": launches.get(name, {}).get(entry, 0),
                "probed_launches": s["launches"],
                "max_abs_err": s["max_abs_err"],
                "max_rel_err": s["max_rel_err"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms"],
                "bound_by": "bytes" if s["bytes_ms"] >= s["ops_ms"]
                else "operations",
                "library_ms": None, "copy_ms": s.get("copy_ms")})
    return kernels


def main_path_instances(wk) -> list:
    """The window kernel's template instances of a full-width tile:
    window_tiles<T, R, pair> with R = window_kernel.reg_bits."""
    ctype = {torch.float32: "float", torch.float64: "double",
             torch.float16: "__half", torch.bfloat16: "__nv_bfloat16"}
    return [f"window_tiles<{ctype[dt]}, {wk.reg_bits(dt, pair)}, "
            f"{'true' if pair else 'false'}>"
            for dt in wk.DTYPE_CODE for pair in (False, True)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    if "--cluster-worker" in sys.argv[1:]:
        kind = sys.argv[sys.argv.index("--cluster-worker") + 1]
        print("RESULT " + json.dumps(cluster_worker(kind)), flush=True)
        return 0
    if "--serve-worker" in sys.argv[1:]:
        i = sys.argv.index("--serve-worker")
        store, device = (sys.argv[i + 1:i + 3] + [DEVICE])[:2]
        print("RESULT " + json.dumps(serve_worker(store, device)),
              flush=True)
        return 0
    flags = ("--tq-only", "--algo-only", "--fppow-only", "--layers-only",
             "--pager-only", "--wide-only", "--telemetry-only",
             "--resilience-only", "--checkpoint-only", "--route-only",
             "--cluster-only", "--serve-only", "--fleet-only")
    store = None
    if ("--serve-only" in sys.argv[1:]
            or not any(f in sys.argv[1:] for f in flags)):
        # phase 42's store; its kernel_cache is the run's build directory
        store = serve_store_dir()
        os.environ["QRACK_TPU_KERNEL_CACHE"] = os.path.join(store,
                                                            "kernel_cache")
    try:
        return run(store)
    finally:
        if store is not None:
            import shutil

            shutil.rmtree(store, ignore_errors=True)


def run(store) -> int:
    """The phases (module docstring); `store` is phase 42's, or None when
    a flag leaves that phase out."""

    from qrack_tpu_torch.ops import cuda_build
    from qrack_tpu_torch.ops import turboquant_kernel as tqk
    from qrack_tpu_torch.ops import window_kernel as wk

    tq_only = "--tq-only" in sys.argv[1:]
    algo_only = "--algo-only" in sys.argv[1:]
    fppow_only = "--fppow-only" in sys.argv[1:]
    layers_only = "--layers-only" in sys.argv[1:]
    pager_only = "--pager-only" in sys.argv[1:]
    wide_only = "--wide-only" in sys.argv[1:]
    telemetry_only = "--telemetry-only" in sys.argv[1:]
    resilience_only = "--resilience-only" in sys.argv[1:]
    checkpoint_only = "--checkpoint-only" in sys.argv[1:]
    route_only = "--route-only" in sys.argv[1:]
    cluster_only = "--cluster-only" in sys.argv[1:]
    serve_only = "--serve-only" in sys.argv[1:]
    fleet_only = "--fleet-only" in sys.argv[1:]
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device(DEVICE)

    # ---- 1. device and build: one nvcc per source, all at once ----------
    t0 = time.time()
    cuda_build.build([wk.SOURCE, tqk.SOURCE])
    wk.load_library()
    tqk.load_library()
    # ptxas's report of each library's build, kept beside it (so also
    # when an earlier run built it)
    ptxas = {src.name: cuda_build.ptxas_report(cuda_build.build_log(src))
             for src in (wk.SOURCE, tqk.SOURCE)}
    emit({"phase": "build", "card": card, "seconds": time.time() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})
    # the K1/K2 instances of a tile of 2^R or more amplitudes (every
    # launch of the main paths, at bp = 12) must not spill; narrower
    # tiles take the smaller instances
    report = {r["kernel"]: r for r in ptxas[wk.SOURCE.name]}
    for name in main_path_instances(wk):
        r = report.get(name)
        check(r is not None, f"ptxas reports no {name}")
        check(not (r["spill_stores"] or r["spill_loads"]),
              f"{name} spills: {r}")

    only = (tq_only or algo_only or fppow_only or layers_only or pager_only
            or wide_only or telemetry_only or resilience_only
            or checkpoint_only or route_only or cluster_only or serve_only
            or fleet_only)
    tableau = stack_native(card) if layers_only or not only else None
    probe = SweepProbe(wk)
    paths = {}   # path -> launches by dtype name
    if not only:
        paths["qft"] = {"float32": dense_phases(card, dev, probe)}
    tq_kernels = tq_phases(card, dev) if tq_only or not only else []
    if algo_only or not only:
        for name, fn in (("alu_vs_oracle", alu_vs_oracle),
                         ("alu_w30", alu_round_trips)):
            paths[name] = {"float32": fn(card, dev)}
        paths["shor"] = {"float32": shor_phase(card, dev, probe)}
        for name, fn in (("hybrid_rcs", hybrid_rcs), ("grover", grover_phase)):
            paths[name] = {"float32": fn(card, dev)}
    if fppow_only or not only:
        paths["fppow"] = fppow_phase(card, dev, probe)
        paths["drift"] = drift_phase(card, dev)
        paths["circuit_forms"] = circuit_forms_phase(card, dev)
        paths["uc_wide"] = uc_wide_phase(card, dev)
    if layers_only or not only:
        before = tableau.total()
        qv = qv_optimal(card, dev)
        paths["qv_optimal"] = {"float32": qv["optimal"]}
        paths["qv_cuda"] = {"float32": qv["cuda"]}
        paths["qft_cuda_w30"] = {"float32": qft_optimal(card, dev)}
        clifford_wide(card, dev)
        paths["stab_switch"] = {"float32": stab_switch(card, dev)}
        check(tableau.total() > before,
              "the layer phases made no native tableau call")
        emit({"phase": "layers_native", "card": card,
              "native_calls": dict(tableau.calls)})
        t0 = time.time()
        bdt_wide(card, dev)
        paths["bdt_attached_cuda"] = {"float32": bdt_attached(card, dev)}
        paths["bdt_switch"] = {"float32": bdt_switch(card, dev)}
        tn = tn_cone(card, dev)
        paths["tn_cone"] = {"float32": tn["cones"]}
        paths["tn_cuda"] = {"float32": tn["cuda"]}
        noisy = noisy_stack(card, dev)
        paths["noisy_stack"] = {"float32": noisy["stacks"]}
        paths["noisy_cuda"] = {"float32": noisy["cuda"]}
        paths["traj_cuda"] = {"float32": trajectories(card, dev)}
        emit({"phase": "slice8_phases", "card": card,
              "seconds": time.time() - t0})
    page_kernels = []
    page_probe = None
    if pager_only or not only:
        t0 = time.time()
        page_probe = PageProbe(wk, PAGER_SEED, PAGER_HELD)
        page_paths = {"pager_parity": pager_parity(card, dev, page_probe)}
        for path, got in pager_qft(card, dev).items():
            page_paths[f"pager_qft_{path}"] = got
        page_paths["pager_w33"] = pager_w33(card, dev)
        page_paths["pager_factory"] = pager_factory(card, dev)
    if wide_only or not only:
        t1 = time.time()
        if wide_only:
            page_paths, page_probe = {}, None
        page_paths["wide_ops"] = wide_ops(card, dev)
        page_programs(card, dev)
        tq_pager(card, dev)
        paths["unit_multi"] = {"float32": unit_multi(card, dev)}
        emit({"phase": "pager_rest", "card": card,
              "seconds": time.time() - t1})
    if telemetry_only or not only:
        t1 = time.time()
        tele = telemetry_phase(card, dev)
        paths["telemetry"] = {"float32": tele["dense"]}
        if page_probe is not None:
            page_paths["telemetry_pager"] = tele["pager"]
        for entry in tq_kernels:
            entry["launches"] += tele["tq"][entry["name"][len("tq_"):]]
        emit({"phase": "telemetry_seconds", "card": card,
              "seconds": time.time() - t1})
    if resilience_only or not only:
        got = resilience_phase(card, dev)
        paths["resilience"] = {"float32": got["dense"]}
        if page_probe is not None:
            page_paths["resilience_pager"] = got["pager"]
        for entry in tq_kernels:
            entry["launches"] += got["tq"][entry["name"][len("tq_"):]]
    if checkpoint_only or not only:
        got = checkpoint_phase(card, dev)
        paths["checkpoint"] = {"float32": got["dense"]}
        if page_probe is not None:
            page_paths["checkpoint_pager"] = got["pager"]
        for entry in tq_kernels:
            entry["launches"] += got["tq"][entry["name"][len("tq_"):]]
    if route_only or not only:
        got = route_phase(card, dev)
        paths["route"] = got["dense"]
        for entry in tq_kernels:
            entry["launches"] += got["tq"][entry["name"][len("tq_"):]]
    if cluster_only or not only:
        got = cluster_phase(card, dev)
        if page_probe is not None:
            page_paths["cluster"] = got
    # phase 43's workers boot while phase 42 runs
    fleet = FleetRun() if fleet_only or not only else None
    try:
        if serve_only or not only:
            paths["serve"] = serve_phase(card, dev, store)
        if fleet is not None:
            paths["fleet"] = fleet_phase(card, dev, fleet)
    finally:
        if fleet is not None:
            fleet.close()   # no worker outlives the script
    if page_probe is not None:
        page_total = {k: sum(p[k] for p in page_paths.values())
                      for k in ("in_tile", "pair")}
        emit({"phase": "pager_launches", "card": card, "paths": page_paths,
              "total": page_total, "seconds": time.time() - t0})
        page_kernels = page_entries(page_probe, page_total)
    kernels = []
    if paths:
        launches = {dt: {k: sum(p.get(dt, {}).get(k, 0)
                                for p in paths.values())
                         for k in ("in_tile", "pair")}
                    for dt in wk.DTYPE_LAUNCHES}
        emit({"phase": "dense_launches", "card": card, "paths": paths,
              "total": launches})
        if "qft" in paths:
            kernels = window_entries(probe, launches["float32"])
        if "fppow" in paths:
            kernels += dtype_entries(probe, launches)
    kernels += tq_kernels + page_kernels
    emit({"phase": "done", "card": card, "seconds": time.time() - T_START})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

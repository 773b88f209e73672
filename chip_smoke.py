"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them:
the GPMP2-MPC main path (phases 2-6), config 3's EE-pose goal and config
1's IK (phases 6a-6b), the batched iLQR path (phases 7-11),
the multi-robot MPC path (phases 12-15), the point-mass batch solve with
GN factorization reuse and the point-cloud SDF (phases 16-20), sGPMP
for the Panda and the config-4 robot with the solvers nothing routes to
(phases 21-25), the learned self-collision Panda's net row through
the terms, the cost and the main path (phases 26-28), the scenes
whose spheres are precomputed into an SDF grid, with the grid branch of
K1, K5 and K8 (phases 29-32), the Panda holding a grasped box, with
the grasped-point branch of K1, K5 and K8 (phases 33-36), config 2's
hybrid leg, CHOMP and config 5's sharded MPC (phases 37-39), the MPOT
-> GPMP2 pipeline and the planar 2-link arm's generic GN step (phases
40-41), config 1's FK over the robot zoo, the terms kernel past eight
joints and the 14-joint dual-arm TIAGo's MPC and sGPMP (phases 42-45),
the MultiRobot cells past K5's first caps (phases 46-49, five Pandas'
MPC through the column sweep's shared-memory route), that route alone
(phase 50), the PD execution harness (phase 51), the examples that
drive the solvers (phase 52), CHOMP's autodiff branch (phase 53), the
SE(3) / manifold layer (phase 54) and serialization with the profiler's
trace (phase 55).

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line; any failure exits nonzero before the
final line):

1. build   - nvcc builds every CUDA kernel of the paths from csrc/ (one
             process per source, all at once: terms.cu, btridiag.cu,
             riccati.cu, mr_terms.cu, btridiag_cols.cu, sphere_sdf.cu,
             btridiag_cr.cu, gn_assembly.cu, cost.cu, net_row.cu);
             prints build seconds (all, and each source's), the register
             and spill report of each kernel's launched instantiation (of
             the Riccati sweep every d = 1..8, of the column sweep every
             padded width, none of which may spill; the cost kernel may
             have no stack frame either, nor may any terms_kernel<D>, D =
             1..8, or substitution kernel), and the card's name and power
             limit (every terms_wide_kernel<16, 24, 32> no stack frame
             and no spill either); the net row's tensor-core kernels may
             not spill and
             must show HMMA in cuobjdump -sass; the MultiRobot terms
             kernel, every rollout_kernel<D>, D = 1..8, and the sphere SDF
             kernel may have no stack frame and no spill either; the
             sphere SDF kernel's SASS instructions a (point, sphere) pair
             on its hot loop's common path (sdf_pair_instructions).
2. terms   - the fused GN-terms kernel vs its plain PyTorch version on the
             card: Panda in EnvSpheres3D at N = 64 * 1024 waypoints (the
             main path's first q, timed, and random q), plus a rounded-box
             scene and a rotated sharp-box scene with a tight workspace and
             wide self-collision margins at N = 4096; a lane's bits the
             same at a ragged N = 1000 and at 32 lanes a block.
3. solve   - the block-tridiagonal sweep vs its plain version: the first GN
             system of the main-path problem (H = 64, m = 14, B = 1024), a
             well-conditioned random system, and both at a ragged B = 100;
             at every instantiated m (2, 4, ..., 16) the sweep, the factor
             sweep and the substitution from its factors on a random (8, m,
             m, 100) system; timed with the dense torch.linalg.solve, and
             on the GN system's first 8 lanes.
4. main    - the main path: receding-horizon MPC for the 7-DoF Panda in
             EnvSpheres3D, B = 1024, H = 64, 2 GN iterations per step, 8
             steps, start/goal drawn from a numpy seed as bench.py draws
             them; launch counts, finiteness, solves/s, a profile.
5. cpu     - one MPC step at B = 32, H = 64 on the card and on the CPU,
             each held to a float64 CPU step, GN iteration by GN iteration
             from the same input and over the chained step.
6. fk      - FK rollouts/s at B = 65536 through fk_positions_lanes.
6a. ee_goal - config 3 (benchmarks/run_all.py config_panda): the Panda in
             EnvSpheres3D, cutoff 0.03, B = 4096, H = 64, its GPMP2Params,
             an EE-pose goal factor (the goal's ee_link pose, sigma_ee
             1e-3, w_rot 0.2) on the final waypoint, config_panda's own
             start and goal; the factor on the card vs float64 on random
             q; one GN step with it held on its first 8 lanes to a float64
             CPU step (phase cpu's rule); K1 (N = 262,144) and K2 (64, 14,
             4096) on the path's first q and GN system vs plain, timed,
             K2 with the dense solve; gpmp2_solve_restarts (30 iterations,
             2 rounds of 30): exactly 90 K1 and 90 K2 launches, finite
             outputs, fraction free >= 0.95 and median EE position error
             <= 0.01 m, wall, trajs/s, a profile.
6b. ik     - config 1's IK (run_all.py config_fk_ik): damped least squares
             (inverse_kinematics_gn) at B = 1024, 150 iterations, restarts
             every 25, se3_eps 5e-2: valid fraction >= 0.9, finite; 40
             steps without restarts on its first 64 problems held to a
             float64 CPU run step by step (worst and median lanes) and
             chained (median lane, valid count); Adam (inverse_kinematics)
             at B = 1024 and 300 iterations runs finite; no kernel
             launches; valid fraction, median iterations, wall of both.
7. riccati - the Riccati sweep (K6) and the line-search rollout (K7) vs
             their plain versions at the iLQR path's shapes (T = 31, d = 7,
             m = 14, P = 27, A = 5, B = 512) and at a ragged B = 100: on
             random well-conditioned inputs, and on the inputs of the
             path's first iteration (K6 also the tracking loop's, T = 15,
             P = 34) held to a float64 plain version, K7 too at T = 15;
             K6 on random inputs at every d = 1..8 (P = 1 and 27, B =
             100), at a P that takes fewer lanes per block and at the P
             cap; K7 on random inputs at every d = 1..8 (T = 6, B = 100),
             a lane's bits the same at B = 4096 (the inputs tiled), 510,
             509 and 100, which take 4, 2, 1 and 4 lanes a block; timed
             (K6 at T = 31 and T = 15 by CUDA events, K7 at T = 31 over a
             CUDA graph of calls).
8. cost    - the value-only collision cost (K8) vs its plain version on the
             path's line-search q (N = A B T = 79360), on random q, on
             phase 21's first candidate q (N = 2097152) and on random q
             with the spheres' radii spread over 0.6-1.4x; a lane's bits
             the same at a ragged N and at 32 lanes a block; timed at both
             shapes (K8's device time over a CUDA graph of calls: at N =
             79360 a call's host time exceeds it).
9. ilqr    - the iLQR path (benchmarks/ilqr_sgpmp_bench.py "ilqr_batch"):
             Panda in EnvSpheres3D, cutoff 0.06, B = 512, H = 32, 30
             iterations, start/goal drawn as the bench draws them (seeded);
             launch counts (exactly 30 / 30 / 31), finiteness, dynamics
             feasibility, fraction free, goal distance, solves/s, ms per
             iteration, a profile.
10. ilqr_cpu - at B = 32, one iteration on the card and on the CPU held to
             a float64 CPU iteration; the whole solve's fraction free and
             median goal distance near the CPU float32 run's.
11. ilqr_mpc - the bench's tracking loop (H = 16, 3 iterations per step,
             30 steps, B = 512) through the same kernels; exactly 90 K6
             and K7 launches; K7 on the loop's first rollout (T = 15)
             timed over a CUDA graph of calls.
12. mr_terms - the MultiRobot terms kernel (K5) vs its plain version at
             N = H B = 8192 on the config-4 robot (Panda, Panda, UR10;
             benchmarks/run_all.py config_multi_robot): the path's first q
             (straight-line plans), random in-limit q, and random q at a
             tighter pose set (bases 0.5 m apart) where many mutual rows
             are active, and a two-arm robot at N = 4096; a lane's bits
             the same at a ragged N = 1000 and (two arms) at 64 lanes a
             block; timed over a CUDA graph of calls.
13. mr_solve - the column sweep (K4) vs its plain version at (H, m, m, B)
             = (32, 40, 40, 256): a random well-conditioned system, the
             path's first GN system held to a float64 solve, and both at a
             ragged B = 100 (bit for bit the B = 256 lanes, and the same
             bits at one and two lanes a block); random systems at every
             padded width the kernel is built for (24, 32, 40, 48, 64) and
             at m = 17; timed, with the dense torch.linalg.solve.
14. mr_mpc  - the config-4 path at full size: B = 256, H = 32, 30 MPC
             steps of 2 GN iterations (mpc_rollout); launch counts (exactly
             60 / 60), finiteness, solves/s, ms per step, collision-free
             starts, goal distance, executed paths free, a profile.
15. mr_cpu  - one config-4 MPC step at B = 16 on the card and on the CPU,
             each held to a float64 CPU step, iteration by iteration.
16. pm_solve - config 2 (benchmarks/run_all.py config_pointmass): the point
             mass in EnvDense2D, cutoff 0.02, the scene's GPMP2 preset with
             B = 1024 samples of the GP prior and 150 iterations
             (gpmp2_solve); launches exactly 150 K2 at m = 4 and no K1,
             finiteness, trajs/s, ms per iteration, fraction free, mean
             final cost, a profile; K2 at m = 4 vs its plain version on the
             first GN system, timed with the dense torch.linalg.solve of
             the (1024, 256, 256) system; 3 card iterations at B = 256 held to a
             float64 CPU run beside the CPU float32 run.
17. pm_restarts - config 2's restart policy (run_all.py): 75 iterations,
             sigma_gp_init 0.5, 6 rounds of 50 (gpmp2_solve_restarts),
             exactly 375 K2 launches; lanes free after the main solve kept
             bit for bit, the free fraction not lower.
18. k9     - the factor-persisting sweep and the substitution sweep (K9) vs
             their plain versions on config 2's first GN system (m = 4), on
             the reuse workload's (m = 14) and on a random system, and at a
             ragged B = 100; the substitution through its ring of stages
             bit for bit with L and W kept on chip; timed at the reuse
             shapes with the dense Cholesky and cholesky_solve, and beside
             K2 on the same system.
19. reuse  - GN factorization reuse on benchmarks/gn_reuse_ab.py's batch
             solve (Panda in EnvSpheres3D, cutoff 0.03, B = 256, H = 32, 48
             iterations, sigma_coll 5e-3) at refactor_every 1, 2 and 4;
             launch counts exact for each, quality and ms per iteration,
             and a profile of each (device ms per iteration by kernel, busy
             share).
20. point_cloud - the sphere SDF (K10) through PointCloudSpheres at M =
             65536 points and S = 4096 spheres of radius 0.02, vs its plain
             version (1e-5); also with per-sphere radii 0.05-0.3 (many
             points inside a sphere) at S = 4096 and at S = 4173 (no stage
             of spheres divides it), at M = 1000 and at a ragged M = 1000,
             S = 129; S = 127 takes the plain route; the kernel's device
             time over a CUDA graph of calls, timed with torch.cdist.
21. sgpmp  - sGPMP (benchmarks/ilqr_sgpmp_bench.py "sgpmp"): the iLQR
             path's problems (B = 512), 8 GP-prior particles each (4096
             trajectories), H = 32, 100 iterations of K = 16 samples,
             sigma_coll 1e-5; launches exactly 201 K8 and nothing else,
             finiteness, particle solves/s, problems/s, fraction free
             (particles, problems with a free particle) before and after,
             ms per iteration, a profile.
22. sgpmp_cpu - at B = 32 (each problem's first particle), one iteration
             from the same normals on the card and on the CPU held to a
             float64 CPU iteration (candidate costs and accepted means);
             the whole solve's fraction free within 3 of 32 lanes of the
             CPU float32 run's.
23. mr_cost - K8's MultiRobot branch vs its plain version: path 24's first
             candidates (N = 131072) and proposal q (N = 8192, which the
             acceptance scores), and random q at the tight poses (mutual
             rows active); a lane's bits the same at a ragged N and at 32
             lanes a block; timed at both shapes, with K5 on the
             candidates.
24. mr_sgpmp - sGPMP on config 4's robot: B = 256 problems from mr_problem,
             one particle each, H = 32, dt = 0.05, 100 iterations of K =
             16; launches exactly 201 K8-MultiRobot and nothing else; the
             metrics of phase 21.
25. solvers - the L-and-y sweep (K3, trsm and trsv tails) and block cyclic
             reduction (K11) vs their plain versions on a random (64, 14,
             1024) system, the main path's first GN system (held to
             float64) and a ragged B = 100, K11 also at H = 48; K3's trsm
             tail against K2 bit for bit; timed in turns with K2 on the
             GN system (device time over a CUDA graph of calls) and
             beside the dense solve; K3 and K11 at (64, 14, 4096) and K11
             at H = 256 (m = 14, B = 1024) on random systems, held to
             their plain versions and timed in turns with K2.
             The GN assembly (K12) vs its plain version on the main path's
             first (r, Jr) and at ragged N = 1000 and 999; its device time
             over a CUDA graph of calls with the inputs rotated over 3
             copies (past the 50 MB L2), timed with one torch.bmm.
26. net_terms - the learned self-collision Panda (benchmarks/net_terms_ab.py:
             RobotPanda.create(use_learned_self_collision=True), the
             bundled 7-256-128-64-1 net): K1 + the net row (net_row.cu,
             its tf32x3 route, asserted for every net of the bundled
             widths) vs the plain terms on the main path's first q (N =
             64 * 1024)
             with the bundled net (its hinge is almost never active), a
             relu and a tanh "spread" net (numpy-seeded weights of the
             bundled widths, the output shift set from that q so that
             25-75% of the lanes are active), lanes within 1e-5 of the
             hinge excluded and counted (at most 0.1%); the row alone from
             zeros vs its plain contribution; timed with its plain version
             (the eager cuBLAS FP32 chain, also its library call) and K1,
             beside its FP32 bound and its 3xTF32 bound (495 / 3 TFLOP/s);
             both net-row kernels of three wider relu spread nets (the
             simt route at 16, 8 and 4 lanes a block) vs plain on 8192 of
             those lanes.
27. net_cost - K8 + the value-only net row vs the plain cost on the sGPMP
             path's proposal q (N = 131072) with the bundled and a spread
             net (the tf32x3 route asserted), the row alone; timed at the
             candidates' N = 2097152 and at the proposal's 131072, with
             both bounds;
             then the sGPMP path on the net Panda: exactly 201 K8 and 201
             net-cost launches, finite results.
28. net_main - the net Panda's main path: MPC at B = 1024, H = 64, 2 GN
             iterations per step, 8 steps, with the bundled and with a
             spread net: exactly 16 K1, 16 net-terms and 16 K2 launches
             per run, finite outputs, step ms, solves/s, fraction free, a
             profile with the net row's share; one step at B = 32 on the
             card and on the CPU held to a float64 CPU step (phase cpu's
             hold) on three start / goal draws, with the bundled, the
             spread and a scaled spread net: every GN iteration and the
             chained step's median lane on every draw; the chained step's
             worst lane, chaotic in float32, over the three draws together,
             at most twice that of the CPU's or the plain terms' on the
             card.
29. grid_main - the grid scene's main path (benchmarks/grid_sdf_bench.py
             "panda_spheres3d"): EnvSpheres3D precomputed into a 0.01 m
             grid (200^3 cells, its precompute timed), the Panda at B =
             4096, H = 64 from the joint-range midpoint to 0.5 rad past
             it, 8 chained GN steps of the bench's GPMP2Params in the
             grid scene and in the analytic one: exactly one K1 and one
             K2 launch a step, finite outputs, ms per GN step, solves/s
             (two GN steps a solve), a profile each; the first 512
             trajectories held to a float64 CPU run (phase cpu's rule, two
             steps from the card's input and chained), the CPU task
             carried across by convert.py with the card's grid values.
30. grid_terms - K1's grid branch vs its plain version on random q (N =
             65,536) and on grid_main's first q (N = 262,144), timed on
             both: a lane may be off the terms tolerance only where one of
             its object points (the plain FK's) lies within 1e-4 cell
             widths of a cell face, at most 0.1% of the lanes.
31. grid_cost - K8's grid branch vs plain at the same rule on random q (N
             = 79,360) and on the sGPMP Panda's first candidates in the
             grid scene (N = 2,097,152), a lane's bits at a ragged N and
             at 32 lanes a block, timed; then sGPMP on the Panda in the
             grid scene (phase sgpmp's workload): exactly 201 K8
             launches.
32. mr_grid - config 4's robot in the grid scene: K5 vs plain on the
             path's first q (N = 8192) and K8's MultiRobot branch on the
             sGPMP candidates (N = 131,072), timed; two MPC steps (exactly
             4 K5 and 4 K4 launches); config 4's sGPMP in the grid scene:
             exactly 201 K8-MultiRobot launches.
33. grasp_terms - K1's grasped branch vs its plain version on the Panda
             holding GraspedObjectPandaBox (benchmarks/pallas_terms_ab.py's
             grasped terms: EnvSpheres3D, cutoff 0.03, N = 64 * 1024): q
             uniform over the joint limits (numpy seed), the grasped main
             path's first q, a ragged N = 1000 (its lanes' bits those of
             the full launch) and in grid_main's 0.01 m grid (hold_grid);
             timed on both q beside the pair-field K1 on the same q, the
             bound from the active rows.
34. grasp_main - the main path with the grasped Panda (phase main's
             problem and sizes): exactly 16 K1 and 16 K2 launches, finite
             outputs, step ms, solves/s, a profile; one step at B = 32 on
             the card and on the CPU held to a float64 CPU step (phase
             cpu's rule).
35. grasp_cost - K8's grasped branch vs plain at the iLQR cutoff on
             random q (N = 79,360) and on the sGPMP Panda's first
             candidates (N = 2,097,152, the plain cost in chunks), a
             lane's bits at a ragged N and at 32 lanes a block, timed;
             then sGPMP at phase sgpmp's shape on the grasped Panda:
             exactly 201 K8 launches, fraction free before and after.
36. mr_grasp - config 4 with its first Panda holding a 0.08 m box
             (tests/test_multi_robot.py's), starts drawn free by its own
             check: K5 vs plain on the path's first q (N = 8192), two MPC
             steps (exactly 4 K5 and 4 K4 launches), K8's MultiRobot branch
             vs plain on the sGPMP candidates (N = 131,072) with a lane's
             bits at a ragged N and at 32 lanes a block, timed; config 4's
             sGPMP on it: exactly 201 K8-MultiRobot launches.
37. hybrid - config 2's hybrid leg (run_all.py:167-176): the point mass in
             EnvDense2D, cutoff 0.02, start (-0.9, -0.9), goal (0.9, 0.9),
             plan_hybrid with the scene's RRT-Connect preset (50,000
             pre-samples, max_time 50) and its GPMP2 preset at B = 1024 and
             150 iterations: RRT finds a path (the same path from the same
             seed twice) well inside max_time; exactly 150 K2 launches at
             (64, 4, 1024) and nothing else; finite outputs, endpoints
             within 2e-2, fraction free >= 0.5 (tests/test_hybrid.py's
             floors; the JAX package's 94.7-94.8% printed beside it);
             RRT seconds, its iterations, segment checks and ms a check,
             the whole call's wall, a profile of the refinement (5
             iterations from the seed); K2 on the seed's first GN system
             held to float64 and timed.
38. chomp  - CHOMP at BASELINE.md's size: the Panda in EnvSpheres3D,
             cutoff 0.03, B = 512 straight lines from bench_problem's start
             to its goal, H = 64, CHOMPParams' defaults with 50
             iterations: exactly 50 K1 (N = 32,768), 50 K8 (N = 32,768)
             and 50 K2 ((64, 14, 512)) launches; finite outputs; the first
             8 lanes held to a float64 CPU run, no worse than the CPU
             float32 run in the worst and the median lane (the CPU runs
             go in a process started before the build, and the first
             timed phase waits for them); the same lanes
             with the obstacle gradient scaled to ~0 (a control) must miss
             both limits by CH_CONTROL_MARGIN, and float64 must move theta
             by as much; K1, K8 and K2
             on the path's first inputs vs plain (K1's Hqq off the lanes
             at a hinge edge, HINGE_EDGE) and timed; wall, the cost
             trace's first and last values, fraction free, a profile.
39. pod    - config 5 on one card (run_all.py:295-337):
             mpc_rollout_sharded on a one-device mesh, B = 8192, H = 64,
             8 steps of 2 GN iterations, start and goal in the joint-range
             bands drawn from a seeded torch generator; at the reference's
             chunk of 256 exactly 512 K1 (N = 16,384) and 512 K2 ((64, 14,
             256)) launches, unchunked exactly 16 K1 (N = 524,288) and 16
             K2 ((64, 14, 8192)); the two runs agree to 1e-5 of max|x| with
             the same goal fraction; solves/s, goal fraction, a profile of
             each; the first chunk's first 8 lanes held to float64 as
             phase cpu holds its lanes; K1 and K2 at both shapes vs plain
             and timed.
40. mpot   - the MPOT -> GPMP2 pipeline (benchmarks/mpot_vs_gpmp2.py:
             111-160): the point mass, cutoff 0.01, B = 64 GP-prior samples
             of the scene's GPMP2 preset (H = 64), plan_mpot_gpmp2 with the
             scene's MPOT preset (sigma_start = sigma_goal = 1e-3) and a
             50-iteration polish, in EnvGridCircles2D (the reference's
             preset) and EnvDense2D (the tuned preset: 300 OT iterations,
             step 0.07, probe 0.09, 9 probes); exactly 50 K2 launches at
             (64, 4, 64) a scene, 100 where the fallback polish ran, and
             nothing else; finite outputs, endpoints within 2e-2; fraction
             free, path length and smoothness after the OT stage and after
             the pipeline (the JAX package's 0.984 and 0.906 printed
             beside them, from another draw), each stage's wall, a
             shortened pipeline's busy share; MPOT alone (20 OT
             iterations, 10 of each smoothing pass) on the first 16
             trajectories in EnvGridCircles2D on the card and on the CPU
             from the same inputs and rotations, held to a float64 CPU
             run (phase cpu's rule); K2 on the polish's first GN system
             held to float64 and timed.
41. planar2link - gpmp2_solve on RobotPlanar2Link in EnvPlanar2Link
             through the generic GN step (tests/test_planar2link_task.py:
             47-52: H = 32, 60 iterations, its start and goal) at B = 1024:
             no lanes hooks, exactly 60 K2 launches at (32, 4, 1024) and
             nothing else, finite outputs, the mean cost not higher at the
             end; the cost trace's first and last mean, fraction free,
             wall, busy share; its first 64 lanes held to a float64 CPU
             run (phase cpu's rule); K2 on the first GN system held to
             float64 and timed.
42. zoo_fk - config 1's FK (examples/forward_kinematics.py) over the zoo
             past the Panda and the UR10: the KUKA iiwa7, Habitat Stretch,
             both dual-arm TIAGos, the Shadow and Allegro hands and the
             UR10 with its suction gripper at B = 65,536: fk_all_links and
             fk_positions_lanes finite, the first 256 lanes held to a
             float64 CPU FK (2e-5 of the largest coordinate past 1 m), the
             goldens' q to tests/golden (the Shadow hand's lf* links left
             out, as the JAX package's test does); ms a call, rollouts/s.
43. wide_terms - K1's route past eight joints (terms_wide_kernel) vs
             its plain version at N = 65,536: the TIAGo (D = 14) in
             EnvTableShelf on random q and on q where its arms' pairs are
             active, the Shadow hand (D = 24) holding its ball on random
             q, held to the plain version in float64 at the terms
             tolerance, Hqq off the hinge-edge lanes; a lane's bits the
             same at a ragged N and at each lane count of 32, 64, 96 and
             128 that fits, timed over a CUDA graph at each (the launch's
             own keeps the most warps an SM); one MPC step of the Shadow
             hand (B = 1024, H = 64): exactly 2 K1 and 2 K4 launches; a
             33-joint chain's terms hook raises on the card and its cost
             hook runs K8 (at D = 33, five threads a lane) held to plain.
44. tiago_mpc - the dual-arm TIAGo (tasks/zoo_tasks.py: 13 sphere-table
             links, 36 left-right arm pairs) in EnvTableShelf at the main
             path's protocol (B = 1024, H = 64, 2 GN iterations a step, 8
             steps) from free start and goal draws: exactly 16 K1 (D = 14,
             N = 65,536) and 16 K4 ((64, 28, 28, 1024)) launches and
             nothing else; finite outputs, the active-row share on the
             first q, fraction free, goal distances, step ms, solves/s, a
             profile; one step at B = 32 held to float64 (phase cpu's
             rule); K1 (held as in phase 43) and K4 on the path's first
             inputs vs plain, timed, K4 beside the dense solve.
45. tiago_sgpmp - sGPMP on the TIAGo at phase sgpmp's shape (512 free
             problems x 8 particles, H = 32, 100 iterations of K = 16):
             K8 (D = 14, two threads a lane) vs plain on the first
             candidates (2,097,152) and proposal (131,072), a lane's bits
             at a ragged N and at 32 lanes a block, timed; exactly 201 K8
             launches and nothing else, the metrics of phase sgpmp; one
             iteration at B = 32 held to float64 (phase sgpmp_cpu's rule;
             not the whole solve on the CPU, ~60 s at D = 14).
46. mr_same_pair - config 4 with a mutual pair between two object points
             of its first Panda (MR_CELLS): the task builds with the
             reference's warning, its plain terms the generic padded
             assembly; K5 (the pair on the Panda's diagonal block) vs
             that plain version on the path's first q and on uniform q
             where the pair's row is active, Hqq off the hinge-edge lanes,
             timed; config 4's MPC (B = 256, H = 32, 30 steps of 2 GN
             iterations): exactly 60 K5 and 60 K4 launches and nothing
             else, one step at B = 16 held to float64 (phase mr_cpu's
             rule).
47. mr_net - config 4 with its first Panda carrying the learned net
             (read by neither package's MultiRobot rows; its own pairs
             stay): K5 vs plain on the first q, timed; config 4's MPC as
             in phase 46; config 4's sGPMP (one particle, H = 32, 100
             iterations of K = 16): K8-MultiRobot vs plain on the first
             candidates (131,072) with a lane's bits at a ragged N and 32
             lanes a block, timed, exactly 201 K8-MultiRobot launches and
             nothing else, one iteration at B = 32 held to float64.
48. mr_wide - the dual-arm TIAGo (14 joints) and a Panda (d = 21): K5 on
             its route with its sums in shared memory
             (mr_terms_kernel<16>) held to its plain version in float64
             on the first q, timed; the MPC of phase 46 with K4 at (32,
             42, 42, 256) and K4 on the first GN system held to float64,
             timed beside the dense solve; the sGPMP of phase 47 at D =
             21 (three threads a lane).
49. mr_five - five Pandas (d = 35, 15 block pairs on 10 warps): K5 vs
             plain on the first q at N = 8192 and a lane's bits at a
             ragged N, timed; the MPC of phase 46 with exactly 60 K5 and
             60 launches of K4's shared-memory route (btridiag_cols_wide,
             (32, 70, 70, 256) in width 80) and nothing else, one step at
             B = 64 held to float64; the sGPMP of phase 47 at 5 members
             (eight threads a lane).
50. cols_wide - K4's shared-memory route (csrc/btridiag_cols_wide.cu) on
             phase 49's first GN system vs plain, held to float64, timed
             over a CUDA graph beside its bound and the dense solve, and
             timed on its first 64 and 132 lanes (one lane an SM: the
             chain alone) and tiled to 1024 lanes (four waves); on random
             SPD systems at m = 96, 112 and 128 (H = 32, B = 64) vs plain,
             held to float64, timed; a lane's bits the same in every wider
             width; ptxas' report of its four instantiations, none with a
             stack frame or a spill; at m = 40
             solve_lanes_auto still takes the register route (one
             btridiag_cols launch, torch.equal to solve_lanes_cols), and
             the new route in width 80 is held to float64 beside it and
             timed; m = 129 refused in K4's words.
51. execute - the PD execution harness (sim/): phase 4's final plans (B =
             1024, H = 64) through MotionPlanningController on the card,
             no kernel launched, timed; held to a float64 CPU run of the
             same harness on the same plans (q and qd on the lanes whose
             frozen flags and contacts agree; the others counted).
52. examples - the four examples of torch_robotics_tpu_torch/examples/
             that drive the solvers, each main() on the card at its own
             size: mpc_panda (B = 32, 60 steps: exactly 120 K1 and 120 K2,
             then the PD harness), ilqr_panda (B = 64, with --track),
             multi_robot_mpc (B = 16, 150 steps: exactly 300 K5 and 300
             K4) and planning_point_mass (the scene's preset); every
             number finite; wall seconds and launches of each.
53. chomp_autodiff - CHOMP through autograd of the residuals: the planar
             2-link arm (no lanes hooks) at B = 1024, H = 32 with the
             planar GPMP2 test's dt and sigmas, 60 iterations at step
             and clip 1.0: exactly 60 K2 launches and nothing else,
             finite, the trace falls, its first 64 lanes held to a
             float64 CPU run (hold_to_f64) and a near-zero-gradient
             control missing that hold by 4x; then phase 38's Panda
             problem (B = 512, H = 64, 50 iterations) through the hooks
             (50 K1, 50 K8, 50 K2) and through the task's plain residuals
             (50 K2 alone), each held to phase 38's float64 CPU run by its
             own float32 CPU run; ms a solve, launches, busy share.
54. se3_manifold - ee_se3_cost of the Panda's fk_all_links at 65,536
             configurations; q_log_map / q_exp_map / q_parallel_transport
             between consecutive points, compute_traj_velocity and
             smooth_traj of a (1024, 64, 7) S^3 x R^3 batch; its Karcher
             mean: each off a CPU float64 run by at most twice the CPU
             float32 run's error + 1e-6 of max|ref|; 65,536 samples of a
             Gaussian at the mean from a CUDA generator, finite, on the
             card, on S^3 to 1e-6; ms of each.
55. serialize - (run right after phase 1, before any other profiler
             session) EnvSpheres3D precomputed at cell 0.05 and the Panda's
             KinematicModel saved to .npz and loaded onto the card; K1's
             grid branch on a task built from the loaded pair, one launch
             at N = 262,144, equal bit for bit to the original task's,
             under utils.profiling.trace_to with an annotate span that
             the written trace must hold beside a terms_kernel event
             (the trace taken again, up to 3 times, where a session
             missed the kernel); the files' bytes, save s and load ms.

Every phase line carries ``script_s``, its seconds since the script
started.  Then one JSON line with every kernel's numbers (launches from
phase 4 for K1 and K2, and from phase 6a's restarts solve for K1 and K2
on config 3's path (entries obstacle_terms_ee_goal and btridiag_w_ee_goal, timed at
that path's shapes), from phase 9 for K6, K7 and K8 at N = 79360, from phase 11 for
K7 at the tracking loop's T = 15, from phase 21 for
K8 at the sGPMP candidates' N, from phase 14 for K4 and K5, from phase 19
for K9 (the k = 2 and k = 4 runs together), from phase 20's query for
K10, from phase 24 for K8's MultiRobot branch at both of its shapes, from
one call each on the main path's inputs for K3, K11 and K12, from
phase 28's spread-net run for the net-terms row and from phase 27's sGPMP
run for the net-cost row; the grid branches from phase 29's grid run
for K1, phase 31's sGPMP for K8 and phase 32's MPC steps and sGPMP for
K5 and K8-MultiRobot; the grasped branches from phase 34's run for K1,
phase 35's sGPMP for K8 and phase 36's MPC steps and sGPMP for K5 and
K8-MultiRobot; phase 37's solve for K2 at m = 4 (btridiag_w_hybrid),
phase 38's for K1, K8 and K2 (the *_chomp entries) and phase 39's runs
for K1 and K2 chunked (*_pod) and unchunked (*_pod_unchunked), phase
40's two pipeline runs for K2 at (64, 4, 64) (btridiag_w_mpot) and phase
41's solve for K2 at (32, 4, 1024) (btridiag_w_planar2link), phase 44's
run for K1 at D = 14 (obstacle_terms_tiago) and K4 at (64, 28, 28, 1024)
(btridiag_cols_tiago), phase 43's Shadow step for K1 at D = 24
(obstacle_terms_shadow, timed on its random q) and phase 45's solve for K8
at D = 14 (collision_cost_tiago, timed at 2,097,152), phases 46-49's MPC
runs for K5 (multirobot_terms_same_pair, _net, _wide, _five, timed on
their first q) and K4 at (32, 42, 42, 256) (btridiag_cols_mr_wide), phase
49's MPC for K4's shared-memory route (btridiag_cols_wide, timed in phase
50 on its first GN system), and their sGPMP solves for K8-MultiRobot
(collision_cost_multirobot_net, _wide, _five, timed at 131,072), each
timed on its path's first inputs; each bound at the FP32 rate, the net rows' at
the 3xTF32 rate of their tensor-core route), the nvidia-smi line, and the
final
{"ok": true, "device": ...} line.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

B, H, N_STEPS, SEED = 1024, 64, 8, 0
ITERS_PER_STEP = 2
GP_PARAMS = dict(n_support_points=H, dt=0.04, opt_iters=2, sigma_start=1e-3,
                 sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
                 step_size=1.0)
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the dense TF32 tensor-core rate (495 TFLOP/s, same data sheet) over the
# three passes of a 3xTF32 product: float32-accurate products at 165
PEAK_TF32X3_FLOPS = 495e12 / 3
# the terms test's tolerance (tests/test_pallas_terms.py): atol relative to
# the output's max, rtol elementwise; float32 sums in another order
TERMS_ATOL_REL, TERMS_RTOL = 3e-5, 2e-5
# solve tolerances relative to max|x|: a well-conditioned random system
# differs from the plain version only by float32 op order (1e-5).  The GN
# systems carry lam = 1e8 collision weights and are ill-conditioned, so two
# float32 solves differ by ~1e-3 from op order alone; there the kernel is
# held to a float64 solve of the same system and may be off by at most
# twice the plain float32 version's own error (+1e-5)
SOLVE_TOL_RANDOM, SOLVE_GN_FACTOR = 1e-5, 2.0
MPC_TOL = 1e-3
# the iLQR path: benchmarks/ilqr_sgpmp_bench.py's "ilqr_batch" workload and
# its tracking-MPC loop
IL_B, IL_H, IL_ITERS, IL_CPU_B = 512, 32, 30, 32
IL_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)
IL_PARAMS = dict(n_support_points=IL_H, dt=0.04, opt_iters=IL_ITERS,
                 sigma_coll=2e-3, sigma_goal_prior=5e-3, sigma_limits=5e-3,
                 r_control=1e-6, alphas=IL_ALPHAS)
MPC_H, MPC_ITERS, MPC_STEPS = 16, 3, 30
MPC_PARAMS = dict(n_support_points=MPC_H, dt=0.04, opt_iters=MPC_ITERS,
                  sigma_coll=2e-3, sigma_goal_prior=5e-3,
                  sigma_goal_running=0.05, sigma_limits=5e-3,
                  r_control=1e-3, alphas=IL_ALPHAS)
# K6 vs its plain version on well-conditioned inputs: the TPU kernel's own
# parity with the lanes sweep (pallas_riccati.py:18-19); K7 is a short
# chain of mat-vecs, float32 rounding only
RICCATI_TOL, ROLLOUT_TOL = 1e-5, 1e-6
# a row count whose two stages do not fit the launch's 4 lanes a block at
# d = 7 (B = 512): the launch takes fewer
RIC_FEWER_LANES_P = 600
# the whole B = 32 solve on the card vs the CPU: per-lane argmin flips make
# lanes differ, so the batch's quality is compared: fraction free within 3
# of 32 lanes, median final goal distance within 50% (+ 0.01 rad)
IL_FREE_TOL, IL_DIST_TOL = 3 / 32, 0.5
# the multi-robot path: benchmarks/run_all.py config_multi_robot (config 4)
MR_B, MR_H, MR_STEPS, MR_ITERS, MR_CPU_B = 256, 32, 30, 2, 16
MR_GP = dict(n_support_points=MR_H, dt=0.05, sigma_start=1e-3,
             sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-3,
             step_size=0.7)
# (kind, base (x, y), yaw) per member: config 4's poses, and a tighter set
# (bases 0.5 m apart, as tests/test_multi_robot.py places its two arms)
MR_POSES = (("panda", (0.2, 0.72), 0.0), ("panda", (0.2, -0.72), np.pi),
            ("ur10", (-0.75, 0.0), 0.0))
MR_TIGHT_POSES = (("panda", (0.0, 0.5), 0.0), ("panda", (0.0, -0.5), np.pi),
                  ("ur10", (-0.5, 0.0), 0.0))
# two members (tests/test_pallas_terms.py's MultiRobot shape): other sizes
# through the kernel's run-time layout
MR_TWO_ARM_POSES = (("panda", (0.2, 0.55), 0.0), ("ur10", (0.2, -0.55), np.pi))
# rounds of config 4's start budget (B * 1024 candidates) before giving up
MR_MAX_ROUNDS = 8
# config 2: benchmarks/run_all.py config_pointmass (BASELINE.json configs[1])
PM_B, PM_ITERS, PM_CUTOFF = 1024, 150, 0.02
PM_START, PM_GOAL = (-0.9, -0.9, 0.0, 0.0), (0.9, 0.9, 0.0, 0.0)
# its float64 comparison: a few iterations on the first lanes
PM_CPU_B, PM_CPU_ITERS = 256, 3
# its restart policy: 75 main iterations, 6 rounds of 50
PM_R_ITERS, PM_R_SIGMA, PM_R_ROUNDS, PM_R_RESTART = 75, 0.5, 6, 50
# the JAX package's own account of this quality (BASELINE.md:120), printed
# beside the port's, not a gate
PM_JAX_FREE = {"direct": 0.47, "restarts": 0.99}
# GN factorization reuse: benchmarks/gn_reuse_ab.py batch_solve_ab
RU_B, RU_H, RU_ITERS, RU_CUTOFF = 256, 32, 48, 0.03
RU_GP = dict(n_support_points=RU_H, dt=0.04, opt_iters=RU_ITERS,
             sigma_start=1e-3, sigma_gp=1e-1, sigma_goal_prior=1e-3,
             sigma_coll=5e-3, step_size=0.9, sigma_gp_init=0.2)
RU_KS = (1, 2, 4)
# the point cloud: queries uniform in EnvSpheres3D's box, spheres of 0.02
PC_M, PC_S, PC_RADIUS = 65536, 4096, 0.02
# K10's other cases: per-sphere radii as the CPU tests draw them (many
# points inside a sphere, best + r <= 0 for many pairs), an S that no stage
# of spheres divides, a ragged M
PC_RADII, PC_ODD_S, PC_RAGGED_M = (0.05, 0.3), 4173, 1000
# K10 vs its plain version: float32 norms in another order
SDF_TOL = 1e-5
# sGPMP: benchmarks/ilqr_sgpmp_bench.py's "sgpmp" workload (the iLQR
# problems, 8 GP-prior particles each), and config 4's robot at its own
# horizon and dt, one particle per problem
SG_PART, SG_INIT_SIGMA, SG_CPU_B = 8, 0.2, 32
SG_PARAMS = dict(n_support_points=IL_H, dt=0.04, opt_iters=100,
                 num_samples=16, sigma_coll=1e-5, temperature=1.0,
                 sigma_gp_sample=0.2)
MR_SG_PARAMS = dict(SG_PARAMS, n_support_points=MR_H, dt=MR_GP["dt"])
# the whole B = 32 solve on the card vs the CPU: the softmax weights and the
# acceptance flip lanes, so the fraction of free lanes is compared
SG_FREE_TOL = 3 / 32
# K12's other inputs: ragged N (one a multiple of 4, one not); timed with
# its inputs rotated over GN_COPIES copies, together past the 50 MB L2
GN_RAGGED_N, GN_ODD_N, GN_COPIES = 1000, 999, 3
# the learned self-collision Panda: its hinge cutoff
# (PlanningTask._NET_SELF_CUTOFF); lanes whose sd lies within NET_EDGE of it
# are excluded from the kernel-vs-plain holds (two correct float32 orders
# can flip the hinge there), at most NET_EDGE_SHARE of the lanes; the
# spread nets' weight seed; the float64 hold's batch (phase cpu's)
NET_CUTOFF, NET_EDGE, NET_EDGE_SHARE, NET_SEED = 0.001, 1e-5, 1e-3, SEED + 7
MPC_CPU_B = 32
# net_main's float64 holds: the start / goal draws (bench_problem seeds);
# the output scale of the scaled spread net (smaller residuals, same
# active lanes)
NET_F64_SEEDS = (SEED, SEED + 11, SEED + 12)
NET_SCALED_OUT = 0.05
# net_terms' wider nets, whose shared memory takes 16, 8 and 4 lanes a
# block (the bundled net takes 32), and the lanes they run on
NET_WIDE = ((7, 1024, 1024, 1), (7, 2048, 2048, 1), (7, 4096, 4096, 1))
NET_WIDE_N = 8192
# the grid scene: benchmarks/grid_sdf_bench.py "panda_spheres3d" (EnvSpheres3D
# with its spheres precomputed into a 0.01 m grid, 200^3 cells; B = 4096,
# H = 64, the start at the joint-range midpoint, the goal 0.5 rad past it),
# chained GN steps timed over GRID_STEPS; its float64 hold on the first
# GRID_F64_B trajectories (CPU memory); K1 vs plain at GRID_TERMS_N
GRID_B, GRID_H, GRID_CELL, GRID_CUTOFF, GRID_STEPS = 4096, 64, 0.01, 0.02, 8
GRID_GP = dict(n_support_points=GRID_H, dt=0.04, sigma_start=1e-3,
               sigma_gp=1e-1, sigma_goal_prior=1e-2, sigma_coll=5e-4,
               step_size=0.8)
GRID_F64_B, GRID_TERMS_N = 512, 65536
# kernel vs plain in a grid scene: a lane may be off the terms tolerance
# only where one of its object points lies within GRID_FACE_TOL cell widths
# of a cell face (judged from the plain version's points: there an ulp of
# float32 FK picks the neighbouring cell), at most GRID_FACE_SHARE of the
# lanes; float ops of one grid lookup (cell index, clamp, flat index)
GRID_FACE_TOL, GRID_FACE_SHARE, GRID_LOOKUP_OPS = 1e-4, 1e-3, 22
# the grasped-object Panda: benchmarks/pallas_terms_ab.py's grasped terms
# (GraspedObjectPandaBox in EnvSpheres3D, cutoff 0.03, B = 1024, H = 64,
# q uniform over the joint limits); a ragged N; config 4 with its first
# Panda holding tests/test_multi_robot.py's 0.08 m box; float ops of one
# grasped point, R o + t (9 products, 9 sums)
GRASP_CUTOFF, GRASP_RAGGED_N, GRASP_POINT_OPS = 0.03, 1000, 18
GRASP_MR_BOX = (0.08, 0.08, 0.08)
# config 3 (benchmarks/run_all.py config_panda): the Panda in EnvSpheres3D
# reaching an EE pose (the goal's ee_link pose, sigma_ee 1e-3, w_rot 0.2)
# at B = 4096, H = 64, 30 GN iterations and two restart rounds of 30;
# theta0 GP-prior samples at sigma 0.13; its float64 hold on the first
# EE_F64_B lanes of one GN step; the sanity floors of its quality (the JAX
# package reads 99.6% free and 4.8 mm, BASELINE.md:219, printed beside the
# port's, not a gate).  Start and goal are config_panda's own: the q that
# its random_coll_free_q(PRNGKey(10)) and (PRNGKey(11)) return (4096
# candidates each, float32).  A torch.Generator cannot draw JAX's
# numbers, and a draw is a different problem: the port's draw from
# generators seeded 10 and 11 starts 0.03 rad from joint 4's lower limit,
# where both packages leave 31-32% of 128 trajectories inside the limits
# and free (PERF.md)
EE_START_Q = (2.710441827774048, 1.288450002670288, -1.0470610857009888,
              -0.4556910991668701, 2.6817686557769775, 1.3950607776641846,
              0.14158296585083008)
EE_GOAL_Q = (-0.08639121055603027, 0.2842121124267578, -0.3705925941467285,
             -1.6949026584625244, 1.1213104724884033, 2.852252721786499,
             -0.43071532249450684)
EE_B, EE_H, EE_ITERS, EE_ROUNDS, EE_RESTART = 4096, 64, 30, 2, 30
EE_CUTOFF, EE_SIGMA, EE_W_ROT, EE_INIT_SIGMA = 0.03, 1e-3, 0.2, 0.13
EE_GP = dict(n_support_points=EE_H, dt=0.04, opt_iters=EE_ITERS,
             sigma_start=1e-3, sigma_gp=1e-1, sigma_goal_prior=1e-2,
             sigma_coll=5e-4, step_size=0.8, sigma_gp_init=0.5)
EE_F64_B, EE_MIN_FREE, EE_MAX_POS_ERR = 8, 0.95, 0.01
EE_JAX = {"fraction_free": 0.996, "ee_pos_err_median_m": 0.0048}
# the EE factor on the card vs float64 on the CPU at random q (lam = 1e6
# scales g and Hb; float32 FK): relative to max|g|, max|Hb|
EE_TERMS_TOL = 1e-4
# config 1's IK (run_all.py config_fk_ik): DLS at B = 1024, 150 iterations,
# restarts every 25, se3_eps 5e-2, toward z_rot(-pi/2) y_rot(-pi) at (0.2,
# 0.4, 0.1); its float64 hold: IK_F64_ITERS DLS steps without restarts on
# the first IK_F64_B problems; Adam at IK_ADAM_ITERS; the valid fraction's
# floor (the JAX package reads 98.5%, median 28 iterations,
# BASELINE.md:119); the chained run's valid count on the card within
# IK_VALID_TOL of the CPU float32 run's
IK_B, IK_ITERS, IK_RESTART, IK_EPS = 1024, 150, 25, 5e-2
IK_TARGET_POS = (0.2, 0.4, 0.1)
IK_F64_B, IK_F64_ITERS, IK_ADAM_ITERS, IK_MIN_VALID = 64, 40, 300, 0.9
IK_VALID_TOL = 6
IK_JAX = {"valid_fraction": 0.985, "median_iters": 28}
# config 2's hybrid leg (run_all.py:167-176): config 2's problem and GPMP2
# preset (PM_*) seeded by EnvDense2D's RRT-Connect preset; the JAX
# package's fraction free there (BASELINE.md:80, :120), from another draw:
# a quality figure, not a target; the floors are tests/test_hybrid.py's
HY_JAX_FREE = (0.947, 0.948)
HY_MIN_FREE, HY_END_TOL = 0.5, 2e-2
# CHOMP (BASELINE.md's row, :71, :198): the Panda in EnvSpheres3D at the
# main path's cutoff, B = 512, CHOMPParams' defaults (EnvSpheres3D has no
# CHOMP preset) with 50 iterations, from bench_problem's straight lines;
# its first CH_F64_B lanes held to a float64 CPU run.  A control: those
# lanes solved on the card with the obstacle gradient scaled to ~0
# (sigma_coll CH_CONTROL_SIGMA, lam = 1e-16: what a K1 returning g = 0
# gives) must miss both of the hold's limits by CH_CONTROL_MARGIN, and the
# float64 run must move theta by as much
CH_B, CH_ITERS, CH_F64_B = 512, 50, 8
CH_CONTROL_SIGMA, CH_CONTROL_MARGIN = 1e8, 4.0
# config 5 (run_all.py:295-337) on one card: B = min(32768, 8192 x
# devices), H = 64, 8 steps of 2 GN iterations, start and goal in the
# joint-range bands of :310-314 drawn with a seeded torch generator; run
# at the reference's chunk of 256 and unchunked; the two agree to
# POD_AGREE of max|x| (the goal fraction counts final distances below 0.1,
# mpc_rollout_sharded's)
POD_B_PER_DEVICE, POD_B_MAX, POD_H, POD_STEPS = 8192, 32768, 64, 8
POD_GP = dict(n_support_points=POD_H, dt=0.04, sigma_start=1e-3,
              sigma_gp=1e-1, sigma_goal_prior=1e-3, sigma_coll=1e-4,
              step_size=1.0)
POD_AGREE, POD_F64_B = 1e-5, 8
# MPOT -> GPMP2 (benchmarks/mpot_vs_gpmp2.py:111-160; EnvDense2D's tuned
# preset, benchmarks/mpot_dense2d_sweep.py and the JAX package's
# envs/zoo.py:66-74): the point mass at cutoff 0.01, B = 64 GP-prior
# samples of the scene's GPMP2 preset (H = 64), the scene's MPOT preset
# with sigma_start = sigma_goal = 1e-3, a 50-iteration polish of the GPMP2
# preset; (scene, start, goal)
MP_B, MP_POLISH, MP_CUTOFF = 64, 50, 0.01
MP_SCENES = (("EnvGridCircles2D", (-0.75, -0.75), (0.75, 0.75)),
             ("EnvDense2D", (-0.9, -0.9), (0.9, 0.9)))
# the JAX package's pipeline fraction free (BASELINE.md:102, :217), from
# another draw: printed beside the port's, not targets
MP_JAX_FREE = {"EnvGridCircles2D": 0.984, "EnvDense2D": 0.906}
# the float64 hold: MPOT alone on EnvGridCircles2D's first MP_F64_B
# trajectories, MP_F64_ITERS OT iterations and MP_F64_SMOOTH of each
# smoothing pass, the same rotations on the card and the CPU
MP_F64_B, MP_F64_ITERS, MP_F64_SMOOTH = 16, 20, 10
MP_END_TOL = 2e-2
# the planar 2-link arm (tests/test_planar2link_task.py:47-52) at config
# 2's batch: H = 32, 60 generic GN steps; its float64 hold on the first
# P2_F64_B lanes of the run
P2_B, P2_F64_B = 1024, 64
P2_GP = dict(n_support_points=32, dt=0.04, opt_iters=60, sigma_coll=1e-3,
             sigma_start=1e-4, sigma_goal_prior=1e-4, sigma_gp=2e-2,
             step_size=0.5, num_samples=P2_B, sigma_gp_init=0.1)
P2_START = (-np.pi / 2, 0.0, 0.0, 0.0)
P2_GOAL = (np.pi / 2 + 0.8, -0.4, 0.0, 0.0)
# CHOMP's autodiff branch: the planar 2-link arm (no lanes hooks) at phase
# planar2link's B and H with the planar GPMP2 test's dt and sigmas
# (tests/test_planar2link_task.py:47-52), CA_ITERS iterations at step and
# clip CA_STEP (at CHOMPParams' 0.05 theta moves ~4e-5 in 50 iterations
# and the batch-summed float32 trace does not change), its first P2_F64_B
# lanes held to float64, a near-zero-gradient control (sigma_coll
# CH_CONTROL_SIGMA) missing the hold's limits by CH_CONTROL_MARGIN; then
# phase chomp's Panda problem through the hooks and through the task's
# plain residuals, each held to phase chomp's float64 CPU run
CA_ITERS, CA_STEP = 60, 1.0
CA_P2 = dict(n_support_points=32, dt=0.04, opt_iters=CA_ITERS,
             sigma_coll=1e-3, sigma_start=1e-4, sigma_goal=1e-4,
             sigma_gp=2e-2, step_size=CA_STEP, grad_clip=CA_STEP)
# the SE(3) / manifold layer: ee_se3_cost of the Panda's FK at SE_N
# configurations, the quaternion maps and the trajectory operations on an
# S^3 x R^3 batch of SE_TRAJ trajectories (dt SE_DT), the Karcher mean of
# its points and SE_N samples of a Gaussian at it; each card result held to
# a CPU float64 run: off it by at most twice the CPU float32 run's error
# plus SE_FLOOR (relative to max|ref|); samples on S^3 to SE_UNIT
SE_N, SE_TRAJ, SE_DT, SE_FLOOR, SE_UNIT = 65536, (1024, 64), 0.05, 1e-6, 1e-6
# serialization: EnvSpheres3D precomputed at cell SER_CELL and the Panda's
# model saved and loaded onto the card; K1's grid branch on the loaded task
# at the grid path's N lanes, bit for bit against the original task's; it
# runs right after the build, before any other profiler session, and takes
# its trace up to SER_TRACES times until the trace holds K1
SER_CELL, SER_N, SER_TRACES = 0.05, GRID_B * GRID_H, 3
# config 1's FK over the robot zoo (examples/forward_kinematics.py's
# robots past the Panda and the bare UR10, and the UR10's suction
# gripper): (constructor, its keywords, the golden of tests/golden, the
# links the golden leaves out); at ZOO_B lanes, the first ZOO_F64_B held
# to a float64 CPU FK at the JAX package's float32 FK tolerance
# (tests/test_kin_fk.py: 2e-5)
ZOO_MODELS = (("kuka_iiwa7", {}, "kuka_iiwa7_fk", None),
              ("habitat_stretch", {}, "stretch_fk", None),
              ("tiago_dual_holo", {}, "tiago_dual_fk", None),
              ("tiago_dual_holo_move", {}, None, None),
              ("shadow_hand", {}, "shadow_hand_fk", "lf"),
              ("allegro_hand", {}, "allegro_hand_fk", None),
              ("ur10", {"attach_gripper": True}, None, None))
ZOO_B, ZOO_F64_B, ZOO_SEED, FK_ATOL = 65536, 256, 45, 2e-5
# the dual-arm TIAGo (tasks/zoo_tasks.py) in EnvTableShelf: its MPC at the
# main path's protocol, its float64 hold on the first TG_F64_B problems
# (phase cpu's), the terms kernel's wide route timed at TG_WIDE_N lanes
TG_F64_B, TG_WIDE_N = 32, 65536
# K1 on these paths' q: a row whose pre-hinge value lies within HINGE_EDGE
# of its threshold can be active in one float32 sum and not in another
# (r ~ 3e-8 on one of config 5's 524,288 lanes), and its Jr^T Jr enters
# Hqq whole or not at all: such lanes are held on g and the cost only,
# counted, at most HINGE_EDGE_SHARE of the lanes (g = r Jr and the cost
# are continuous there)
HINGE_EDGE, HINGE_EDGE_SHARE = 1e-6, 1e-3
# the MultiRobot cells that the MultiRobot kernels took last (config 4's
# protocol, run_all.py:233-292, and its sGPMP, ilqr_sgpmp_bench.py:196-233):
# cell -> ((kind, base (x, y) or (x, y, z), yaw) per member, pairs added to
# the pair list as ((a, b), margin)).  mr_same_pair: config 4 with a mutual
# pair between its first Panda's panda_link2 and panda_hand object points
# (0 and 4) at the sum of their margins; mr_net: config 4 with the first
# Panda carrying the learned self-collision net; mr_wide: the dual-arm
# TIAGo (14 joints) 0.6 m below the workspace's centre, turned a quarter
# turn (its arms along x), and a Panda 0.5 m along them, turned back
# (~1.9% of uniform q free; at yaw 0 or nearer the walls none was); mr_five:
# five Pandas on a circle of 0.6 m at z = -0.7, each facing its centre
# (~0.49% free; tests/test_torch_mr_refused.py's line 0.8 m apart leaves
# four of them outside the workspace, with no free q)
MR_CELLS = {
    "mr_same_pair": (MR_POSES, ((((0, 4), 0.205),))),
    "mr_net": ((("panda_net",) + MR_POSES[0][1:],) + MR_POSES[1:], ()),
    "mr_wide": ((("tiago", (0.0, 0.0, -0.6), np.pi / 2),
                 ("panda", (0.5, 0.0, 0.0), np.pi)), ()),
    "mr_five": (tuple(("panda", (0.6 * np.cos(a), 0.6 * np.sin(a), -0.7),
                       a + np.pi)
                      for a in 2 * np.pi * np.arange(5) / 5), ()),
}


# the script's start: every phase line carries its seconds since then
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "script_s": time.perf_counter() - T_START}),
          flush=True)


def fail(msg: str) -> None:
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2, replays: int = 5) -> float:
    """Device time of one fn() call where the host's time per call exceeds
    it (the events of cuda_ms then time the host): ``iters`` calls captured
    in one CUDA graph, the graph replayed ``replays`` times between CUDA
    events.  The host's launch cost stays out; the gaps between the
    graph's kernels stay in.  fn() must not wait on the device."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def max_errs(got, ref):
    """(max |got - ref|, max |got - ref| / max |ref|) over paired outputs."""
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    rel = max(float((g - r).abs().max()) / (float(r.abs().max()) + 1e-30)
              for g, r in zip(got, ref))
    return abs_err, rel


# (launches with no kernel in the profile, launches) of each profile_device
# call, printed by main() as phase "profiler": its device ms miss those
# kernels' time
PROFILE_MISSED = []
# a profile is taken again only while it misses more than this share of its
# launches: a profile of 70,000-120,000 launches missing 1-9 of them
# (ee_goal, hybrid) reads its device time to 1e-4, and was taken three
# times at several seconds each
PROFILE_MISS_SHARE = 1e-3


def profile_device(fn, n_units: int, n_top: int = 8):
    """Run fn under torch.profiler -> (busy share of the wall, device ms per
    unit, top kernels' device ms per unit), read from the profiler's raw
    (Kineto) events, which give each kernel-launch call its kernel by
    correlation id (``prof.events()`` drops more).  A session can still
    miss a few kernels (up to 4 of 351 launches on an H100): a profile
    that missed more than PROFILE_MISS_SHARE of its launches is taken
    again, up to three times, the one that missed fewest counts, and its
    count of launches without a kernel goes to PROFILE_MISSED, which
    main() prints."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        by_kernel, launched, ran = {}, set(), set()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ran.add(e.correlation_id())
                key = e.name()[:60]
                by_kernel[key] = (by_kernel.get(key, 0.0)
                                  + e.duration_ns() / 1e3)
            elif "LaunchKernel" in e.name():
                launched.add(e.correlation_id())
        missed = len(launched - ran)
        if best is None or missed < best[0]:
            best = (missed, len(launched), by_kernel, wall_ms)
        if missed <= PROFILE_MISS_SHARE * len(launched):
            break
    missed, n_launched, by_kernel, wall_ms = best
    PROFILE_MISSED.append((missed, n_launched))
    dev_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n_top]
    return (dev_ms / wall_ms if dev_ms > 0 else None, dev_ms / n_units,
            {k: v / 1e3 / n_units for k, v in top})


# ----------------------------------------------------------------------
# work counts for the bounds (what these inputs need, from their shapes)
# ----------------------------------------------------------------------
def terms_work(lay, q, r):
    """(bytes, float ops) that the terms function needs on q (d, N), whose
    residual rows (the plain version's ``rows``) are r (R, N).

    Bytes: q (d, N) in, g (d, N), Hqq (d, d, N), cost (N) out, and in a
    grid scene one 16-byte grid row per object point and grid.  Ops every
    lane needs: FK compose (~132 per revolute link, ~63 per fixed), world
    joint axes (18 per joint), the scene SDF of each object point (15 per
    point and object + ~10 / 25 / 12 per sphere / rounded box / sharp
    box), its workspace distance (12), each pair's distance (12) and each
    row's hinge (2).  Only an active row (r > 0 on this q) needs more, and
    only over its live Jacobian columns (the joint moves the row's point,
    or a pair's either point, and q is inside the joint's clamp): 18 per
    column of a point row (cross product + dot), 33 per column live at both
    points of a pair and 18 at one, then 2 + 2k + k(k+1) to add r^2, r Jr
    and Jr^T Jr over its k live columns."""
    model = lay.model
    d, N = q.shape
    ctrl = list(model.controlled_link_idxs())
    per_lane = lane_ops(lay, r.shape[0]) + 18 * d
    return (4 * N * (2 * d + d * d + 1) + grid_row_bytes(lay, N),
            per_lane * N + active_row_ops(lay.row_joints(),
                                          model.clamp_lower[ctrl],
                                          model.clamp_upper[ctrl], q, r))


def active_row_ops(row_joints, clamp_lo, clamp_hi, q, r) -> int:
    """Float ops of the active rows (r > 0 on q), over their live Jacobian
    columns only (the joint moves the row's point, or a pair's either
    point, and q is inside the joint's clamp): 18 per column of a point
    row (cross product + dot), 33 per column live at both points of a pair
    and 18 at one, then 2 + 2k + k(k+1) to add r^2, r Jr and Jr^T Jr over
    its k live columns.  row_joints: ``TermsLayout.row_joints()``'s
    (a, b); clamp_lo, clamp_hi: (d,) per joint."""
    import torch
    lo = torch.as_tensor(clamp_lo, device=q.device)[:, None]
    hi = torch.as_tensor(clamp_hi, device=q.device)[:, None]
    live_q = ((q >= lo) & (q <= hi))[None]                      # (1, d, N)
    act = (r > 0)[:, None]                                      # (R, 1, N)
    a, b = (torch.as_tensor(m, device=q.device)[:, :, None]
            for m in row_joints)
    at_a, at_b = a & live_q & act, b & live_q & act             # (R, d, N)
    both = (at_a & at_b).sum(1)
    k = (at_a | at_b).sum(1)                                    # (R, N)
    return int((33 * both + 18 * (k - both)
                + (2 + 2 * k + k * (k + 1)) * act[:, 0]).sum())


def grid_row_bytes(lay, N: int) -> int:
    """Bytes of the grid rows the function needs on N lanes: one 16-byte
    table row per object point and grid in the scene."""
    from torch_robotics_tpu_torch.geom import GridSDF
    n_grids = sum(isinstance(o, GridSDF) for o in lay.df_obj_list)
    return 16 * len(lay.obj_pos) * n_grids * N


def lane_ops(lay, n_rows: int, per_row: int = 2, fk=None) -> int:
    """Float ops every waypoint lane needs for the rows' values: FK compose
    (~132 per revolute link, ~63 per fixed) and each grasped point's R o +
    t (GRASP_POINT_OPS), or ``fk`` ops for both where given, the scene SDF
    of each object point (15 per point and object + ~10 / 25 / 12 per
    sphere / rounded box / sharp box, or GRID_LOOKUP_OPS per grid), its
    workspace distance (12), each pair's distance (12) and ``per_row`` per
    residual row."""
    from torch_robotics_tpu_torch.geom import GridSDF
    from torch_robotics_tpu_torch.geom.sdf import RoundedBoxes, Spheres
    model = lay.model
    n_rev = sum(1 for t in model.joint_types if t != 0)
    n_obj, n_pair = len(lay.obj_pos), len(lay.pair_a)
    if fk is None:
        fk = (132 * n_rev + 63 * (model.n_links - n_rev)
              + GRASP_POINT_OPS * getattr(lay, "n_grasped", 0))
    ops = fk + 12 * (n_obj + n_pair) + per_row * n_rows
    for obj in lay.df_obj_list:
        if isinstance(obj, GridSDF):
            ops += n_obj * GRID_LOOKUP_OPS
            continue
        ops += n_obj * 15
        for f in obj.fields:
            per = 10 if isinstance(f, Spheres) else (
                25 if isinstance(f, RoundedBoxes) else 12)
            ops += n_obj * per * f.centers.shape[0]
    return ops


# Float ops of one FK step of the value-only cost, by the step's class
# (terms_kernel.pack_cost_kernel_params; cost.cu: axis_joint,
# joint_transform and the compose), a multiply or an add one and a fused
# multiply-add two: the local rotation of a revolute or continuous joint
# about a signed coordinate axis 20 (c' = 1 - (1 - c), and two kept terms
# for each of F Rj's six entries off the axis), about another axis 69
# (Rodrigues 24, F Rj 45); a prismatic joint's translation 6; t = R tr + tp
# 18, or tr + tp 3 under a parent rotation that is exactly I (R = Rl
# then); R Rl 45 only where a later step or an offset point reads R and
# the joint's rotation is not exactly F = I.
FK_AXIS_OPS, FK_RODRIGUES_OPS, FK_PRISMATIC_OPS = 20, 69, 6
FK_T_OPS, FK_T_IDENTITY_OPS, FK_R_OPS = 18, 3, 45


def cost_fk_ops(lay) -> int:
    """Float ops of the FK that the value-only cost needs on one lane: the
    steps that ``pack_cost_kernel_params`` schedules (the links the
    points need, each member from its base pose), each counted by its
    class (FK_*_OPS), and each grasped point's R o + t
    (GRASP_POINT_OPS)."""
    from torch_robotics_tpu_torch.ops import terms_kernel as tk
    ints, _ = tk.pack_cost_kernel_params(lay)
    n_steps = int(ints[7])
    steps = ints[tk._COST_HEADER:tk._COST_HEADER + 8 * n_steps].reshape(-1, 8)
    classes = ints[ints[14]:ints[14] + n_steps]
    ops = GRASP_POINT_OPS * int(ints[12])
    for jt, cls in zip(steps[:, 0].tolist(), classes.tolist()):
        if jt in (1, 2):      # revolute, continuous
            ops += FK_AXIS_OPS if cls & 3 else FK_RODRIGUES_OPS  # axis bits
        elif jt == 3:         # prismatic
            ops += FK_PRISMATIC_OPS
        if cls & tk._IDENTITY_PARENT:
            ops += FK_T_IDENTITY_OPS
        else:
            reads_r = cls & (tk._KEEP_R | tk._IDENTITY_F) == tk._KEEP_R
            ops += FK_T_OPS + (FK_R_OPS if reads_r else 0)
    return ops


def cost_work(lay, N: int, n_rows: int):
    """(bytes, float ops) of the value-only cost on N lanes: q (d, N) in,
    cost (N) out, the grid rows (grid_row_bytes); per lane the FK by step
    class (cost_fk_ops), the rows' values, and a hinge (2) and a square and
    add (2) per row."""
    return (4 * N * (lay.model.n_dofs + 1) + grid_row_bytes(lay, N),
            lane_ops(lay, n_rows, per_row=4, fk=cost_fk_ops(lay)) * N)


def riccati_work(d: int, m: int, P: int, T: int, B_: int):
    """(bytes, float ops) of the Riccati sweep: U, l, Fc, Vx0 in, ks, Ks out;
    ops counted from the algorithm's loops per lane and step: S B and
    S Phi, phase 1's d reflections (over m + d - 1 - j columns each),
    the gains, phase 2's m reflections over the m S-rows and P F-rows."""
    ph1 = sum((2 * m - 1) + 6 + (m + d - 1 - j) * (4 * m + 2)
              for j in range(d))
    gains = (d + sum(6 + 2 * i for i in range(d))
             + sum(2 + 2 * (d - 1 - i) for i in range(d))
             + sum(1 + 2 * (d - 1 - i) for i in range(d))
             + m * (3 + 2 * d) + m * sum(1 + 2 * (d - 1 - i)
                                         for i in range(d)))
    ph2 = sum(2 * P + 2 * (m - 1 - j) + 7
              + (m - 1 - j) * (4 * P + 4 * (m - 1 - j) + 5)
              for j in range(m))
    ops = T * B_ * (5 * m * d + ph1 + gains + ph2)
    nbytes = 4 * (T * d * B_ + T * m * B_ + T * m * P * B_ + m * B_
                  + T * d * B_ + T * d * m * B_)
    return nbytes, ops


def rollout_work(d: int, m: int, T: int, A: int, B_: int):
    """(bytes, float ops) of the line-search rollout: xs (T + 1, m, B), U,
    ks, Ks in, the A rollouts' states and controls out; per step and
    rollout dx (m), u (2 + 2 m per joint) and the double-integrator step
    (7 per joint)."""
    ops = A * T * B_ * (m + d * (2 * m + 2) + 7 * d)
    nbytes = 4 * ((T + 1) * m * B_ + 2 * T * d * B_ + T * d * m * B_
                  + A * T * (m + d) * B_)
    return nbytes, ops


def solve_work(H_: int, m: int, B_: int):
    """(bytes, float ops) of one sweep: D, U, b in, x out; ops counted from
    the kernel's loops (Cholesky, y, W, S, Wy per step; W x and the
    transposed triangular solve per backward step)."""
    bwd = sum(2 * (m - 1 - i) + 1 for i in range(m))
    ops = (H_ * (sweep_step_ops(m) + bwd) + (H_ - 1) * 2 * m * m) * B_
    nbytes = 4 * (H_ * m * m * B_ + H_ * m * m + 2 * H_ * m * B_)
    return nbytes, ops


def sweep_step_ops(m: int) -> int:
    """Float ops of one forward block step: A = D - S, its Cholesky, y, W,
    the symmetric S = W^T W and Wy."""
    chol = sum(2 * j + 1 for i in range(m) for j in range(i + 1))
    return (m * (m + 1) // 2 + chol + sum(2 * i + 2 for i in range(m))
            + m * sum(2 * i + 1 for i in range(m))
            + m * (m + 1) // 2 * (2 * m - 1) + m * (2 * m - 1))


def cols_solve_work(H_: int, m: int, B_: int):
    """(bytes, float ops) of the column sweep: D, U, b in, x out; ops
    counted from the algorithm per lane: the forward step of solve_work
    (Cholesky, y, W, S, Wy), then per backward step the transposed
    triangular solve, and below the last block the matvec U_k x_{k+1}, the
    triangular solve L_k^-1 and the subtraction."""
    nbytes, _ = solve_work(H_, m, B_)
    trsv = sum(2 * i + 1 for i in range(m))
    ops = (H_ * (sweep_step_ops(m) + trsv)
           + (H_ - 1) * (2 * m * m + trsv + m)) * B_
    return nbytes, ops


def factor_work(H_: int, m: int, B_: int):
    """(bytes, float ops) of the factor-persisting sweep: the sweep's
    (solve_work), and its L and W (H, m, m, B) written out."""
    nbytes, ops = solve_work(H_, m, B_)
    return nbytes + 4 * 2 * H_ * m * m * B_, ops


def subst_work(H_: int, m: int, B_: int):
    """(bytes, float ops) of the substitution sweep: L, W (H, m, m, B) and b
    in, x out; per lane and step the forward triangular solve (m^2 + m) and
    Wy = W^T y (m (2m - 1)), then the backward pass (the matvec 2 m^2 below
    the last block, the transposed triangular solve m^2)."""
    ops = (H_ * (m * m + m + m * (2 * m - 1) + m * m)
           + (H_ - 1) * 2 * m * m) * B_
    return 4 * (2 * H_ * m * m * B_ + 2 * H_ * m * B_), ops


def sdf_work(M: int, S: int):
    """(bytes, float ops) of the sphere SDF: points (M, 3), centers (S, 3),
    radii (S,) in, (M,) out; 11 float ops per (point, sphere) pair: three
    differences, the squared norm (a product and two multiply-adds, 5),
    the square root (counted as one), the radius and the min."""
    return 4 * (4 * M + 4 * S), 11 * M * S


def mr_terms_work(lay, q, r):
    """(bytes, float ops) that the MultiRobot terms need on q (d, N), whose
    residual rows (the plain version's ``rows``) are r (R, N).

    Bytes: q (d, N) in, g (d, N), Hqq (d, d, N), cost (N) out.  Ops every
    lane needs: each member's FK compose (~132 per revolute link, ~63 per
    fixed), its world joint axes and origins with the base pose (48 per
    joint), every point's base transform (15), the scene SDF of each object
    point (15 per point and object + ~10 per sphere), its workspace
    distance (12), each pair's distance (12) and each row's hinge (2); the
    active rows as active_row_ops counts them."""
    d, N = q.shape
    per_lane = mr_lane_ops(lay, r.shape[0])
    ctrl = [list(m.model.controlled_link_idxs()) for m in lay.members]
    clo = np.concatenate([m.model.clamp_lower[c]
                          for m, c in zip(lay.members, ctrl)])
    chi = np.concatenate([m.model.clamp_upper[c]
                          for m, c in zip(lay.members, ctrl)])
    return (4 * N * (2 * d + d * d + 1) + grid_row_bytes(lay, N),
            per_lane * N + active_row_ops(lay.row_joints(), clo, chi, q, r))


def mr_lane_ops(lay, n_rows: int, per_row: int = 2, axes: bool = True,
                fk=None):
    """Float ops every waypoint lane of a MultiRobot needs for the rows'
    values: each member's FK compose (~132 per revolute link, ~63 per
    fixed), every point's base transform (15) and a grasped point's R o +
    t (GRASP_POINT_OPS), or ``fk`` ops for the three where given; with
    ``axes`` each member's world joint axes and origins with the base pose
    (48 per joint); the scene SDF of each object point (15 per point and
    object + ~10 per sphere), its workspace distance (12), each pair's
    distance (12) and ``per_row`` per residual row."""
    from torch_robotics_tpu_torch.geom import GridSDF
    from torch_robotics_tpu_torch.geom.sdf import Spheres
    from torch_robotics_tpu_torch.ops.lanes_fk import member_collision_points
    n_pts = len(lay.point_joints())
    n_obj, n_pair = len(lay.obj_pos), len(lay.pair_a)
    n_grasped = sum(g >= 0 for r in lay.members for sec in ("object", "self")
                    for _, g in member_collision_points(r, sec))
    per_lane = 12 * (n_obj + n_pair) + per_row * n_rows
    if fk is None:
        fk = 15 * n_pts + GRASP_POINT_OPS * n_grasped
        for mem in lay.members:
            n_rev = sum(1 for t in mem.model.joint_types if t != 0)
            fk += 132 * n_rev + 63 * (mem.model.n_links - n_rev)
    per_lane += fk + sum(48 * mem.model.n_dofs for mem in lay.members
                         if axes)
    for obj in lay.df_obj_list:
        if isinstance(obj, GridSDF):
            per_lane += n_obj * GRID_LOOKUP_OPS
            continue
        per_lane += n_obj * 15
        for f in obj.fields:
            if not isinstance(f, Spheres):
                raise NotImplementedError("config 4's scene holds spheres")
            per_lane += n_obj * 10 * f.centers.shape[0]
    return per_lane


def mr_cost_work(lay, N: int, n_rows: int):
    """(bytes, float ops) of the MultiRobot value-only cost on N lanes: q
    (d, N) in, cost (N) out; per lane the FK by step class from each
    member's base pose (cost_fk_ops), the rows' values without joint axes,
    and a hinge (2) and a square and add (2) per row."""
    d = int(lay.d_off[-1])
    return (4 * N * (d + 1) + grid_row_bytes(lay, N),
            mr_lane_ops(lay, n_rows, 4, axes=False,
                        fk=cost_fk_ops(lay)) * N)


def sweep_work(H_: int, m: int, B_: int, trsv: bool):
    """(bytes, float ops) that the L-and-y sweep's algorithm does, beside
    solve_work, which counts what the solve needs and gives its bound: D,
    U, b in, x out; ops from the kernel's loops: the forward step of solve_work and the transposed
    triangular solve per step (m^2), and below the last block either W_k =
    L_k^-1 U_k by columns with the right-hand side's update (m^3 + 2 m^2)
    or, with the trsv tail, U_k x_{k+1} (m (2m - 1)), L_k^-1 of it (m^2)
    and the subtraction (m)."""
    nbytes, _ = solve_work(H_, m, B_)
    tail = m * (2 * m - 1) + m * m + m if trsv else m ** 3 + 2 * m * m
    return nbytes, (H_ * (sweep_step_ops(m) + m * m)
                    + (H_ - 1) * tail) * B_


def cr_work(H_: int, m: int, B_: int):
    """(bytes, float ops) that block cyclic reduction does over the padded
    H2 blocks, beside solve_work, which counts what the solve needs and
    gives its bound (CR's own arithmetic is about three times that at (64,
    14, 1024)): D, U, b in, x out; per odd block of a level its Cholesky, 2 m^2
    for the two triangular solves of each of the 2 m + 1 right-hand sides
    and 4 m^2 + m to back-substitute; per even block D' (lower triangle,
    4 m per entry), b' (4 m^2) and U' (2 m^3); the root's Cholesky and
    solve."""
    nbytes, _ = solve_work(H_, m, B_)
    chol = sum(2 * j + 1 for i in range(m) for j in range(i + 1))
    n_odd = (1 << max(H_ - 1, 0).bit_length()) - 1
    per_odd = chol + (2 * m + 1) * 2 * m * m + 4 * m * m + m
    per_even = m * (m + 1) // 2 * 4 * m + 4 * m * m + 2 * m ** 3
    return nbytes, (n_odd * (per_odd + per_even) + chol + 2 * m * m) * B_


def gn_assembly_work(P: int, d: int, N: int):
    """(bytes, float ops) of the GN assembly: r (P, N), Jr (P, d, N) in, g,
    Hu, cost out; per lane and row r^2 (2), r Jr (2 d) and the upper
    triangle of Jr^T Jr (d (d + 1))."""
    n_u = d * (d + 1) // 2
    return (4 * N * (P * (d + 1) + d + n_u + 1),
            N * P * (2 + 2 * d + 2 * n_u))


def bound_ms(nbytes: float, ops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the lanes a block that cost.cu's kernel is built for (cost_launch_config)
COST_LANES = (32, 64, 96, 128)
# mangled-name fragments of the net row's tensor-core instantiations, and
# the net row's kernel names (both routes) as the profiler reports them
NET_TC_TERMS = "net_terms_tc_kernelILi256ELi128ELi64E"
NET_TC_COST = "net_cost_tc_kernelILi256ELi128ELi64E"
NET_ROW_KERNELS = ("net_terms_tc_kernel", "net_cost_tc_kernel",
                   "net_row_kernel")


def net_tc_sass_counts():
    """{mangled fragment: {opcode: count}} of the HMMA / HGMMA, LDS and FFMA
    instructions in the net row's tensor-core kernels, from cuobjdump -sass
    of the built net_row.cu."""
    from torch_robotics_tpu_torch.ops.net_kernel import NET_TERMS_KERNEL
    counts = {}
    for name, ins in sass_functions(NET_TERMS_KERNEL.library_path).items():
        frag = next((f for f in (NET_TC_TERMS, NET_TC_COST) if f in name),
                    None)
        if frag:
            ops = counts.setdefault(frag, {})
            for row in ins:
                op = row[1].split(".")[0]
                if op in ("HMMA", "HGMMA", "LDS", "FFMA"):
                    ops[op] = ops.get(op, 0) + 1
    return counts


def sass_functions(library):
    """{mangled name: [[offset, opcode with its modifiers, predicate,
    branch target offset or None]]} of every function in cuobjdump -sass
    of a built library (a target written as a label resolves to the offset
    of the instruction after it)."""
    import re

    from torch_robotics_tpu_torch.ops.cuda_build import nvcc_path
    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(library)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, "cuobjdump failed: " + out.stderr[-2000:])
    funcs, labels, fn = {}, {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = funcs.setdefault(m.group(1), [])
            labels[m.group(1)] = lab = {}
            continue
        if fn is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            lab[m.group(1)] = len(fn)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                      r"([^;]*);", line)
        if m:
            tgt = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", m.group(4))
            fn.append([int(m.group(1), 16), m.group(3),
                       (m.group(2) or "").strip(),
                       tgt.group(1) if tgt and m.group(3).startswith("BRA")
                       else None])
    for name, ins in funcs.items():
        for row in ins:
            if row[3] is None:
                continue
            if row[3].startswith(".L_x_"):
                idx = labels[name].get(row[3])
                row[3] = ins[idx][0] if idx is not None and idx < len(
                    ins) else None
            else:
                row[3] = int(row[3], 16)
    return funcs


def sdf_pair_instructions(library):
    """SASS instructions a (point, sphere) pair in the sphere SDF kernel's
    hot loop, from cuobjdump -sass of ``library`` (this tree's or another
    tree's sphere_sdf.cu): of the innermost loops (backward branches whose
    bodies hold no other), the one whose body holds the most MUFU.RSQ (one
    a pair: each pair's sqrtf).  ``per_pair`` is
    the instructions (NOPs aside) on the loop's common path (a forward
    conditional branch taken where what it skips holds the root or a
    call: the cull's skip, sqrtf's out-of-line slow case), over the
    pairs a trip (a BRA.DIV, taken only by a diverged warp, falls
    through); ``per_evaluated_pair`` the whole body over the pairs (every
    root taken).  None where no loop holds a root."""
    funcs = sass_functions(library)
    name = next((n for n in funcs if "sphere_sdf_kernel" in n), None)
    if name is None:
        return None
    ins = funcs[name]
    at = {row[0]: i for i, row in enumerate(ins)}
    loops = [(at[tgt], i) for i, (off, op, pred, tgt) in enumerate(ins)
             if op.split(".")[0] == "BRA" and tgt is not None and tgt < off
             and tgt in at]
    inner = [(h, t, sum(1 for row in ins[h:t + 1]
                        if row[1].startswith("MUFU.RSQ")))
             for h, t in loops
             if not any(h <= h2 and t2 <= t and (h2, t2) != (h, t)
                        for h2, t2 in loops)]
    inner = [x for x in inner if x[2]]
    if not inner:
        return None
    head, tail, roots = max(inner, key=lambda x: x[2])
    path, i, steps = 0, head, 0
    while head <= i <= tail and steps < 100000:
        off, op, pred, tgt = ins[i]
        steps += 1
        if op != "NOP":
            path += 1
        if (op.split(".")[0] == "BRA" and not op.startswith("BRA.DIV")
                and tgt is not None and tgt in at):
            j = at[tgt]
            if i == tail:
                break
            if not pred or pred == "@PT":
                i = j
                continue
            skipped = ins[i + 1:j] if j > i else []
            if any(r[1].startswith(("MUFU.RSQ", "CALL")) for r in skipped):
                i = j
                continue
        i += 1
    nonop = sum(1 for row in ins[head:tail + 1] if row[1] != "NOP")
    return dict(function=name, loop_instructions=tail - head + 1,
                pairs_a_trip=roots, per_pair=path / roots,
                per_evaluated_pair=nonop / roots)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_build():
    from torch_robotics_tpu_torch.ops.btridiag_kernel import _COLS_WIDTHS
    from torch_robotics_tpu_torch.ops.cuda_build import build_all
    kernels = tuple(all_kernels().values())
    t0 = time.perf_counter()
    per_source = {}
    logs = build_all(kernels, seconds=per_source)
    secs = time.perf_counter() - t0
    # resource report of the instantiations the paths launch (mangled name
    # fragment -> label)
    from torch_robotics_tpu_torch.ops.btridiag_kernel import _KERNEL_M
    names = {**{"terms_kernelILi%dE" % d: "terms_kernel<%d>" % d
                for d in range(1, 9)},
             **{"terms_wide_kernelILi%dE" % d: "terms_wide_kernel<%d>" % d
                for d in (16, 24, 32)},
             **{"11cost_kernelILi%dE" % n: "cost_kernel<%d>" % n
                for n in COST_LANES},
             "btridiag_w_kernelILi14ELi0EE": "btridiag_w_kernel<14>",
             "btridiag_w_kernelILi4ELi0EE": "btridiag_w_kernel<4>",
             "btridiag_w_kernelILi14ELi1EE": "btridiag_factor<14>",
             **{"btridiag_subst_kernelILi%dELb%dE" % (m, k):
                "btridiag_subst_kernel<%d%s>" % (m, ", keep_lw" if k else "")
                for m in _KERNEL_M for k in (0, 1)},
             **{"riccati_kernelILi%dE" % d: "riccati_kernel<%d>" % d
                for d in range(1, 9)},
             **{"rollout_kernelILi%dE" % d: "rollout_kernel<%d>" % d
                for d in range(1, 9)},
             **{"15mr_terms_kernelILi%dE" % d: "mr_terms_kernel<%d>" % d
                for d in (8, 16, 24, 32)},
             **{"btridiag_cols_kernelILi%dE" % w: "btridiag_cols_kernel<%d>" % w
                for w in _COLS_WIDTHS},
             "sphere_sdf_kernel": "sphere_sdf_kernel",
             **{"btridiag_w_kernelILi%dELi%dEE" % (m, t):
                "btridiag_sweep<%d, %s>" % (m, tail)
                for m in _KERNEL_M
                for t, tail in ((2, "trsm"), (3, "trsv"))},
             **{"9cr_kernelILi%dEE" % m: "cr_kernel<%d>" % m
                for m in _KERNEL_M},
             "gn_assembly_kernelILi7E": "gn_assembly_kernel<7>",
             "net_row_kernelILb1E": "net_row_kernel<terms> (simt)",
             "net_row_kernelILb0E": "net_row_kernel<cost> (simt)",
             NET_TC_TERMS: "net_terms_tc_kernel<256, 128, 64> (tf32x3)",
             NET_TC_COST: "net_cost_tc_kernel<256, 128, 64> (tf32x3)"}
    report = {}
    for text in logs.values():
        report.update(ptxas_lines(text, names))
    for w in _COLS_WIDTHS:
        line = report.get("btridiag_cols_kernel<%d>" % w, "")
        check("0 bytes spill stores, 0 bytes spill loads" in line,
              "btridiag_cols_kernel<%d>: ptxas reports a spill or no line: "
              "%r" % (w, line))
    # the net row's tensor-core kernels: no spill, and HMMA in their SASS
    sass = net_tc_sass_counts()
    for frag, label in ((NET_TC_TERMS, names[NET_TC_TERMS]),
                        (NET_TC_COST, names[NET_TC_COST])):
        line = report.get(label, "")
        check("0 bytes spill stores, 0 bytes spill loads" in line,
              "%s: ptxas reports a spill or no line: %r" % (label, line))
        check(sass.get(frag, {}).get("HMMA", 0) > 0,
              "%s: no HMMA in its SASS: %s" % (label, sass.get(frag)))
        report[label] += " | SASS %s" % sass[frag]
    # the cost kernel, the MultiRobot terms kernel, every terms_kernel<D>,
    # rollout_kernel<D>, substitution kernel, L-and-y sweep, cyclic
    # reduction and the sphere SDF keep their arrays out of local memory
    for label in ["sphere_sdf_kernel"] + [
            v for v in names.values()
            if v.startswith(("cost_kernel<", "terms_kernel<",
                             "terms_wide_kernel<", "mr_terms_kernel<",
                             "rollout_kernel<", "btridiag_subst",
                             "btridiag_sweep<", "cr_kernel<"))]:
        line = report.get(label, "")
        check("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads" in line, "%s: ptxas reports a stack frame, a spill or "
              "no line: %r" % (label, line))
    for k in kernels:
        k.lib()
    from torch_robotics_tpu_torch.ops.sdf_kernel import KERNEL as SDF_KERNEL
    sdf_sass = sdf_pair_instructions(SDF_KERNEL.library_path)
    smi = nvidia_smi_line()
    emit("build", seconds=round(secs, 3),
         source_seconds={k: round(v, 3) for k, v in per_source.items()},
         ptxas=report, sphere_sdf_sass=sdf_sass, card=smi)
    return smi


def bench_problem(device, n_batch: int, robot=None, seed: int = SEED):
    """bench.py's start/goal draw (numpy ``seed``) -> (task, start, goal),
    for the pair-field Panda or ``robot``."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=EnvSpheres3D(device=device),
                        robot=(RobotPanda.create(device=device)
                               if robot is None else robot),
                        obstacle_cutoff_margin=0.03)
    rng = np.random.default_rng(seed)
    lo = task.robot.model.q_lower.astype(np.float64)
    hi = task.robot.model.q_upper.astype(np.float64)
    d = lo.shape[0]
    u1 = rng.uniform(size=(B, d))[:n_batch]
    u2 = rng.uniform(size=(B, d))[:n_batch]
    q_start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    q_goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    z = np.zeros_like(q_start)
    start = torch.as_tensor(np.concatenate([q_start, z], -1),
                            dtype=torch.float32, device=device)
    goal = torch.as_tensor(np.concatenate([q_goal, z], -1),
                           dtype=torch.float32, device=device)
    return task, start, goal


def random_q(task, N: int, seed: int):
    """q (d, N) over 1.4x the joint range: some joints sit past their
    clamps (zeroed Jacobian columns)."""
    import torch
    rng = np.random.default_rng(seed)
    lo, hi = task.robot.model.q_lower, task.robot.model.q_upper
    u = rng.uniform(-0.2, 1.2, size=(lo.shape[0], N))
    q = lo[:, None] + u * (hi - lo)[:, None]
    return torch.as_tensor(q, dtype=torch.float32, device=task.device)


def phase_terms():
    import torch
    from torch_robotics_tpu_torch.envs import EnvBase, EnvMazeBoxes3D
    from torch_robotics_tpu_torch.geom import MultiSharpBoxField, ObjectField
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask

    from torch_robotics_tpu_torch.solve import straight_line_trajs
    task, start, goal = bench_problem("cuda", B)
    terms = task.collision_residuals.obstacle_terms_lanes
    N = H * B
    # the main path's first q: the straight-line plans, h-major lanes
    d = start.shape[1] // 2
    q_main = (straight_line_trajs(start, goal, H)[..., :d]
              .permute(2, 1, 0).reshape(d, N).contiguous())
    q = random_q(task, N, seed=1)
    results = {}
    main_key = "panda_spheres3d_main_q_N%d" % N
    hold_terms(main_key, terms.unscaled(q_main), terms.plain.unscaled(q_main),
               results)
    hold_terms("panda_spheres3d_random_q_N%d" % N, terms.unscaled(q),
               terms.plain.unscaled(q), results)

    box_robot = RobotPanda.create(self_collision_margin_robot=0.3,
                                  device="cuda")
    maze = PlanningTask(env=EnvMazeBoxes3D(device="cuda"), robot=box_robot,
                        obstacle_cutoff_margin=0.03)
    s2, c2 = np.sqrt(0.5), np.cos(0.3)
    sharp = ObjectField.create(
        [MultiSharpBoxField([[0.3, 0.1, 0.4], [-0.35, 0.2, 0.5]],
                            [[0.2, 0.3, 0.25], [0.15, 0.4, 0.2]],
                            device="cuda")],
        pos=[0.05, -0.1, 0.1], ori=[c2, s2 * np.sin(0.3), 0.0,
                                    s2 * np.sin(0.3)], device="cuda")
    sharp_task = PlanningTask(
        env=EnvBase(name="sharp", limits=[[-0.6, -0.6, -0.2],
                                          [0.6, 0.6, 0.9]],
                    obj_fixed_list=[sharp], device="cuda"),
        robot=box_robot, obstacle_cutoff_margin=0.03)
    for name, t in (("panda_maze_boxes3d_N4096", maze),
                    ("panda_sharp_boxes_tight_ws_N4096", sharp_task)):
        qb = random_q(t, 4096, seed=2)
        tt = t.collision_residuals.obstacle_terms_lanes
        hold_terms(name, tt.unscaled(qb), tt.plain.unscaled(qb), results)

    # a lane's bits depend neither on the batch nor on the lanes a block
    from torch_robotics_tpu_torch.ops.terms_kernel import (
        run_terms_kernel, terms_launch_config)
    full = terms.unscaled(q_main)
    ragged = terms.unscaled(q_main[:, :GN_RAGGED_N].contiguous())
    d_, ints, floats = terms.params[:3]
    at32 = run_terms_kernel(q_main, ints, floats, d_, terms_launch_config(
        ints.cpu().numpy(), floats.numel(), lanes=32))
    check(all(torch.equal(a[..., :GN_RAGGED_N], b) and torch.equal(a, c)
              for a, b, c in zip(full, ragged, at32)),
          "K1: a lane's bits change with the batch or the lanes a block")

    # timed (the kernel's device time over a CUDA graph of calls: a call's
    # host time exceeds it), and its work counted, on the main path's q
    k_ms = device_ms(lambda: terms.unscaled(q_main), iters=20)
    p_ms = cuda_ms(lambda: terms.plain.unscaled(q_main), iters=5, warmup=1)
    r_main = terms.plain.rows(q_main)[0]
    nbytes, ops = terms_work(TermsLayout(task), q_main, r_main)
    emit("terms", max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                            for k, v in results.items()},
         kernel_ms=k_ms, plain_ms=p_ms, bytes=nbytes, ops=ops,
         active_row_share=float((r_main > 0).float().mean()),
         call_ms=cuda_ms(lambda: terms.unscaled(q_main), iters=50),
         launch=terms.params[4],
         kernel_ms_random_q=device_ms(lambda: terms.unscaled(q), iters=20))
    return dict(max_abs_err=results[main_key][0], ms=k_ms,
                plain_ms=p_ms, work=(nbytes, ops))


def dense_solve_fn(D, U, b):
    """One torch.linalg.solve on the dense (B, H m, H m) system: the library
    yardstick for the sweep (never used by the port)."""
    import torch
    H_, m, _, B_ = D.shape
    A = torch.zeros((B_, H_ * m, H_ * m), dtype=D.dtype, device=D.device)
    for k in range(H_):
        sl = slice(k * m, (k + 1) * m)
        A[:, sl, sl] = D[k].permute(2, 0, 1)
        if k + 1 < H_:
            nx = slice((k + 1) * m, (k + 2) * m)
            A[:, sl, nx] = U[k, :, :, 0]
            A[:, nx, sl] = U[k, :, :, 0].T
    rhs = b.permute(2, 0, 1).reshape(B_, H_ * m, 1)
    return lambda: torch.linalg.solve(A, rhs)


def random_system(H_: int, m: int, B_: int, seed: int):
    """A random well-conditioned SPD block-tridiagonal system (D, U, b) in
    the lanes layout on the card, as tests/test_torch_btridiag.py builds
    them."""
    import torch
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B_, H_, m, m)) * 0.3
    D = np.transpose(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m),
                     (1, 2, 3, 0))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                            device="cuda")
            for a in (D, rng.normal(size=(H_, m, m, 1)) * 0.2,
                      rng.normal(size=(H_, m, B_)))]


def solve_every_m():
    """Both sweeps of btridiag.cu at every instantiated m on a small random
    system with a ragged batch (H = 8, B = 100) against their plain
    versions to SOLVE_TOL_RANDOM of max|ref|: the W-persisting sweep's x,
    the factor sweep's x, L and W, and the substitution sweep fed those
    factors and a fresh b -> {m: largest relative error}."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        _KERNEL_M, solve_lanes_factor, solve_lanes_subst, solve_lanes_w)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_factor_core, solve_lanes_subst_core)
    out = {}
    for m in _KERNEL_M:
        D, U, b = random_system(8, m, 100, seed=20 + m)
        b2 = torch.flip(b, (2,)).contiguous()
        xp, Lp, Wp = solve_lanes_factor_core(D, U, b)
        got = (solve_lanes_w(D, U, b),) + solve_lanes_factor(D, U, b)
        ref = (xp, xp, Lp, Wp)
        xs = solve_lanes_subst(got[2], got[3], b2)
        got += (xs,)
        ref += (solve_lanes_subst_core(got[2], got[3], b2),)
        rel = 0.0
        for name, g, r in zip(("w_x", "factor_x", "factor_L", "factor_W",
                               "subst_x"), got, ref):
            check(bool(torch.isfinite(g).all()),
                  "m = %d %s: non-finite output" % (m, name))
            e = max_errs([g], [r])[1]
            check(e <= SOLVE_TOL_RANDOM, "m = %d %s: kernel vs plain %.3g of "
                  "max|ref|" % (m, name, e))
            rel = max(rel, e)
        out["m%d" % m] = rel
    return out


def phase_solve():
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system

    task, start, goal = bench_problem("cuda", B)
    theta0 = straight_line_trajs(start, goal, H)
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**GP_PARAMS))
    m = D_l.shape[1]
    rand = random_system(H, m, B, seed=3)
    results = {}
    for name, (D, U, b) in (("gn", (D_l, U_l, b_l)), ("random", rand)):
        for Bn in (B, 100):
            Dn = D[..., :Bn].contiguous()
            bn = b[..., :Bn].contiguous()
            x_k = solve_lanes_w(Dn, U, bn)
            x_p = solve_lanes_core(Dn, U, bn)
            x_64 = solve_lanes_core(Dn.double(), U.double(), bn.double())
            check(bool(torch.isfinite(x_k).all()), name + ": non-finite x")
            key = "%s_B%d" % (name, Bn)
            err, rel = max_errs([x_k], [x_p])
            rel_k64 = max_errs([x_k.double()], [x_64])[1]
            rel_p64 = max_errs([x_p.double()], [x_64])[1]
            if name == "random":
                ok = rel <= SOLVE_TOL_RANDOM
            else:
                ok = rel_k64 <= SOLVE_GN_FACTOR * rel_p64 + SOLVE_TOL_RANDOM
            check(ok, "%s: sweep disagrees (vs plain %.3g, vs float64 %.3g, "
                  "plain vs float64 %.3g of max|x|)"
                  % (key, rel, rel_k64, rel_p64))
            results[key] = dict(abs=err, rel_to_max=rel,
                                kernel_vs_f64=rel_k64, plain_vs_f64=rel_p64)
    try:
        solve_lanes_w(D_l, U_l.expand(H, m, m, 2).contiguous(),
                      b_l)
        fail("a per-batch U was accepted")
    except ValueError:
        pass
    every_m = solve_every_m()
    k_ms = cuda_ms(lambda: solve_lanes_w(D_l, U_l, b_l), iters=20)
    # one lane's chain of steps sets the sweep's time: the same system's
    # first 8 lanes take about as long as all of them
    D8, b8 = D_l[..., :8].contiguous(), b_l[..., :8].contiguous()
    k8_ms = cuda_ms(lambda: solve_lanes_w(D8, U_l, b8), iters=20)
    p_ms = cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l), iters=2,
                   warmup=1)
    lib_ms = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=3, warmup=1)
    torch.cuda.empty_cache()
    emit("solve", max_errs=results, every_m=every_m,
         kernel_ms=k_ms, kernel_ms_B8=k8_ms, plain_ms=p_ms,
         dense_solve_ms=lib_ms)
    return dict(max_abs_err=results["gn_B%d" % B]["abs"], ms=k_ms,
                plain_ms=p_ms,
                library_ms=lib_ms, work=solve_work(H, m, B))


def run_mpc(task, start, goal, n_steps):
    import torch
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                                MPCState, mpc_step,
                                                straight_line_trajs)
    params = MPCParams(gpmp2=GPMP2Params(**GP_PARAMS),
                       iters_per_step=ITERS_PER_STEP)
    state = MPCState(theta=straight_line_trajs(start, goal, H), x=start)
    costs, thetas = [], []
    for _ in range(n_steps):
        state, info = mpc_step(task.collision_residuals, state, goal, params)
        costs.append(info["collision_cost"])
        thetas.append(state.theta)
    return state, torch.stack(costs), thetas


def phase_main():
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel, terms_kernel
    task, start, goal = bench_problem("cuda", B)
    run_mpc(task, start, goal, 1)                    # warm-up
    torch.cuda.synchronize()
    kernels = (terms_kernel.KERNEL, btridiag_kernel.KERNEL)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    state, costs, thetas = run_mpc(task, start, goal, N_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    expected = N_STEPS * ITERS_PER_STEP
    check(launches == [expected, expected],
          "main path launches %s, expected %d each" % (launches, expected))
    check(all(bool(torch.isfinite(t).all()) for t in thetas),
          "main path produced non-finite theta")
    check(bool(torch.isfinite(costs).all()), "non-finite collision costs")
    step_ms = ev0.elapsed_time(ev1) / N_STEPS

    # device busy share and kernel time by name over two more steps
    busy, dev_ms, top = profile_device(
        lambda: run_mpc(task, start, goal, 2), 2)
    emit("main", B=B, H=H, steps=N_STEPS, launches={
        "terms": launches[0], "btridiag_w": launches[1]},
        step_ms=step_ms, host_wall_step_ms=wall_s * 1e3 / N_STEPS,
        solves_per_s=B / (step_ms / 1e3),
        fraction_free=task.compute_fraction_free_trajs(state.theta),
        mean_collision_cost_last=float(costs[-1].mean()),
        profiled_device_busy_share=busy,
        profiled_device_ms_per_step=dev_ms,
        top_device_ms_per_step=top)
    return launches, state.theta


def theta_gaps(th_card, th_cpu, th_64):
    """Card and CPU float32 trajectories against a float64 one, relative to
    max|theta|: worst lane, median lane, lanes within MPC_TOL."""
    n = th_64.shape[0]
    scale = float(th_64.abs().max())

    def lanes(t):
        return ((t.cpu().double() - th_64).abs().reshape(n, -1).amax(1)
                / scale)

    out = {"card_vs_cpu": float((th_card.cpu() - th_cpu).abs().max())
           / scale}
    for who, t in (("card", th_card), ("cpu", th_cpu)):
        lane = lanes(t)
        out[who + "_vs_f64"] = float(lane.max())
        out[who + "_vs_f64_median_lane"] = float(lane.median())
        out[who + "_lanes_within_tol"] = int((lane <= MPC_TOL).sum())
    return out


def f64_limits(gaps):
    """hold_to_f64's limits: twice the CPU float32 run's own error off
    float64 (+1e-5 of max|theta|), in the worst and in the median lane."""
    return {stat: 2.0 * gaps["cpu" + stat] + 1e-5
            for stat in ("_vs_f64", "_vs_f64_median_lane")}


def hold_to_f64(name: str, gaps, worst: bool = True) -> None:
    """The card may be off float64 by at most f64_limits, in its worst
    (unless ``worst`` is False) and in its median lane."""
    for stat, limit in f64_limits(gaps).items():
        if worst or stat != "_vs_f64":
            card, cpu = gaps["card" + stat], gaps["cpu" + stat]
            check(card <= limit, "%s: card theta%s %.3g, CPU float32 %.3g"
                  % (name, stat, card, cpu))


def phase_cpu():
    """One MPC step (two GN iterations) at B = 32, H = 64 on the card and
    on the CPU, held to a float64 CPU step.

    At the main path's weights (lam = 1e8) the step is ill-conditioned in
    float32: a correct float32 step is off a float64 one by up to ~0.25 of
    max|theta| in a few lanes, in the JAX package as in the port, while in
    float64 the two agree to ~1e-10 (tests/test_torch_mpc_float64.py).  So
    card and CPU are not held to each other at MPC_TOL; each is held to the
    float64 step (hold_to_f64), both per GN iteration from the same input
    (where the costs are held card vs CPU at MPC_TOL) and over the chained
    step from the straight-line plan."""
    from torch_robotics_tpu_torch.solve import GPMP2Params
    n = MPC_CPU_B
    task_c, start_c, goal_c = bench_problem("cuda", n)
    task_h, start_h, goal_h = bench_problem("cpu", n)
    iters, chained = step_vs_f64(task_c, task_h, (start_c, goal_c),
                                 (start_h, goal_h), GPMP2Params(**GP_PARAMS),
                                 H, ITERS_PER_STEP, "")
    emit("cpu", B=n, H=H, iterations=iters, chained_step=chained)


def step_vs_f64(task_c, task_h, card, cpu, params, H_, n_iters, label,
                chained_worst: bool = True):
    """One MPC step of ``n_iters`` GN iterations on the card (task_c, card
    = (start, goal)) and on the CPU (task_h, cpu), each held to a float64
    CPU step (hold_to_f64): per GN iteration from the same input, where the
    costs are held card vs CPU at MPC_TOL, and over the chained step from
    the straight-line plan (its worst lane only with ``chained_worst``) ->
    (per-iteration gaps, chained-step gaps)."""
    import torch
    from torch_robotics_tpu_torch.solve import (MPCParams, MPCState,
                                                gpmp2_step, mpc_step,
                                                straight_line_trajs)
    (start_c, goal_c), (start_h, goal_h) = card, cpu
    theta = straight_line_trajs(start_c, goal_c, H_)
    iters = []
    for it in range(n_iters):
        th_c, cost_c = gpmp2_step(task_c.collision_residuals, theta,
                                  start_c, goal_c, params)
        th_in = theta.cpu()
        th_h, cost_h = gpmp2_step(task_h.collision_residuals, th_in,
                                  start_h, goal_h, params)
        th_64, _ = gpmp2_step(task_h.collision_residuals, th_in.double(),
                              start_h.double(), goal_h.double(), params)
        rel_cost = float(((cost_c.cpu() - cost_h).abs()
                          / cost_h.abs().clamp(min=1e-30)).max())
        check(bool(torch.isfinite(th_c).all()), "card step non-finite")
        check(rel_cost <= MPC_TOL, "%siteration %d: card vs CPU cost %.3g"
              % (label, it, rel_cost))
        gaps = theta_gaps(th_c, th_h, th_64)
        hold_to_f64("%siteration %d" % (label, it), gaps)
        iters.append(dict(gaps, cost_rel_err=rel_cost))
        theta = th_c

    mp = MPCParams(gpmp2=params, iters_per_step=n_iters)
    th0 = straight_line_trajs(start_h, goal_h, H_)
    s_c, _ = mpc_step(task_c.collision_residuals, MPCState(
        th0.cuda(), start_c), goal_c, mp)
    s_h, _ = mpc_step(task_h.collision_residuals, MPCState(th0, start_h),
                      goal_h, mp)
    s_64, _ = mpc_step(task_h.collision_residuals, MPCState(
        th0.double(), start_h.double()), goal_h.double(), mp)
    check(bool(torch.isfinite(s_c.theta).all()), "chained step non-finite")
    chained = theta_gaps(s_c.theta, s_h.theta, s_64.theta)
    hold_to_f64(label + "chained step", chained, worst=chained_worst)
    return iters, chained


def phase_fk():
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
    from torch_robotics_tpu_torch.robots import RobotPanda
    robot = RobotPanda.create(device="cuda")
    n = 65536
    rng = np.random.default_rng(4)
    lo, hi = robot.model.q_lower, robot.model.q_upper
    q = torch.as_tensor(lo + rng.uniform(size=(n, lo.shape[0])) * (hi - lo),
                        dtype=torch.float32, device="cuda")
    out = fk_positions_lanes(robot.model, q)
    check(tuple(out.shape) == (n, robot.model.n_links, 3)
          and bool(torch.isfinite(out).all()), "FK output")
    ms = cuda_ms(lambda: fk_positions_lanes(robot.model, q), iters=20)
    emit("fk", B=n, ms_per_call=ms, rollouts_per_s=n / (ms / 1e3))


# ----------------------------------------------------------------------
# config 3: the EE-pose goal factor through the restarts solve
# ----------------------------------------------------------------------
def ee_problem(device, n_batch: Optional[int] = None):
    """config_panda's problem on ``device`` -> (task, start (14,), goal
    (14,), H_target (4, 4), EE terms, theta0 (n_batch, H, 14)): start and
    goal EE_START_Q and EE_GOAL_Q at rest (each checked collision-free
    with the task's margins), theta0 from a CPU generator seeded 0."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.kin import fk_all_links
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import (make_ee_goal_terms,
                                                sample_gp_prior_trajs)
    from torch_robotics_tpu_torch.tasks import PlanningTask
    robot = RobotPanda.create(device=device)
    task = PlanningTask(env=EnvSpheres3D(device=device), robot=robot,
                        obstacle_cutoff_margin=EE_CUTOFF)
    z = torch.zeros(7, device=device)
    start, goal = (torch.cat([torch.tensor(q, device=device), z])
                   for q in (EE_START_Q, EE_GOAL_Q))
    check(not bool(task.compute_collision(torch.stack([start, goal])).any()),
          "ee_goal: the start or the goal collides")
    H_target = fk_all_links(robot.model, goal[:7], link_list=["ee_link"])[0]
    terms = make_ee_goal_terms(robot, H_target, sigma_ee=EE_SIGMA,
                               w_rot=EE_W_ROT, device=device)
    theta0 = sample_gp_prior_trajs(torch.Generator().manual_seed(0), start,
                                   goal, EE_H, n_batch or EE_B, EE_GP["dt"],
                                   EE_INIT_SIGMA)
    return task, start, goal, H_target, terms, theta0


def ee_pos_err(task, trajs, H_target):
    """The final waypoints' EE position errors (B,)."""
    import torch
    H_final = task.robot.get_EE_pose(trajs[:, -1, :7])
    return torch.linalg.vector_norm(H_final[:, 0, :3, 3] - H_target[:3, 3],
                                     dim=-1)


def phase_ee_goal():
    """Config 3 at full width (run_all.py config_panda): the EE factor on
    the card vs float64 on random q; one GN step with the factor at B =
    4096 held on its first EE_F64_B lanes to a float64 CPU step (phase
    cpu's rule); K1 and K2 at this path's shapes vs plain, timed; the
    restarts solve (30 + 2 x 30 GN steps): exactly 90 K1 and 90 K2
    launches, finite outputs, fraction free and median EE position error
    above their floors, wall, trajs/s and a profile."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import (GPMP2Params, gpmp2_step,
                                                gpmp2_solve_restarts,
                                                make_ee_goal_terms)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task, start, goal, H_target, terms, theta0 = ee_problem("cuda")
    # the CPU side of the float64 holds: the card's start, goal and target
    task_h = PlanningTask(env=EnvSpheres3D(device="cpu"),
                          robot=RobotPanda.create(device="cpu"),
                          obstacle_cutoff_margin=EE_CUTOFF)
    start_h, goal_h = start.cpu(), goal.cpu()
    terms_h = make_ee_goal_terms(task_h.robot, H_target.cpu(),
                                 sigma_ee=EE_SIGMA, w_rot=EE_W_ROT,
                                 device="cpu")
    params = GPMP2Params(**EE_GP)

    # the factor alone: card vs float64 on random q
    q = task.robot.random_q(torch.Generator().manual_seed(12), 4096)
    got = terms(q)
    ref = terms_h(q.cpu().double())
    terms_rel = max_errs([g.cpu().double() for g in got[:2]], ref[:2])[1]
    check(all(bool(torch.isfinite(g).all()) for g in got)
          and terms_rel <= EE_TERMS_TOL,
          "ee_goal: the factor on the card is %.3g of max off float64"
          % terms_rel)

    # one GN step with the factor at full width, its first lanes held to
    # a float64 CPU step from the same input
    th_c, cost_c = gpmp2_step(task.collision_residuals, theta0, start, goal,
                              params, terms)
    th_in = theta0[:EE_F64_B].cpu()
    th_h, cost_h = gpmp2_step(task_h.collision_residuals, th_in, start_h,
                              goal_h, params, terms_h)
    th_64, _ = gpmp2_step(task_h.collision_residuals, th_in.double(),
                          start_h.double(), goal_h.double(), params, terms_h)
    check(bool(torch.isfinite(th_c).all()), "ee_goal: card step non-finite")
    rel_cost = float(((cost_c[:EE_F64_B].cpu() - cost_h).abs()
                      / cost_h.abs().clamp(min=1e-30)).max())
    check(rel_cost <= MPC_TOL, "ee_goal step: card vs CPU cost %.3g"
          % rel_cost)
    gaps = theta_gaps(th_c[:EE_F64_B], th_h, th_64)
    hold_to_f64("ee_goal step", gaps)

    # K1 and K2 at this path's shapes: the first q (theta0's waypoints,
    # h-major lanes) and the first GN system with the factor
    lanes_terms = task.collision_residuals.obstacle_terms_lanes
    q_main = theta0[..., :7].permute(2, 1, 0).reshape(7, -1).contiguous()
    k1_errs = {}
    hold_terms("main_q_N%d" % q_main.shape[1], lanes_terms.unscaled(q_main),
               lanes_terms.plain.unscaled(q_main), k1_errs)
    k1_ms = device_ms(lambda: lanes_terms.unscaled(q_main), iters=20)
    k1_plain = cuda_ms(lambda: lanes_terms.plain.unscaled(q_main), iters=3,
                       warmup=1)
    r = lanes_terms.plain.rows(q_main)[0]
    k1_work = terms_work(TermsLayout(task), q_main, r)
    b_l, D_l, U_l, _ = _lanes_gn_system(lanes_terms, theta0, start, goal,
                                        params, terms)
    H_, m, _, B_ = D_l.shape
    x_k = solve_lanes_w(D_l, U_l, b_l)
    x_p = solve_lanes_core(D_l, U_l, b_l)
    x_64 = solve_lanes_core(D_l.double(), U_l.double(), b_l.double())
    rel_k64 = max_errs([x_k.double()], [x_64])[1]
    rel_p64 = max_errs([x_p.double()], [x_64])[1]
    check(bool(torch.isfinite(x_k).all())
          and rel_k64 <= SOLVE_GN_FACTOR * rel_p64 + SOLVE_TOL_RANDOM,
          "ee_goal: K2 on the GN system with the factor %.3g of max|x| off "
          "float64 (plain %.3g)" % (rel_k64, rel_p64))
    del x_64
    k2_ms = device_ms(lambda: solve_lanes_w(D_l, U_l, b_l), iters=20)
    k2_plain = cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l), iters=2,
                       warmup=1)
    torch.cuda.empty_cache()
    k2_lib = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=2, warmup=1)
    torch.cuda.empty_cache()

    # the restarts solve
    def free_fn(trajs):
        return ~task.trajs_collision_masks(trajs)[0]

    def solve():
        return gpmp2_solve_restarts(
            task.collision_residuals, theta0, start, goal, params, free_fn,
            torch.Generator().manual_seed(42), ee_goal_terms=terms,
            restart_rounds=EE_ROUNDS, restart_iters=EE_RESTART)

    solve()                                                    # warm-up
    res, launches, ms = counted(solve)
    expected = EE_ITERS + EE_ROUNDS * EE_RESTART
    check(launches == {"terms": expected, "btridiag_w": expected},
          "ee_goal launches %s, expected %d K1 and %d K2 only"
          % (launches, expected, expected))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "ee_goal: the restarts solve produced non-finite results")
    free = float(free_fn(res.trajs).float().mean())
    err = ee_pos_err(task, res.trajs, H_target)
    err_med = float(err.median())
    check(free >= EE_MIN_FREE, "ee_goal: fraction free %.4f below %.2f"
          % (free, EE_MIN_FREE))
    check(err_med <= EE_MAX_POS_ERR, "ee_goal: median EE error %.4g m "
          "above %.3g" % (err_med, EE_MAX_POS_ERR))
    busy, dev_ms, top = profile_device(solve, 1)
    emit("ee_goal", B=EE_B, H=EE_H, main_iters=EE_ITERS, rounds=EE_ROUNDS,
         restart_iters=EE_RESTART, sigma_ee=EE_SIGMA, w_rot=EE_W_ROT,
         launches=launches, wall_ms=ms, trajs_per_s=EE_B / (ms / 1e3),
         fraction_free=free, ee_pos_err_median_m=err_med,
         ee_pos_err_p90_m=float(err.quantile(0.9)),
         jax_package=EE_JAX, factor_rel_err_vs_f64=terms_rel,
         step_vs_f64=dict(gaps, cost_rel_err=rel_cost),
         k1=dict(max_errs=k1_errs, kernel_ms=k1_ms, plain_ms=k1_plain),
         k2=dict(kernel_vs_f64=rel_k64, plain_vs_f64=rel_p64,
                 kernel_ms=k2_ms, plain_ms=k2_plain, dense_solve_ms=k2_lib),
         profiled_device_busy_share=busy, profiled_device_ms_per_solve=dev_ms,
         top_device_ms_per_solve=top)
    return (dict(max_abs_err=k1_errs["main_q_N%d" % q_main.shape[1]][0],
                 ms=k1_ms, plain_ms=k1_plain, work=k1_work,
                 launches=launches["terms"]),
            dict(max_abs_err=max_errs([x_k], [x_p])[0], ms=k2_ms,
                 plain_ms=k2_plain, library_ms=k2_lib,
                 work=solve_work(H_, m, B_),
                 launches=launches["btridiag_w"]))


# ----------------------------------------------------------------------
# config 1: IK
# ----------------------------------------------------------------------
def ik_target(device):
    """Config 1's target: z_rot(-pi/2) y_rot(-pi) at IK_TARGET_POS."""
    import math

    import torch
    from torch_robotics_tpu_torch.core.se3 import (pack_homogeneous, y_rot,
                                                   z_rot)
    return pack_homogeneous(
        z_rot(-math.pi / 2, device=device) @ y_rot(-math.pi, device=device),
        torch.tensor(IK_TARGET_POS, device=device))


def ik_f64_hold(model, H_target, q0):
    """IK_F64_ITERS DLS steps without restarts on the first IK_F64_B
    problems, on the card, on the CPU and in float64 on the CPU.  Each step
    from the card's q: the card's worst lane over the steps and the median
    of its median lanes at most twice the CPU float32 run's (+1e-5 of
    max|q|, hold_to_f64).  The chained run (the solver's own loop): its
    median lane so held, its valid count within IK_VALID_TOL of the CPU's
    (its worst lane is reported, not held: a problem that has not
    converged wanders through the clipped limits, chaotically in float32
    on either device)."""
    import math

    import torch
    from torch_robotics_tpu_torch.kin import robot_zoo
    from torch_robotics_tpu_torch.kin.ik import (_dls_setup, _dls_step,
                                                 _ik_gn_run)
    model_h = robot_zoo.franka_panda(device="cpu")
    eps = math.pi / 100
    q0 = q0[:IK_F64_B]
    lo = torch.tensor(model.q_lower + eps, device="cuda")
    hi = torch.tensor(model.q_upper - eps, device="cuda")
    H_h = H_target.cpu()
    c = {dt: _dls_setup(model_h, H_h[None], "ee_link",
                        torch.zeros((), dtype=dt))
         for dt in (torch.float32, torch.float64)}
    c_card = _dls_setup(model, H_target[None], "ee_link", q0)
    q, worst, medians = q0, [], []
    for _ in range(IK_F64_ITERS):
        q_c = _dls_step(model, c_card, q, lo, hi, 1e-4)
        q_in = q.cpu()
        q_h = _dls_step(model_h, c[torch.float32], q_in, lo.cpu(), hi.cpu(),
                        1e-4)
        q_64 = _dls_step(model_h, c[torch.float64], q_in.double(),
                         lo.cpu().double(), hi.cpu().double(), 1e-4)
        g = theta_gaps(q_c, q_h, q_64)
        worst.append((g["card_vs_f64"], g["cpu_vs_f64"]))
        medians.append((g["card_vs_f64_median_lane"],
                        g["cpu_vs_f64_median_lane"]))
        q = q_c
    worst, medians = np.asarray(worst), np.asarray(medians)
    steps = {"card_vs_f64": float(worst[:, 0].max()),
             "cpu_vs_f64": float(worst[:, 1].max()),
             "card_vs_f64_median_lane": float(np.median(medians[:, 0])),
             "cpu_vs_f64_median_lane": float(np.median(medians[:, 1]))}
    hold_to_f64("ik steps", steps)

    runs = {}
    for key, m_, dt, dev in (("card", model, torch.float32, "cuda"),
                             ("cpu", model_h, torch.float32, "cpu"),
                             ("f64", model_h, torch.float64, "cpu")):
        runs[key] = _ik_gn_run(
            m_, H_target[None].to(dev, dt), "ee_link", q0.to(dev, dt),
            lo.to(dev, dt), hi.to(dev, dt), IK_F64_ITERS, 1e-4, IK_EPS,
            None, IK_F64_ITERS + 1)                  # no restart draws
    chained = theta_gaps(runs["card"].q, runs["cpu"].q, runs["f64"].q)
    hold_to_f64("ik chained run", chained, worst=False)
    n_valid = {k: int(v.valid.sum()) for k, v in runs.items()}
    check(abs(n_valid["card"] - n_valid["cpu"]) <= IK_VALID_TOL,
          "ik chained run: %d valid on the card, %d on the CPU"
          % (n_valid["card"], n_valid["cpu"]))
    return dict(steps=steps, chained=chained, valid=n_valid)


def phase_ik():
    """Config 1's IK at full width (run_all.py config_fk_ik): DLS at B =
    1024 (valid fraction above its floor, finite), its float64 hold
    (ik_f64_hold) and Adam at IK_ADAM_ITERS (finite); no kernel launches;
    valid fraction, median iterations and wall time of both solvers."""
    import torch
    from torch_robotics_tpu_torch.kin import (inverse_kinematics,
                                              inverse_kinematics_gn,
                                              robot_zoo)
    model = robot_zoo.franka_panda(device="cuda")
    H_target = ik_target("cuda")

    def dls(n_iters=IK_ITERS):
        return inverse_kinematics_gn(
            model, H_target, batch_size=IK_B, max_iters=n_iters,
            se3_eps=IK_EPS, restart_every=IK_RESTART,
            generator=torch.Generator().manual_seed(1), device="cuda")

    def adam():
        return inverse_kinematics(
            model, H_target, batch_size=IK_B, max_iters=IK_ADAM_ITERS,
            generator=torch.Generator().manual_seed(2), device="cuda")

    dls(2)                                                     # warm-up
    out = {}
    for name, fn in (("dls", dls), ("adam", adam)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, launches, _ = counted(fn)
        wall = time.perf_counter() - t0
        check(not launches, "ik %s launched kernels %s" % (name, launches))
        check(all(bool(torch.isfinite(t).all())
                  for t in (res.q, res.err_se3)),
              "ik %s: non-finite results" % name)
        out[name] = dict(
            wall_s=wall, valid_fraction=float(res.valid.float().mean()),
            median_iters=float(res.iters_to_valid.float().median()),
            median_err_se3=float(res.err_se3.median()))
        if name == "dls":
            q0 = dls(0).q
    check(out["dls"]["valid_fraction"] >= IK_MIN_VALID,
          "ik: DLS valid fraction %.4f below %.2f"
          % (out["dls"]["valid_fraction"], IK_MIN_VALID))
    hold = ik_f64_hold(model, H_target, q0)
    emit("ik", B=IK_B, iters=IK_ITERS, restart_every=IK_RESTART,
         se3_eps=IK_EPS, adam_iters=IK_ADAM_ITERS, jax_package=IK_JAX,
         f64_hold=hold, **out)


# ----------------------------------------------------------------------
# the iLQR path: benchmarks/ilqr_sgpmp_bench.py's "ilqr_batch" workload
# ----------------------------------------------------------------------
def ilqr_task(device):
    """Panda in EnvSpheres3D at the iLQR bench's cutoff 0.06."""
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    return PlanningTask(env=EnvSpheres3D(device=device),
                        robot=RobotPanda.create(device=device),
                        obstacle_cutoff_margin=0.06)


def ilqr_problem(device):
    """The iLQR bench's draw (ilqr_sgpmp_bench.py:86-102) -> (task, start,
    goal) (IL_B, 14): collision-free starts from a seeded CPU generator,
    goals the first collision-free of 16 perturbations of each start
    (numpy seed, 0.6 rad, clipped 0.01 inside the joint limits)."""
    import torch
    task = ilqr_task(device)
    robot = task.robot
    d = robot.q_dim
    qs, n_valid = task.random_coll_free_q(
        torch.Generator().manual_seed(SEED), n_samples=IL_B,
        max_samples=IL_B * 64)
    check(n_valid == IL_B, "only %d collision-free starts" % n_valid)
    noise = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(16, IL_B, d)), dtype=torch.float32, device=device)
    pert = torch.clamp(qs + 0.6 * noise, robot.q_min + 0.01,
                       robot.q_max - 0.01)
    free = ~task.compute_collision(pert.reshape(-1, d)).reshape(16, IL_B)
    idx = torch.argmax(free.to(torch.int32), dim=0)          # first free
    qg = torch.where(free.any(0)[:, None],
                     pert[idx, torch.arange(IL_B, device=device)], qs)
    z = torch.zeros_like(qs)
    return task, torch.cat([qs, z], -1), torch.cat([qg, z], -1)


def ilqr_limits(task):
    return (task.robot.q_min, task.robot.q_max)


def capture_first_iteration(task, start, goal, params=IL_PARAMS, **solve_kw):
    """One iLQR iteration on the path's problem, keeping what its kernels
    were given: the sweep's factory arguments and inputs, the rollout's,
    and each cost call's q (keyed by its N).  ``params`` and ``solve_kw``
    (``x_ref``, ``u_init``) give another workload's first iteration."""
    from torch_robotics_tpu_torch.ops import riccati_kernel
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve
    seen = {}
    names = {"sweep": "riccati_backward_kernel_factory",
             "roll": "linesearch_rollout_kernel_factory"}
    originals = {k: getattr(riccati_kernel, v) for k, v in names.items()}

    def tapped(key):
        def factory(*args):
            fn = originals[key](*args)

            def tap(*ins):
                seen.setdefault(key, (args, [t.clone() for t in ins]))
                return fn(*ins)
            return tap
        return factory

    res = task.collision_residuals
    cost = res.collision_cost_lanes

    def cost_tap(q_cols):
        seen.setdefault("cost_%d" % q_cols.shape[1], q_cols.clone())
        return cost(q_cols)

    try:
        for k, v in names.items():
            setattr(riccati_kernel, v, tapped(k))
        res.collision_cost_lanes = cost_tap
        ilqr_solve(res, start, goal,
                   ILQRParams(**dict(params, opt_iters=1)),
                   q_limits=ilqr_limits(task), **solve_kw)
    finally:
        for k, v in names.items():
            setattr(riccati_kernel, v, originals[k])
        res.collision_cost_lanes = cost
    return seen


def capture_mpc_first(task, start, goal):
    """What the sweep and the rollout were given at the tracking loop's
    first step (phase ilqr_mpc's shapes: T = MPC_H - 1, its running goal
    rows in P), tracking the straight line to the goal: capture_first_
    iteration's dict."""
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    x_ref = straight_line_trajs(start, goal, MPC_H)
    return capture_first_iteration(task, start, goal, MPC_PARAMS,
                                   x_ref=x_ref)


def hold_sweep_random(key, d, P, T, Bn, seed, results):
    """K6 vs its plain version on random well-conditioned inputs (kg = 1e4,
    r = 1e-4) at d joints, P rows, T steps and Bn lanes, to RICCATI_TOL of
    max|ref|; returns the launch shape it took."""
    import torch
    from torch_robotics_tpu_torch.ops.riccati_kernel import (
        riccati_backward_kernel_factory, riccati_launch_config)
    m = 2 * d
    rng = np.random.default_rng(seed)
    ins = [torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device="cuda")
           for shape in ((T, d, Bn), (T, m, Bn), (T, m, P, Bn), (m, Bn))]
    fn = riccati_backward_kernel_factory(d, m, P, T, IL_PARAMS["dt"], 1e-4,
                                         1e-6, 1e4)
    got, ref = fn(*ins), fn.plain(*ins)
    err, rel = max_errs(got, ref)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          key + ": non-finite")
    check(rel <= RICCATI_TOL, "%s: kernel vs plain %.3g of max|ref|"
          % (key, rel))
    cfg = riccati_launch_config(d, P, Bn)
    results[key] = dict(abs=err, rel_to_max=rel,
                        lanes=cfg["lanes_per_block"], stages=cfg["stages"])
    return cfg


def phase_riccati(seen, mpc_seen):
    """K6 and K7 vs their plain versions at the path's shapes (B = 512) and
    at a ragged B = 100: on random well-conditioned inputs (kg = 1e4,
    r = 1e-4, as tests/test_pallas_riccati.py) K6 to 1e-5 and K7 to 1e-6
    of max|ref|; on the path's first-iteration inputs (kg / r = 4e10), and
    K6 and K7 on the tracking loop's (T = 15), each to a float64 plain
    version, no worse than twice the plain float32 version's error (+ the
    random-input tolerance).  K6 also on random inputs at every d in 1..8
    (T = 6, B = 100, P = 1 and 27: every group size), at d = 7 with a P
    that makes the launch take fewer lanes per block (B = 512) and at the
    P cap (one stage, B = 100); K7 on random inputs at every d in 1..8 (T
    = 6, B = 100); a K7 lane's bits at the batches that take 4, 2 and 1
    lanes a block.  Timed at T = 31 and K6 at the tracking loop's T = 15
    (K7 by device_ms: a call's host time exceeds its device time; phase
    ilqr_mpc times K7 at T = 15)."""
    import torch
    from torch_robotics_tpu_torch.ops.riccati_kernel import (
        linesearch_rollout_kernel_factory, riccati_backward_kernel_factory,
        riccati_launch_config, riccati_p_cap, rollout_launch_config)
    s_args, s_ins = seen["sweep"]
    r_args, r_ins = seen["roll"]
    m_args, m_ins = mpc_seen["sweep"]
    mr_args, mr_ins = mpc_seen["roll"]
    d, m, P, T, dt, r, mu, kg = s_args
    alphas = r_args[4]
    sweep = riccati_backward_kernel_factory(*s_args)
    mpc = riccati_backward_kernel_factory(*m_args)
    roll = linesearch_rollout_kernel_factory(*r_args)
    mpc_roll = linesearch_rollout_kernel_factory(*mr_args)
    rng = np.random.default_rng(6)

    def rand(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.normal(size=shape),
                               dtype=torch.float32, device="cuda")

    rand_sweep = riccati_backward_kernel_factory(d, m, P, T, dt, 1e-4, mu,
                                                 1e4)
    s_rand = [rand(T, d, IL_B), rand(T, m, IL_B), rand(T, m, P, IL_B),
              rand(m, IL_B)]
    r_rand = [rand(T + 1, m, IL_B), rand(T, d, IL_B), rand(T, d, IL_B),
              rand(T, d, m, IL_B, scale=0.1)]
    results = {}

    def hold_f64(key, fn, ins, tol):
        got, ref = fn(*ins), fn.plain(*ins)
        ref64 = fn.plain(*[t.double() for t in ins])
        err, rel = max_errs(got, ref)
        rel_k64 = max_errs([g.double() for g in got], ref64)[1]
        rel_p64 = max_errs([g.double() for g in ref], ref64)[1]
        check(all(bool(torch.isfinite(g).all()) for g in got),
              key + ": non-finite")
        check(rel_k64 <= 2.0 * rel_p64 + tol,
              "%s: kernel vs float64 %.3g, plain float32 vs float64 "
              "%.3g of max|ref|" % (key, rel_k64, rel_p64))
        results[key] = dict(abs=err, rel_to_max=rel,
                            kernel_vs_f64=rel_k64, plain_vs_f64=rel_p64)

    for kname, fn, path_ins, rand_fn, rand_ins, tol in (
            ("riccati", sweep, s_ins, rand_sweep, s_rand, RICCATI_TOL),
            ("rollout", roll, r_ins, roll, r_rand, ROLLOUT_TOL)):
        for Bn in (IL_B, 100):
            def cut(ins):
                return [t[..., :Bn].contiguous() for t in ins]
            key = "%s_random_B%d" % (kname, Bn)
            got, ref = rand_fn(*cut(rand_ins)), rand_fn.plain(*cut(rand_ins))
            err, rel = max_errs(got, ref)
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  key + ": non-finite")
            check(rel <= tol, "%s: kernel vs plain %.3g of max|ref|"
                  % (key, rel))
            results[key] = dict(abs=err, rel_to_max=rel)
            hold_f64("%s_path_B%d" % (kname, Bn), fn, cut(path_ins), tol)
            if kname == "riccati":
                hold_f64("riccati_mpc_T%d_B%d" % (m_args[3], Bn), mpc,
                         cut(m_ins), tol)
            else:
                hold_f64("rollout_mpc_T%d_B%d" % (mr_args[2], Bn), mpc_roll,
                         cut(mr_ins), tol)
    # K7 at every d (each instantiation), random inputs
    for dd in range(1, 9):
        mm = 2 * dd
        fn = linesearch_rollout_kernel_factory(dd, mm, 6, dt, alphas)
        ins = [rand(7, mm, 100), rand(6, dd, 100), rand(6, dd, 100),
               rand(6, dd, mm, 100, scale=0.1)]
        key = "rollout_random_d%d_T6_B100" % dd
        got, ref = fn(*ins), fn.plain(*ins)
        err, rel = max_errs(got, ref)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              key + ": non-finite")
        check(rel <= ROLLOUT_TOL, "%s: kernel vs plain %.3g of max|ref|"
              % (key, rel))
        results[key] = dict(abs=err, rel_to_max=rel)

    # every group size, and the launch shapes that large P takes
    for dd in range(1, 9):
        for PP in (1, 27):
            hold_sweep_random("riccati_random_d%d_P%d_T6_B100" % (dd, PP),
                              dd, PP, 6, 100, 10 * dd + PP, results)
    few = hold_sweep_random("riccati_random_d7_P%d_T4_B%d"
                            % (RIC_FEWER_LANES_P, IL_B), 7,
                            RIC_FEWER_LANES_P, 4, IL_B, 7, results)
    check(few["lanes_per_block"]
          < riccati_launch_config(7, 27, IL_B)["lanes_per_block"],
          "P = %d did not take fewer lanes per block" % RIC_FEWER_LANES_P)
    cap = riccati_p_cap(7)
    hold_sweep_random("riccati_random_d7_P%d_cap_T2_B100" % cap, 7, cap, 2,
                      100, 8, results)

    out = {}
    for kname, fn, ins, work in (
            ("riccati", sweep, s_ins, riccati_work(d, m, P, T, IL_B)),
            ("riccati_mpc", mpc, m_ins,
             riccati_work(d, m, m_args[2], m_args[3], IL_B)),
            ("rollout", roll, r_ins,
             rollout_work(d, m, T, len(alphas), IL_B))):
        k_ms = (device_ms(lambda: fn(*ins), iters=20) if kname == "rollout"
                else cuda_ms(lambda: fn(*ins), iters=20))
        p_ms = cuda_ms(lambda: fn.plain(*ins), iters=2, warmup=1)
        key = ("riccati_mpc_T%d_B%d" % (m_args[3], IL_B)
               if kname == "riccati_mpc" else "%s_path_B%d" % (kname, IL_B))
        out[kname] = dict(max_abs_err=results[key]["abs"], ms=k_ms,
                          plain_ms=p_ms, work=work)
    out["rollout"]["call_ms"] = cuda_ms(lambda: roll(*r_ins), iters=20)
    # K7: a lane's bits whatever the batch and the lanes a block it takes
    # (rollout_launch_config): the path's inputs tiled to B = 4096, cut to
    # 510, 509 and 100
    full = roll(*r_ins)
    lanes_by_B = {}
    for Bn in (4096, 510, 509, 100):
        reps = -(-Bn // IL_B)
        ins = [torch.cat([t] * reps, -1)[..., :Bn].contiguous()
               for t in r_ins]
        ref = [torch.cat([f] * reps, -1)[..., :Bn] for f in full]
        lanes_by_B[Bn] = rollout_launch_config(
            d, len(alphas), Bn)["lanes_per_block"]
        check(all(torch.equal(a, b) for a, b in zip(roll(*ins), ref)),
              "rollout: other bits at B = %d (%d lanes a block)"
              % (Bn, lanes_by_B[Bn]))
    check({1, 2, 4} <= set(lanes_by_B.values()),
          "rollout: the batches took lanes a block %s" % lanes_by_B)
    emit("riccati", shapes=dict(T=T, d=d, m=m, P=P, A=len(alphas), B=IL_B,
                                mpc_T=m_args[3], mpc_P=m_args[2]),
         launch=riccati_launch_config(d, P, IL_B), max_errs=results,
         **{k + "_ms": v["ms"] for k, v in out.items()},
         **{k + "_plain_ms": v["plain_ms"] for k, v in out.items()},
         **{k + "_bound_ms": bound_ms(*v["work"])[0]
            for k, v in out.items()},
         rollout_call_ms=out["rollout"]["call_ms"],
         rollout_launch=rollout_launch_config(d, len(alphas), IL_B),
         rollout_lanes_a_block_by_B=lanes_by_B)
    out["rollout_mpc_err"] = results["rollout_mpc_T%d_B%d"
                                     % (mr_args[2], IL_B)]["abs"]
    return out


def hold_terms(name, got, ref, results):
    """A terms kernel's outputs held to its plain version at the terms
    tolerance; the errors go to ``results[name]``."""
    import torch
    for g, r in zip(got, ref):
        tol = TERMS_ATOL_REL * float(r.abs().max()) + TERMS_RTOL * r.abs()
        check(bool(torch.isfinite(g).all()), name + ": non-finite terms")
        check(bool(((g - r).abs() <= tol).all()),
              "%s: terms kernel disagrees with its plain version" % name)
    results[name] = max_errs(got, ref)


def hold_cost(name, got, ref):
    """A cost kernel's output held to its plain version at the terms
    tolerance -> (max abs error, relative to max|ref|)."""
    import torch
    tol = TERMS_ATOL_REL * float(ref.abs().max()) + TERMS_RTOL * ref.abs()
    check(bool(torch.isfinite(got).all()), name + ": non-finite cost")
    check(bool(((got - ref).abs() <= tol).all()),
          "%s: cost kernel disagrees with its plain version" % name)
    return max_errs([got], [ref])


def same_lane_bits(name, cost, run, q, n_ragged: int = 1000):
    """A lane's cost bits depend neither on the batch (the first n_ragged
    lanes alone) nor on the lanes a block (32 lanes)."""
    import torch
    full = cost(q)
    d, ints, floats, _ = cost.params
    ragged = cost(q[:, :n_ragged].contiguous())
    check(torch.equal(ragged, full[:n_ragged]),
          name + ": a lane's bits change with the batch")
    check(torch.equal(run(q, ints, floats, d, lanes=32, grid=cost.grid),
                      full),
          name + ": a lane's bits change with the lanes a block")


def capture_cost_inputs(task, theta0, start_p, goal_p, params):
    """The cost hook's last q (d, N) of each N in one sGPMP iteration: the
    candidates (N = K B H) and the proposal the acceptance scores (N = B
    H)."""
    import torch
    from torch_robotics_tpu_torch.solve import SGPMPParams, sgpmp_solve
    p = SGPMPParams(**dict(params, opt_iters=1))
    res = task.collision_residuals
    cost = res.collision_cost_lanes
    seen = {}

    def tap(q_cols):
        seen[q_cols.shape[1]] = q_cols.clone()
        return cost(q_cols)

    try:
        res.collision_cost_lanes = tap
        sgpmp_solve(res, theta0, start_p, goal_p, p,
                    generator=torch.Generator(device="cuda").manual_seed(3))
    finally:
        res.collision_cost_lanes = cost
    return seen


def varied_radii_task():
    """The iLQR task with EnvSpheres3D's radii spread over 0.6-1.4x: its
    sphere group keeps a radius per sphere, where EnvSpheres3D's share one
    (the cost kernel scores the two kinds of group apart)."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    env = EnvSpheres3D(device="cuda")
    sph = env.obj_fixed_list[0].fields[0]
    sph.radii.mul_(torch.linspace(0.6, 1.4, sph.radii.shape[0],
                                  device="cuda"))
    return PlanningTask(env=env, robot=RobotPanda.create(device="cuda"),
                        obstacle_cutoff_margin=0.06)


def phase_cost(task, seen, start, goal):
    """K8 vs its plain version on the iLQR path's line-search q (N = A B T,
    the first iteration's), on random q, on the sGPMP path's first
    candidates (N = K B H) and proposal (N = B H, the acceptance's) and on
    random q in a scene whose spheres differ in radius, at the terms
    kernel's tolerance; a lane's bits the same at a ragged N and at 32
    lanes a block; timed at the three path shapes (the kernel's device
    time over a CUDA graph of calls, a call's by CUDA events)."""
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.ops.terms_kernel import run_cost_kernel
    cost = task.collision_residuals.collision_cost_lanes
    T = IL_H - 1
    N = len(IL_ALPHAS) * IL_B * T
    q_ls = seen["cost_%d" % N]
    check(tuple(q_ls.shape) == (7, N), "line-search q %s" % (q_ls.shape,))
    N_sg = SG_PARAMS["num_samples"] * IL_B * SG_PART * IL_H
    seen_sg = capture_cost_inputs(task, *sg_problem(
        start, goal, SG_PART, IL_H, SG_PARAMS["dt"], SEED + 2), SG_PARAMS)
    q_sg, q_acc = seen_sg[N_sg], seen_sg[IL_B * SG_PART * IL_H]
    varied = varied_radii_task()
    results = {}
    for name, t, q in (("line_search_q_N%d" % N, task, q_ls),
                       ("random_q_N%d" % N, task, random_q(task, N, seed=5)),
                       ("sgpmp_candidates_N%d" % N_sg, task, q_sg),
                       ("sgpmp_acceptance_N%d" % q_acc.shape[1], task,
                        q_acc),
                       ("varied_radii_random_q_N8192", varied,
                        random_q(varied, 8192, seed=6))):
        c = t.collision_residuals.collision_cost_lanes
        results[name] = hold_cost(name, c(q), c.plain(q))
        same_lane_bits(name, c, run_cost_kernel, q)
    lay = TermsLayout(task)
    r = task.collision_residuals.obstacle_terms_lanes.plain.rows(q_ls)[0]
    out = {}
    for key, q, iters in (("line_search", q_ls, 50), ("sgpmp", q_sg, 20),
                          ("acceptance", q_acc, 50)):
        out[key] = dict(N=q.shape[1], ms=device_ms(lambda: cost(q), iters),
                        call_ms=cuda_ms(lambda: cost(q), iters=iters),
                        plain_ms=cuda_ms(lambda: cost.plain(q), iters=2,
                                         warmup=1),
                        work=cost_work(lay, q.shape[1], r.shape[0]))
    torch.cuda.empty_cache()
    emit("cost", max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                           for k, v in results.items()},
         kernel_ms={k: v["ms"] for k, v in out.items()},
         call_ms={k: v["call_ms"] for k, v in out.items()},
         plain_ms={k: v["plain_ms"] for k, v in out.items()},
         bound_ms={k: bound_ms(*v["work"])[0] for k, v in out.items()},
         launch=cost.params[3], active_row_share=float((r > 0).float()
                                                       .mean()))
    out["line_search"]["max_abs_err"] = results["line_search_q_N%d" % N][0]
    out["sgpmp"]["max_abs_err"] = results["sgpmp_candidates_N%d" % N_sg][0]
    return out


def feasibility_residual(trajs, controls, dt: float) -> float:
    """max |x_{t+1} - (Phi x_t + B u_t)| (ilqr_sgpmp_bench.py:49-58)."""
    d = trajs.shape[-1] // 2
    q, qd = trajs[..., :d], trajs[..., d:]
    q_next = q[..., :-1, :] + dt * qd[..., :-1, :] + 0.5 * dt * dt * controls
    qd_next = qd[..., :-1, :] + dt * controls
    return max(float((trajs[..., 1:, :d] - q_next).abs().max()),
               float((trajs[..., 1:, d:] - qd_next).abs().max()))


def ilqr_quality(task, res, goal):
    d = goal.shape[-1] // 2
    dist = (res.trajs[:, -1, :d] - goal[:, :d]).norm(dim=-1)
    return dict(fraction_free=task.compute_fraction_free_trajs(res.trajs),
                mean_final_goal_dist=float(dist.mean()),
                median_final_goal_dist=float(dist.median()))


def phase_ilqr(task, start, goal):
    """The iLQR path at full width: B = 512, H = 32, 30 iterations; launch
    counts exactly 30 / 30 / 31 (K6 / K7 / K8), finite and dynamically
    feasible trajectories, quality, CUDA-event timing, a profile."""
    import torch
    from torch_robotics_tpu_torch.ops import riccati_kernel, terms_kernel
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve
    params = ILQRParams(**IL_PARAMS)

    def solve():
        return ilqr_solve(task.collision_residuals, start, goal, params,
                          q_limits=ilqr_limits(task))

    solve()                                           # warm-up
    torch.cuda.synchronize()
    kernels = (riccati_kernel.RICCATI_KERNEL, riccati_kernel.ROLLOUT_KERNEL,
               terms_kernel.COST_KERNEL)
    for k in kernels:
        k.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    res = solve()
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    check(launches == [IL_ITERS, IL_ITERS, IL_ITERS + 1],
          "iLQR launches %s, expected [%d, %d, %d]"
          % (launches, IL_ITERS, IL_ITERS, IL_ITERS + 1))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "iLQR produced non-finite results")
    feas = feasibility_residual(res.trajs, res.controls, IL_PARAMS["dt"])
    check(feas <= 1e-4 * float(res.trajs.abs().max()),
          "iLQR states break the double integrator by %.3g" % feas)
    solve_ms = ev0.elapsed_time(ev1)
    busy, dev_ms, top = profile_device(solve, IL_ITERS)
    emit("ilqr", B=IL_B, H=IL_H, iterations=IL_ITERS,
         launches=dict(riccati=launches[0], rollout=launches[1],
                       cost=launches[2]),
         solve_ms=solve_ms, ms_per_iteration=solve_ms / IL_ITERS,
         host_wall_solve_ms=wall_s * 1e3,
         solves_per_s=IL_B / (solve_ms / 1e3),
         dynamics_feasibility_max_err=feas,
         mean_final_cost=float(res.costs.mean()), **ilqr_quality(
             task, res, goal),
         profiled_device_busy_share=busy,
         profiled_device_ms_per_iteration=dev_ms,
         top_device_ms_per_iteration=top)
    return launches, res


def phase_ilqr_cpu(task_c, start, goal):
    """At B = 32: one iteration from the same input on the card and on the
    CPU, each held to a float64 CPU iteration (worst and median lane, as
    phase cpu holds the MPC step); then the whole solve's fraction free
    and median final goal distance near the CPU float32 run's.  Per-lane
    trajectories after 30 iterations are not compared: the line search
    takes the first argmin over 5 step sizes, and a last-bit difference
    flips it in a lane."""
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve
    n = IL_CPU_B
    task_h = ilqr_task("cpu")
    s_c, g_c = start[:n].contiguous(), goal[:n].contiguous()
    s_h, g_h = s_c.cpu(), g_c.cpu()

    def run(task, s, g, iters):
        return ilqr_solve(task.collision_residuals, s, g,
                          ILQRParams(**dict(IL_PARAMS, opt_iters=iters)),
                          q_limits=ilqr_limits(task))

    one_c, one_h = run(task_c, s_c, g_c, 1), run(task_h, s_h, g_h, 1)
    one_64 = run(task_h, s_h.double(), g_h.double(), 1)
    gaps = theta_gaps(one_c.trajs, one_h.trajs, one_64.trajs)
    hold_to_f64("iLQR iteration", gaps)
    rel_cost = float(((one_c.costs.cpu() - one_h.costs).abs()
                      / one_h.costs.abs().clamp(min=1e-30)).max())
    full_c = run(task_c, s_c, g_c, IL_ITERS)
    full_h = run(task_h, s_h, g_h, IL_ITERS)
    q_c, q_h = ilqr_quality(task_c, full_c, g_c), ilqr_quality(task_h,
                                                               full_h, g_h)
    check(abs(q_c["fraction_free"] - q_h["fraction_free"])
          <= IL_FREE_TOL + 1e-9,
          "iLQR fraction free: card %.3f, CPU %.3f"
          % (q_c["fraction_free"], q_h["fraction_free"]))
    med_c, med_h = (q_c["median_final_goal_dist"],
                    q_h["median_final_goal_dist"])
    check(abs(med_c - med_h) <= IL_DIST_TOL * med_h + 1e-2,
          "iLQR median goal distance: card %.4g, CPU %.4g" % (med_c, med_h))
    emit("ilqr_cpu", B=n, H=IL_H, one_iteration=dict(gaps,
                                                      cost_rel_err=rel_cost),
         full_solve={"card": q_c, "cpu": q_h})


def ilqr_mpc_loop(task, start, goal, plan, n_steps):
    """The bench's tracking loop (ilqr_sgpmp_bench.py:147-194): each step
    re-solves from the executed state with warm-started controls and a
    receding window of the converged plan (x_ref), executes the first
    control -> the executed states (B, n_steps, 2d)."""
    import torch
    from torch_robotics_tpu_torch.solve import ILQRParams, ilqr_solve
    params = ILQRParams(**MPC_PARAMS)
    n_b, d = start.shape[0], start.shape[-1] // 2
    pad = goal[:, None].expand(n_b, MPC_H + MPC_STEPS, 2 * d)
    ref_full = torch.cat([plan, pad], dim=1)
    x = start
    u = torch.zeros((n_b, MPC_H - 1, d), device=start.device)
    xs = []
    for t in range(n_steps):
        res = ilqr_solve(task.collision_residuals, x, goal, params,
                         u_init=u, x_ref=ref_full[:, t + 1:t + 1 + MPC_H],
                         q_limits=ilqr_limits(task))
        x = res.trajs[:, 1]
        u = torch.cat([res.controls[:, 1:], res.controls[:, -1:]], 1)
        xs.append(x)
    return torch.stack(xs, dim=1)


def phase_ilqr_mpc(task, start, goal, plan, mpc_roll, roll_err):
    """The bench's tracking loop (ilqr_mpc_loop): H_trk = 16, 3 iterations,
    30 steps, B = 512; K7 on the loop's first rollout inputs (``mpc_roll``,
    capture_mpc_first's, T = 15; held to plain in phase riccati, whose
    error is ``roll_err``) timed by device_ms -> K7's numbers at T = 15."""
    import torch
    from torch_robotics_tpu_torch.ops import riccati_kernel, terms_kernel
    d = start.shape[-1] // 2
    r_args, r_ins = mpc_roll
    roll = riccati_kernel.linesearch_rollout_kernel_factory(*r_args)
    dd, m, T = r_args[:3]
    k7 = dict(ms=device_ms(lambda: roll(*r_ins), iters=20),
              call_ms=cuda_ms(lambda: roll(*r_ins), iters=20),
              plain_ms=cuda_ms(lambda: roll.plain(*r_ins), iters=2, warmup=1),
              work=rollout_work(dd, m, T, len(r_args[4]),
                                r_ins[0].shape[-1]),
              max_abs_err=roll_err)

    def loop(n_steps):
        return ilqr_mpc_loop(task, start, goal, plan, n_steps)

    loop(1)                                            # warm-up
    torch.cuda.synchronize()
    kernels = (riccati_kernel.RICCATI_KERNEL, riccati_kernel.ROLLOUT_KERNEL,
               terms_kernel.COST_KERNEL)
    for k in kernels:
        k.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    xs = loop(MPC_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    launches = [k.launches for k in kernels]
    per = MPC_STEPS * MPC_ITERS
    check(launches == [per, per, per + MPC_STEPS],
          "iLQR MPC launches %s" % (launches,))
    check(bool(torch.isfinite(xs).all()), "iLQR MPC non-finite states")
    ms = ev0.elapsed_time(ev1)
    dist = (xs[:, -1, :d] - goal[:, :d]).norm(dim=-1)
    emit("ilqr_mpc", B=IL_B, H=MPC_H, iters_per_step=MPC_ITERS,
         steps=MPC_STEPS, launches=dict(riccati=launches[0],
                                        rollout=launches[1],
                                        cost=launches[2]),
         ms_per_step=ms / MPC_STEPS,
         solves_per_s=IL_B * MPC_STEPS / (ms / 1e3),
         rollout_T=T, rollout_ms=k7["ms"], rollout_call_ms=k7["call_ms"],
         rollout_plain_ms=k7["plain_ms"],
         rollout_bound_ms=bound_ms(*k7["work"])[0],
         fraction_free_executed=task.compute_fraction_free_trajs(
             xs[..., :d]),
         mean_final_goal_dist=float(dist.mean()),
         median_final_goal_dist=float(dist.median()))
    k7["launches"] = launches[1]
    return k7


# ----------------------------------------------------------------------
# the multi-robot path: benchmarks/run_all.py config_multi_robot (config 4)
# ----------------------------------------------------------------------
def mr_task(device, poses=MR_POSES, pairs=(), env=None,
            grasp: bool = False):
    """The config-4 robot (two Pandas and a UR10 at their base poses: kind,
    (x, y) or (x, y, z), yaw), or the members of ``poses``, in EnvSpheres3D
    (or ``env``) at cutoff 0.02, ``pairs`` ((a, b), margin) after the pair
    list ``MultiRobot.create`` builds (a same-member pair gives the
    reference's warning); with ``grasp`` its first Panda holds a
    GRASP_MR_BOX box.  ``mr_task(device, *MR_CELLS[cell])`` is a cell's."""
    import torch
    from torch_robotics_tpu_torch.core import z_rot
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import (MultiRobot, RobotPanda,
                                                 RobotUR10)
    from torch_robotics_tpu_torch.tasks import PlanningTask
    from torch_robotics_tpu_torch.tasks.zoo_tasks import tiago_dual_robot
    make = {"panda": lambda: RobotPanda.create(device=device),
            "panda_net": lambda: RobotPanda.create(
                use_learned_self_collision=True, device=device),
            "ur10": lambda: RobotUR10(device=device),
            "tiago": lambda: tiago_dual_robot(device)}
    members = [make[k]() for k, _, _ in poses]
    if grasp:
        members[0] = grasp_robot(device, GRASP_MR_BOX)
    robot = MultiRobot.create(
        members,
        [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
          torch.tensor((tuple(x) + (0.0,))[:3])) for _, x, yaw in poses])
    if pairs:
        robot = MultiRobot.from_pairs(
            robot.robots, robot.base_rots, robot.base_trans,
            list(robot.self_pair_idxs) + [p for p, _ in pairs],
            np.concatenate([robot.self_margins.cpu().numpy(),
                            np.float32([m for _, m in pairs])]))
    return PlanningTask(env=EnvSpheres3D(device=device) if env is None
                        else env, robot=robot, obstacle_cutoff_margin=0.02)


def mr_problem(device, n_batch: int = MR_B, grasp: bool = False,
               task=None):
    """Config 4's draw -> (task, start, goal (n, 2 d), starts drawn); with
    ``grasp`` the task of ``mr_task(grasp=True)``, with ``task`` that
    task, its starts drawn free by its own check.

    Starts: random_coll_free_q with config 4's budget of B * 1024
    candidates from a seeded CPU generator.  About 0.09% of the joint box
    is free, so one budget finds ~0.92 B free starts (the JAX package's own
    draw finds 242 of 256); further rounds of the same budget from the same
    generator fill the batch, and the count of rounds is reported.  Goals:
    clip(q0 + 0.4 N(0, 1), q_min, q_max) from a numpy seed."""
    import torch
    task = mr_task(device, grasp=grasp) if task is None else task
    robot = task.robot
    gen = torch.Generator().manual_seed(SEED)
    found, first_round = [], None
    for _ in range(MR_MAX_ROUNDS):
        qs, n_valid = task.random_coll_free_q(
            gen, n_samples=n_batch, max_samples=n_batch * 1024)
        first_round = n_valid if first_round is None else first_round
        found.append(qs[:n_valid])
        if sum(len(f) for f in found) >= n_batch:
            break
    q0 = torch.cat(found)[:n_batch]
    check(len(q0) == n_batch, "only %d collision-free starts in %d rounds"
          % (len(q0), MR_MAX_ROUNDS))
    noise = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(n_batch, robot.q_dim)), dtype=torch.float32, device=device)
    qg = torch.maximum(torch.minimum(q0 + 0.4 * noise, robot.q_max),
                       robot.q_min)
    z = torch.zeros_like(q0)
    return (task, torch.cat([q0, z], -1), torch.cat([qg, z], -1),
            dict(first_round_free=first_round, rounds=len(found)))


def mr_first_q(start, goal):
    """The path's first q: the straight-line plans, h-major lanes (d, H B)."""
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    d = start.shape[1] // 2
    return (straight_line_trajs(start, goal, MR_H)[..., :d]
            .permute(2, 1, 0).reshape(d, -1).contiguous())


def phase_mr_terms(task, start, goal):
    """K5 vs its plain version at N = H B = 8192 (terms tolerances): the
    path's first q, random in-limit q, and random q at the tighter poses,
    then a two-member robot at N = 4096; a lane's bits the same at a
    ragged N = 1000 and, for the two-member robot, at 64 lanes a block; the
    active-row shares; timed on the first q (device_ms), with its work
    counted."""
    import torch
    from torch_robotics_tpu_torch.ops.terms_kernel import (
        mr_terms_launch_config, run_multirobot_terms_kernel)
    terms = task.collision_residuals.obstacle_terms_lanes
    q_main = mr_first_q(start, goal)
    N = q_main.shape[1]
    rng = np.random.default_rng(7)

    def in_limits(t, n=N):
        lo, hi = t.robot.q_min.cpu().numpy(), t.robot.q_max.cpu().numpy()
        u = rng.uniform(size=(lo.shape[0], n))
        return torch.as_tensor(lo[:, None] + u * (hi - lo)[:, None],
                               dtype=torch.float32, device="cuda")

    tight = mr_task("cuda", MR_TIGHT_POSES)
    two_arm = mr_task("cuda", MR_TWO_ARM_POSES)
    results, shares = {}, {}
    for name, t, q in (("config4_first_q", task, q_main),
                       ("config4_random_q", task, in_limits(task)),
                       ("tight_poses_random_q", tight, in_limits(tight)),
                       ("two_arm_random_q_N4096", two_arm,
                        in_limits(two_arm, 4096))):
        tt = t.collision_residuals.obstacle_terms_lanes
        hold_terms(name, tt.unscaled(q), tt.plain.unscaled(q), results)
        r = tt.plain.rows(q)[0]
        n_mutual = sum(len(v) for v in tt.plain.layout.groups.values())
        shares[name] = dict(rows=float((r > 0).float().mean()),
                            mutual_rows=float((r[-n_mutual:] > 0)
                                              .float().mean()))
    check(shares["tight_poses_random_q"]["mutual_rows"]
          > shares["config4_random_q"]["mutual_rows"],
          "the tight poses activate no more mutual rows")
    # a lane's bits: whatever the batch, and the lanes a block
    q_r = in_limits(task)
    full = terms.unscaled(q_r)
    ragged = terms.unscaled(q_r[:, :GN_RAGGED_N].contiguous())
    check(all(torch.equal(a, b[..., :GN_RAGGED_N])
              for a, b in zip(ragged, full)),
          "mr_terms: a ragged N changes the lanes' bits")
    t2 = two_arm.collision_residuals.obstacle_terms_lanes
    d2, ints2, floats2, _, launch2 = t2.params
    q2 = in_limits(two_arm, 4096)
    wide = mr_terms_launch_config(ints2.cpu().numpy(), floats2.numel(), 64)
    check(wide["lanes"] == 64, "mr_terms: 64 lanes a block do not fit")
    check(all(torch.equal(a, b) for a, b in zip(
        run_multirobot_terms_kernel(q2, ints2, floats2, d2, wide),
        t2.unscaled(q2))), "mr_terms: other bits at 64 lanes a block")
    # device time over a CUDA graph of calls (a call's host time exceeds
    # it), and a call's by CUDA events
    k_ms = device_ms(lambda: terms.unscaled(q_main), iters=20)
    call_ms = cuda_ms(lambda: terms.unscaled(q_main), iters=50)
    p_ms = cuda_ms(lambda: terms.plain.unscaled(q_main), iters=5, warmup=1)
    r_main = terms.plain.rows(q_main)[0]
    nbytes, ops = mr_terms_work(terms.plain.layout, q_main, r_main)
    emit("mr_terms", N=N, max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                                    for k, v in results.items()},
         active_row_share=shares, kernel_ms=k_ms, kernel_call_ms=call_ms,
         plain_ms=p_ms, launch=terms.params[4], bytes=nbytes, ops=ops,
         bound_ms=bound_ms(nbytes, ops)[0])
    return dict(max_abs_err=results["config4_first_q"][0], ms=k_ms,
                plain_ms=p_ms, work=(nbytes, ops))


def phase_mr_solve(task, start, goal):
    """K4 vs its plain version at (32, 40, 40, 256): a random
    well-conditioned system (1e-5 of max|x|; also at (H, m, B) = (6, 9, 37)
    and at (8, m, 100) for m = 17 and every padded width the kernel is
    built for) and the path's first GN system held to a float64 solve (no
    worse than twice the plain float32 error, +1e-5; the two float32
    errors differ by rounding luck, either way, on this ill-conditioned
    system).  Both again at a ragged B = 100: a lane's arithmetic does not
    depend on the batch or on the lanes a block, so each lane's solve is
    bit for bit the one at B = 256 (two lanes a block there, one at B =
    100; the GN system is also launched at one and at two lanes a block
    and must give the same bits), and the random system stays within 1e-5
    of plain.  Timed, with the dense solve."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        _COLS_WIDTHS, _launch_cols, cols_launch_config, solve_lanes_cols)
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    theta0 = straight_line_trajs(start, goal, MR_H)
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**MR_GP))
    m = D_l.shape[1]
    rand = random_system(MR_H, m, MR_B, seed=8)
    results = {}
    for name, (D, U, b) in (("gn", (D_l, U_l, b_l)), ("random", rand)):
        x_full = None
        for Bn in (MR_B, 100):
            Dn = D[..., :Bn].contiguous()
            bn = b[..., :Bn].contiguous()
            x_k = solve_lanes_cols(Dn, U, bn)
            x_p = solve_lanes_core(Dn, U, bn)
            x_64 = solve_lanes_core(Dn.double(), U.double(), bn.double())
            check(bool(torch.isfinite(x_k).all()), name + ": non-finite x")
            key = "%s_B%d" % (name, Bn)
            err, rel = max_errs([x_k], [x_p])
            rel_k64 = max_errs([x_k.double()], [x_64])[1]
            rel_p64 = max_errs([x_p.double()], [x_64])[1]
            lane_k64 = ((x_k.double() - x_64).abs().amax((0, 1))
                        / x_64.abs().max())
            lane_p64 = ((x_p.double() - x_64).abs().amax((0, 1))
                        / x_64.abs().max())
            if x_full is None:
                ok = (rel <= SOLVE_TOL_RANDOM if name == "random" else
                      rel_k64 <= SOLVE_GN_FACTOR * rel_p64
                      + SOLVE_TOL_RANDOM)
                x_full = x_k
            else:
                # a lane's solve does not depend on B or the lanes a block
                ok = (torch.equal(x_k, x_full[..., :Bn])
                      and (name != "random" or rel <= SOLVE_TOL_RANDOM))
            check(ok, "%s: column sweep disagrees (vs plain %.3g, vs float64 "
                  "%.3g, plain vs float64 %.3g of max|x|)"
                  % (key, rel, rel_k64, rel_p64))
            results[key] = dict(
                abs=err, rel_to_max=rel, kernel_vs_f64=rel_k64,
                plain_vs_f64=rel_p64,
                kernel_vs_f64_median_lane=float(lane_k64.median()),
                plain_vs_f64_median_lane=float(lane_p64.median()))
    small = random_system(6, 9, 37, seed=9)
    err, rel = max_errs([solve_lanes_cols(*small)], [solve_lanes_core(*small)])
    check(rel <= SOLVE_TOL_RANDOM, "random (6, 9, 37): column sweep vs plain "
          "%.3g of max|x|" % rel)
    results["random_H6_m9_B37"] = dict(abs=err, rel_to_max=rel)
    for mw in sorted({17, *_COLS_WIDTHS}):
        sysw = random_system(8, mw, 100, seed=30 + mw)
        err, rel = max_errs([solve_lanes_cols(*sysw)],
                            [solve_lanes_core(*sysw)])
        check(rel <= SOLVE_TOL_RANDOM, "random (8, %d, 100): column sweep "
              "vs plain %.3g of max|x|" % (mw, rel))
        results["random_H8_m%d_B100" % mw] = dict(abs=err, rel_to_max=rel)
    by_lanes = [_launch_cols(D_l, U_l, b_l, n) for n in (1, 2)]
    check(torch.equal(by_lanes[0], by_lanes[1]), "gn: the column sweep's x "
          "differs between one and two lanes a block")
    k_ms = cuda_ms(lambda: solve_lanes_cols(D_l, U_l, b_l), iters=20)
    p_ms = cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l), iters=2,
                   warmup=1)
    lib_ms = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=3, warmup=1)
    torch.cuda.empty_cache()
    work = cols_solve_work(MR_H, m, MR_B)
    emit("mr_solve", shape=[MR_H, m, m, MR_B], max_errs=results,
         launch=cols_launch_config(m, MR_B),
         kernel_ms=k_ms, plain_ms=p_ms, dense_solve_ms=lib_ms,
         bytes=work[0], ops=work[1], bound_ms=bound_ms(*work)[0])
    return dict(max_abs_err=results["gn_B%d" % MR_B]["abs"], ms=k_ms,
                plain_ms=p_ms, library_ms=lib_ms, work=work)


def mr_rollout(task, start, goal, n_steps):
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                                mpc_rollout)
    return mpc_rollout(task.collision_residuals, start, goal,
                       MPCParams(gpmp2=GPMP2Params(**MR_GP),
                                 iters_per_step=MR_ITERS), n_steps)


def phase_mr_mpc(task, start, goal, draw):
    """Config 4 at full size: B = 256, H = 32, 30 steps of 2 GN iterations
    through mpc_rollout; launches exactly 60 / 60 (K5 / K4), every output
    finite, CUDA-event timing, quality, a profile."""
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel, terms_kernel
    mr_rollout(task, start, goal, 1)                 # warm-up
    torch.cuda.synchronize()
    kernels = (terms_kernel.MR_KERNEL, btridiag_kernel.COLS_KERNEL,
               terms_kernel.KERNEL, btridiag_kernel.KERNEL)
    for k in kernels:
        k.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    xs, info = mr_rollout(task, start, goal, MR_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    expected = MR_STEPS * MR_ITERS
    check(launches == [expected, expected, 0, 0],
          "multi-robot launches %s (K5, K4, K1, K2), expected [%d, %d, 0, 0]"
          % (launches, expected, expected))
    final = info["final_state"]
    check(all(bool(torch.isfinite(t).all()) for t in
              (xs, info["dist_to_goal"], final.theta, final.x)),
          "multi-robot path produced non-finite outputs")
    d = start.shape[1] // 2
    n_free = int((~task.compute_collision(start)).sum())
    check(n_free == MR_B, "only %d of %d starts are collision-free"
          % (n_free, MR_B))
    ms = ev0.elapsed_time(ev1)
    executed = torch.cat([start[:, None], xs], dim=1)
    busy, dev_ms, top = profile_device(
        lambda: mr_rollout(task, start, goal, 2), 2)
    emit("mr_mpc", arms=3, q_dim=d, B=MR_B, H=MR_H, steps=MR_STEPS,
         iters_per_step=MR_ITERS,
         mutual_pairs=sum(len(v) for v in task.collision_residuals
                          .obstacle_terms_lanes.plain.layout.groups.values()),
         launches=dict(multirobot_terms=launches[0],
                       btridiag_cols=launches[1]),
         n_free_starts=n_free, start_draw=draw,
         ms_per_step=ms / MR_STEPS, host_wall_ms_per_step=(
             wall_s * 1e3 / MR_STEPS),
         solves_per_s=MR_B * MR_STEPS / (ms / 1e3),
         mean_final_goal_dist=float(info["dist_to_goal"][-1].mean()),
         fraction_free_executed=task.compute_fraction_free_trajs(
             executed[..., :d]),
         profiled_device_busy_share=busy, profiled_device_ms_per_step=dev_ms,
         top_device_ms_per_step=top)
    return launches


def phase_mr_cpu(start, goal):
    """One config-4 MPC step at B = 16 on the card and on the CPU, each held
    to a float64 CPU step (step_vs_f64), as phase cpu does."""
    from torch_robotics_tpu_torch.solve import GPMP2Params
    n = MR_CPU_B
    s_c, g_c = start[:n].contiguous(), goal[:n].contiguous()
    iters, chained = step_vs_f64(mr_task("cuda"), mr_task("cpu"),
                                 (s_c, g_c), (s_c.cpu(), g_c.cpu()),
                                 GPMP2Params(**MR_GP), MR_H, MR_ITERS,
                                 "multi-robot ")
    emit("mr_cpu", B=n, H=MR_H, iterations=iters, chained_step=chained)


# ----------------------------------------------------------------------
# config 2: the point-mass batch solve (benchmarks/run_all.py
# config_pointmass), GN factorization reuse and the point cloud
# ----------------------------------------------------------------------
def pm_problem(device, n_batch: int = PM_B):
    """Config 2 -> (task, params, start, goal, theta0 (n, 64, 4)): the point
    mass in EnvDense2D at cutoff 0.02, the scene's GPMP2 preset with
    num_samples = B and 150 iterations, theta0 sampled from the GP prior
    with a seeded CPU generator (the first n of the B samples)."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.envs import EnvDense2D
    from torch_robotics_tpu_torch.robots import RobotPointMass
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_init_trajs
    from torch_robotics_tpu_torch.tasks import PlanningTask
    env = EnvDense2D(device=device)
    robot = RobotPointMass.create(device=device)
    task = PlanningTask(env=env, robot=robot,
                        obstacle_cutoff_margin=PM_CUTOFF)
    params = dataclasses.replace(
        GPMP2Params.from_preset(env.get_gpmp2_params(robot)),
        num_samples=PM_B, opt_iters=PM_ITERS)
    start = torch.tensor(PM_START, device=device)
    goal = torch.tensor(PM_GOAL, device=device)
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(SEED), params,
                              start, goal)
    return task, params, start, goal, theta0[:n_batch].contiguous()


def all_kernels():
    from torch_robotics_tpu_torch.ops import (btridiag_kernel,
                                              gn_assembly_kernel,
                                              net_kernel, riccati_kernel,
                                              sdf_kernel, terms_kernel)
    return dict(terms=terms_kernel.KERNEL, cost=terms_kernel.COST_KERNEL,
                net_terms=net_kernel.NET_TERMS_KERNEL,
                net_cost=net_kernel.NET_COST_KERNEL,
                multirobot_terms=terms_kernel.MR_KERNEL,
                multirobot_cost=terms_kernel.MR_COST_KERNEL,
                btridiag_sweep=btridiag_kernel.SWEEP_KERNEL,
                btridiag_cr=btridiag_kernel.CR_KERNEL,
                gn_assembly=gn_assembly_kernel.KERNEL,
                btridiag_w=btridiag_kernel.KERNEL,
                btridiag_cols=btridiag_kernel.COLS_KERNEL,
                btridiag_cols_wide=btridiag_kernel.COLS_WIDE_KERNEL,
                btridiag_factor=btridiag_kernel.FACTOR_KERNEL,
                btridiag_subst=btridiag_kernel.SUBST_KERNEL,
                riccati=riccati_kernel.RICCATI_KERNEL,
                rollout=riccati_kernel.ROLLOUT_KERNEL,
                sphere_sdf=sdf_kernel.KERNEL)


def counted(fn):
    """Run fn with every launch counter at 0 -> (fn's result, the launches
    by kernel name, CUDA-event ms)."""
    import torch
    kernels = all_kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = fn()
    ev1.record()
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.items() if v.launches}
    return out, launches, ev0.elapsed_time(ev1)


def hold_solve(key, x_k, x_p, x_64, random: bool):
    """A sweep's x (or factor) on the card against its plain version: on a
    random well-conditioned system to SOLVE_TOL_RANDOM of max|ref|, on an
    ill-conditioned GN system no worse vs float64 than twice the plain
    float32 version (+1e-5), as phase solve holds K2."""
    import torch
    check(bool(torch.isfinite(x_k).all()), key + ": non-finite output")
    err, rel = max_errs([x_k], [x_p])
    rel_k64 = max_errs([x_k.double()], [x_64])[1]
    rel_p64 = max_errs([x_p.double()], [x_64])[1]
    ok = (rel <= SOLVE_TOL_RANDOM if random
          else rel_k64 <= SOLVE_GN_FACTOR * rel_p64 + SOLVE_TOL_RANDOM)
    check(ok, "%s: kernel vs plain %.3g, vs float64 %.3g, plain vs float64 "
          "%.3g of max|ref|" % (key, rel, rel_k64, rel_p64))
    return dict(abs=err, rel_to_max=rel, kernel_vs_f64=rel_k64,
                plain_vs_f64=rel_p64)


def phase_pm_solve(task, params, start, goal, theta0):
    """Config 2 at full size through gpmp2_solve; see the module doc."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.solve import gpmp2_solve
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    res_fn = task.collision_residuals
    b_l, D_l, U_l, _ = _lanes_gn_system(res_fn.obstacle_terms_lanes, theta0,
                                        start, goal, params)
    check(tuple(D_l.shape) == (params.n_support_points, 4, 4, PM_B),
          "config 2's GN system is %s" % (tuple(D_l.shape),))
    k2 = hold_solve("k2_m4_gn", solve_lanes_w(D_l, U_l, b_l),
                    solve_lanes_core(D_l, U_l, b_l),
                    solve_lanes_core(D_l.double(), U_l.double(),
                                     b_l.double()), random=False)
    gpmp2_solve(res_fn, theta0, start, goal,
                dataclasses.replace(params, opt_iters=2))     # warm-up
    res, launches, ms = counted(
        lambda: gpmp2_solve(res_fn, theta0, start, goal, params))
    check(launches == {"btridiag_w": PM_ITERS},
          "config 2 launches %s, expected %d of btridiag_w only"
          % (launches, PM_ITERS))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "config 2 produced non-finite results")
    check(tuple(res.trajs.shape) == tuple(theta0.shape)
          and tuple(res.cost_trace.shape) == (PM_ITERS, PM_B),
          "config 2 result shapes")
    busy, dev_ms, top = profile_device(lambda: gpmp2_solve(
        res_fn, theta0, start, goal,
        dataclasses.replace(params, opt_iters=5)), 5)
    free = task.compute_fraction_free_trajs(res.trajs)
    cpu = pm_vs_f64(params, theta0)
    k2_ms = cuda_ms(lambda: solve_lanes_w(D_l, U_l, b_l), iters=50)
    k2_plain_ms = cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l), iters=2,
                          warmup=1)
    k2_lib_ms = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=3, warmup=1)
    torch.cuda.empty_cache()
    H_ = params.n_support_points
    emit("pm_solve", B=PM_B, H=H_, m=4, iterations=PM_ITERS,
         launches=launches, solve_ms=ms, ms_per_iteration=ms / PM_ITERS,
         trajs_per_s=PM_B / (ms / 1e3), fraction_free=free,
         jax_package_fraction_free=PM_JAX_FREE["direct"],
         mean_final_cost=float(res.costs.mean()),
         cost_trace_mean_first_last=[float(res.cost_trace[0].mean()),
                                     float(res.cost_trace[-1].mean())],
         k2_m4_first_system=k2, k2_m4_ms=k2_ms, k2_m4_plain_ms=k2_plain_ms,
         k2_m4_dense_solve_ms=k2_lib_ms,
         k2_m4_bound_ms=bound_ms(*solve_work(H_, 4, PM_B))[0],
         vs_float64=cpu, profiled_device_busy_share=busy,
         profiled_device_ms_per_iteration=dev_ms,
         top_device_ms_per_iteration=top)
    return res


def pm_vs_f64(params, theta0):
    """PM_CPU_ITERS iterations on the first PM_CPU_B lanes, on the card and
    on the CPU, each held to a float64 CPU run (hold_to_f64): per iteration
    from the card's input, and chained from theta0."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import gpmp2_solve, gpmp2_step
    n = PM_CPU_B
    task_c, _, s_c, g_c, _ = pm_problem("cuda", n)
    task_h, _, s_h, g_h, _ = pm_problem("cpu", n)
    th = theta0[:n].contiguous()
    iters = []
    for it in range(PM_CPU_ITERS):
        th_c, cost_c = gpmp2_step(task_c.collision_residuals, th, s_c, g_c,
                                  params)
        th_in = th.cpu()
        th_h, cost_h = gpmp2_step(task_h.collision_residuals, th_in, s_h,
                                  g_h, params)
        th_64, _ = gpmp2_step(task_h.collision_residuals, th_in.double(),
                              s_h.double(), g_h.double(), params)
        check(bool(torch.isfinite(th_c).all()), "config 2 step non-finite")
        gaps = theta_gaps(th_c, th_h, th_64)
        hold_to_f64("config 2 iteration %d" % it, gaps)
        rel_cost = float(((cost_c.cpu() - cost_h).abs()
                          / cost_h.abs().clamp(min=1e-30)).max())
        iters.append(dict(gaps, cost_rel_err=rel_cost))
        th = th_c
    p = dataclasses.replace(params, opt_iters=PM_CPU_ITERS)
    th0 = theta0[:n].cpu()
    r_c = gpmp2_solve(task_c.collision_residuals, th0.cuda(), s_c, g_c, p)
    r_h = gpmp2_solve(task_h.collision_residuals, th0, s_h, g_h, p)
    r_64 = gpmp2_solve(task_h.collision_residuals, th0.double(),
                       s_h.double(), g_h.double(), p)
    chained = theta_gaps(r_c.trajs, r_h.trajs, r_64.trajs)
    hold_to_f64("config 2 chained", chained)
    return dict(B=n, iterations=iters, chained=chained)


def phase_pm_restarts(task, params, start, goal, theta0):
    """Config 2's restart policy; see the module doc."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import (gpmp2_solve,
                                                gpmp2_solve_restarts)
    res_fn = task.collision_residuals
    p_r = dataclasses.replace(params, opt_iters=PM_R_ITERS,
                              sigma_gp_init=PM_R_SIGMA)

    def free_fn(trajs):
        return ~task.trajs_collision_masks(trajs)[0]

    base = gpmp2_solve(res_fn, theta0, start, goal, p_r)
    res, launches, ms = counted(lambda: gpmp2_solve_restarts(
        res_fn, theta0, start, goal, p_r, free_fn,
        torch.Generator().manual_seed(42), restart_rounds=PM_R_ROUNDS,
        restart_iters=PM_R_RESTART))
    expected = PM_R_ITERS + PM_R_ROUNDS * PM_R_RESTART
    check(launches == {"btridiag_w": expected},
          "restart launches %s, expected %d of btridiag_w only"
          % (launches, expected))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "restarts produced non-finite results")
    free0 = free_fn(base.trajs)
    check(torch.equal(res.trajs[free0], base.trajs[free0]),
          "restarts changed lanes that were free after the main solve")
    f_main = float(free0.float().mean())
    f_res = float(free_fn(res.trajs).float().mean())
    check(f_res >= f_main, "restarts lowered the free fraction %.4f -> %.4f"
          % (f_main, f_res))
    emit("pm_restarts", B=PM_B, main_iters=PM_R_ITERS, rounds=PM_R_ROUNDS,
         restart_iters=PM_R_RESTART, launches=launches, wall_ms=ms,
         trajs_per_s=PM_B / (ms / 1e3), fraction_free_main=f_main,
         fraction_free_restarts=f_res,
         jax_package_fraction_free=PM_JAX_FREE,
         mean_final_cost=float(res.costs.mean()))


def ru_problem():
    """The reuse workload (gn_reuse_ab.py batch_solve_ab) -> (task, start,
    goal, theta0 (256, 32, 14)): starts and goals from random_coll_free_q
    with a budget of B * 64 each (one seeded CPU generator), theta0 one GP
    prior sample per problem."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import sample_gp_prior_trajs
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=EnvSpheres3D(device="cuda"),
                        robot=RobotPanda.create(device="cuda"),
                        obstacle_cutoff_margin=RU_CUTOFF)
    gen = torch.Generator().manual_seed(SEED + 1)
    qs, n_s = task.random_coll_free_q(gen, n_samples=RU_B,
                                      max_samples=RU_B * 64)
    qg, n_g = task.random_coll_free_q(gen, n_samples=RU_B,
                                      max_samples=RU_B * 64)
    check(n_s == RU_B and n_g == RU_B, "reuse workload: only %d / %d free "
          "starts / goals" % (n_s, n_g))
    start = torch.cat([qs, torch.zeros_like(qs)], -1)
    goal = torch.cat([qg, torch.zeros_like(qg)], -1)
    theta0 = sample_gp_prior_trajs(gen, start, goal, RU_H, RU_B,
                                   RU_GP["dt"], RU_GP["sigma_gp_init"])
    return task, start, goal, theta0


def phase_k9(pm, ru):
    """K9 vs its plain versions; see the module doc.  On the random system
    every output to SOLVE_TOL_RANDOM of max|ref|; on the two GN systems
    each output held to float64 (hold_solve): x and the factors to the
    float64 factor sweep, the substitution's x to the float64 substitution
    from the same (card) factors.  The substitution's x with a fresh b also
    against the float64 solve of the original system with that b (no worse
    than the plain substitution from the plain factors).  At a ragged B =
    100 every lane is bit for bit its full-batch value."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        _launch_subst, solve_lanes_factor, solve_lanes_subst, solve_lanes_w,
        subst_launch_config)
    from torch_robotics_tpu_torch.solve import GPMP2Params
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core, solve_lanes_factor_core, solve_lanes_subst_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    systems = {}
    task, params, start, goal, theta0 = pm
    systems["config2_gn_m4"] = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        params)[:3]
    ru_task, ru_start, ru_goal, ru_theta0 = ru
    systems["reuse_gn_m14"] = _lanes_gn_system(
        ru_task.collision_residuals.obstacle_terms_lanes, ru_theta0,
        ru_start, ru_goal, GPMP2Params(**RU_GP))[:3]
    D, U, b = random_system(RU_H, 14, RU_B, seed=10)
    systems["random_m14"] = (b, D, U)
    results = {}
    rng = np.random.default_rng(11)
    for name, (b, D, U) in systems.items():
        random = name.startswith("random")
        b2 = torch.as_tensor(rng.normal(size=b.shape) * float(b.abs().max()),
                             dtype=torch.float32, device="cuda")
        x, L, W = solve_lanes_factor(D, U, b)
        xp, Lp, Wp = solve_lanes_factor_core(D, U, b)
        ref64 = solve_lanes_factor_core(D.double(), U.double(), b.double())
        out = {k: hold_solve("%s_factor_%s" % (name, k), g, p, r, random)
               for k, g, p, r in zip(("x", "L", "W"), (x, L, W),
                                     (xp, Lp, Wp), ref64)}
        check(bool((torch.triu(L.permute(0, 3, 1, 2), 1) == 0).all()),
              name + ": L's strict upper triangle is not zero")
        xs = solve_lanes_subst(L, W, b2)
        out["subst_x"] = hold_solve(
            name + "_subst_x", xs, solve_lanes_subst_core(L, W, b2),
            solve_lanes_subst_core(L.double(), W.double(), b2.double()),
            random)
        out["subst_vs_original_system"] = hold_solve(
            name + "_subst_vs_original_system", xs,
            solve_lanes_subst_core(Lp, Wp, b2),
            solve_lanes_core(D.double(), U.double(), b2.double()), random)
        Bn = 100
        xr, Lr, Wr = solve_lanes_factor(D[..., :Bn].contiguous(), U,
                                        b[..., :Bn].contiguous())
        xsr = solve_lanes_subst(Lr, Wr, b2[..., :Bn].contiguous())
        check(all(torch.equal(g, f[..., :Bn]) for g, f in
                  ((xr, x), (Lr, L), (Wr, W), (xsr, xs))),
              name + ": a ragged B = 100 is not lane for lane the full solve")
        # the substitution through its ring of stages gives the bits of L
        # and W kept on chip (the launch the batch takes here)
        H_, m_, _, B_ = L.shape
        keep = subst_launch_config(m_, B_, H_)
        check(keep["keep_lw"], name + ": L and W are not kept on chip")
        ring = subst_launch_config(m_, B_, H_, keep_lw=False)
        check(torch.equal(_launch_subst(L, W, b2, torch.empty_like(b2), ring),
                          xs), name + ": the substitution's ring changes bits")
        results[name] = out
    b, D, U = systems["reuse_gn_m14"]
    x, L, W = solve_lanes_factor(D, U, b)
    f_ms = device_ms(lambda: solve_lanes_factor(D, U, b), iters=20)
    k2_ms = device_ms(lambda: solve_lanes_w(D, U, b), iters=20)
    s_ms = device_ms(lambda: solve_lanes_subst(L, W, b), iters=20)
    fp_ms = cuda_ms(lambda: solve_lanes_factor_core(D, U, b), iters=2,
                    warmup=1)
    sp_ms = cuda_ms(lambda: solve_lanes_subst_core(L, W, b), iters=2,
                    warmup=1)
    lib_f, lib_s = dense_cholesky_fns(D, U, b)
    lf_ms = cuda_ms(lib_f, iters=3, warmup=1)
    ls_ms = cuda_ms(lib_s, iters=3, warmup=1)
    torch.cuda.empty_cache()
    emit("k9", shapes={k: list(v[1].shape) for k, v in systems.items()},
         max_errs=results, factor_ms=f_ms, subst_ms=s_ms,
         k2_solve_ms=k2_ms, subst_launch=subst_launch_config(14, RU_B, RU_H),
         factor_plain_ms=fp_ms, subst_plain_ms=sp_ms,
         dense_cholesky_ms=lf_ms, dense_cholesky_solve_ms=ls_ms,
         factor_bound_ms=bound_ms(*factor_work(RU_H, 14, RU_B))[0],
         subst_bound_ms=bound_ms(*subst_work(RU_H, 14, RU_B))[0])
    err = results["reuse_gn_m14"]
    return (dict(max_abs_err=max(err[k]["abs"] for k in ("x", "L", "W")),
                 ms=f_ms, plain_ms=fp_ms, library_ms=lf_ms,
                 work=factor_work(RU_H, 14, RU_B)),
            dict(max_abs_err=err["subst_x"]["abs"], ms=s_ms, plain_ms=sp_ms,
                 library_ms=ls_ms, work=subst_work(RU_H, 14, RU_B)))


def dense_cholesky_fns(D, U, b):
    """The library yardsticks for K9 (never used by the port): one
    torch.linalg.cholesky of the dense (B, H m, H m) system (the factor
    sweep's L and W are its diagonal and sub-diagonal blocks), and one
    torch.cholesky_solve from that factor (the substitution sweep's
    function)."""
    import torch
    H_, m, _, B_ = D.shape
    A = torch.zeros((B_, H_ * m, H_ * m), dtype=D.dtype, device=D.device)
    for k in range(H_):
        sl = slice(k * m, (k + 1) * m)
        A[:, sl, sl] = D[k].permute(2, 0, 1)
        if k + 1 < H_:
            nx = slice((k + 1) * m, (k + 2) * m)
            A[:, sl, nx] = U[k, :, :, 0]
            A[:, nx, sl] = U[k, :, :, 0].T
    C = torch.linalg.cholesky(A)
    rhs = b.permute(2, 0, 1).reshape(B_, H_ * m, 1)
    return (lambda: torch.linalg.cholesky(A),
            lambda: torch.cholesky_solve(rhs, C))


def phase_reuse(ru):
    """GN factorization reuse on the reuse workload; see the module doc.
    Launch counts per k: K1 48; k = 1 K2 48; k = 2 K9 factor 24, subst 24;
    k = 4 factor 12, subst 36.  k = 1 is bit for bit the solve without the
    option."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_solve
    task, start, goal, theta0 = ru
    res_fn = task.collision_residuals
    out, totals = {}, {"btridiag_factor": 0, "btridiag_subst": 0}
    for k in RU_KS:
        p = GPMP2Params(**RU_GP, refactor_every=k)
        gpmp2_solve(res_fn, theta0, start, goal,
                    dataclasses.replace(p, opt_iters=4))      # warm-up
        res, launches, ms = counted(
            lambda: gpmp2_solve(res_fn, theta0, start, goal, p))
        n_fac = -(-RU_ITERS // k)
        expected = ({"terms": RU_ITERS, "btridiag_w": RU_ITERS} if k == 1
                    else {"terms": RU_ITERS, "btridiag_factor": n_fac,
                          "btridiag_subst": RU_ITERS - n_fac})
        check(launches == expected, "reuse k = %d launches %s, expected %s"
              % (k, launches, expected))
        check(all(bool(torch.isfinite(t).all()) for t in res),
              "reuse k = %d produced non-finite results" % k)
        if k == 1:
            plain = gpmp2_solve(res_fn, theta0, start, goal,
                                GPMP2Params(**RU_GP))
            check(all(torch.equal(a, b) for a, b in zip(res, plain)),
                  "refactor_every = 1 is not the solve without the option")
        for name in totals:
            totals[name] += launches.get(name, 0)
        busy, dev_ms, top = profile_device(
            lambda: gpmp2_solve(res_fn, theta0, start, goal, p), RU_ITERS)
        out["refactor_every_%d" % k] = dict(
            launches=launches, solve_ms=ms, ms_per_iteration=ms / RU_ITERS,
            fraction_free=task.compute_fraction_free_trajs(res.trajs),
            final_cost_mean=float(res.costs.mean()),
            profiled_device_busy_share=busy,
            profiled_device_ms_per_iteration=dev_ms,
            top_device_ms_per_iteration=top)
    emit("reuse", B=RU_B, H=RU_H, iterations=RU_ITERS, **out)
    return totals


def phase_point_cloud():
    """K10 through PointCloudSpheres; see the module doc."""
    import torch
    from torch_robotics_tpu_torch.geom import PointCloudSpheres
    from torch_robotics_tpu_torch.ops import sdf_kernel
    rng = np.random.default_rng(12)
    pts = torch.as_tensor(rng.uniform(-1, 1, size=(PC_M, 3)),
                          dtype=torch.float32, device="cuda")
    cloud = PointCloudSpheres.create(rng.uniform(-1, 1, size=(PC_S, 3)),
                                     radius=PC_RADIUS, device="cuda")
    sdf, launches, q_ms = counted(lambda: cloud.signed_distance(pts))
    check(launches == {"sphere_sdf": 1},
          "point-cloud query launches %s" % (launches,))
    c, r = cloud.centers, cloud.radii

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device="cuda")
    r_var = f32(rng.uniform(*PC_RADII, size=PC_S))
    c_odd = f32(rng.uniform(-1, 1, size=(PC_ODD_S, 3)))
    r_odd = f32(rng.uniform(*PC_RADII, size=PC_ODD_S))
    results, inside = {}, {}
    for name, got, (p, cc, rr) in (
            ("M%d_S%d" % (PC_M, PC_S), sdf, (pts, c, r)),
            ("radii_M%d_S%d" % (PC_M, PC_S), None, (pts, c, r_var)),
            ("radii_M%d_S%d" % (PC_M, PC_ODD_S), None, (pts, c_odd, r_odd)),
            ("M%d_S%d" % (PC_RAGGED_M, PC_S), None,
             (pts[:PC_RAGGED_M].contiguous(), c, r)),
            ("ragged_M1000_S129", None,
             (pts[:1000].contiguous(), c[:129].contiguous(),
              r[:129].contiguous()))):
        if got is None:
            got = sdf_kernel.sphere_sdf_kernel(p, cc, rr)
        ref = sdf_kernel.sphere_sdf_reference(p, cc, rr)
        check(bool(torch.isfinite(got).all()), name + ": non-finite SDF")
        err = float((got - ref).abs().max())
        check(err <= SDF_TOL, "%s: sphere SDF kernel vs plain %.3g"
              % (name, err))
        results[name] = err
        inside[name] = float((ref < 0).float().mean())
    small = PointCloudSpheres.create(c[:127].cpu().numpy(), radius=PC_RADIUS,
                                     device="cuda")
    n0 = sdf_kernel.KERNEL.launches
    out127 = small.signed_distance(pts[:1000])
    check(sdf_kernel.KERNEL.launches == n0 and bool(
        torch.isfinite(out127).all()), "S = 127 did not take the plain route")
    k_ms = device_ms(lambda: sdf_kernel.sphere_sdf_kernel(pts, c, r),
                     iters=20)
    var_ms = device_ms(lambda: sdf_kernel.sphere_sdf_kernel(pts, c, r_var),
                       iters=20)
    p_ms = cuda_ms(lambda: sdf_kernel.sphere_sdf_reference(pts, c, r),
                   iters=3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.cdist(pts, c).sub(r).amin(-1), iters=5)
    torch.cuda.empty_cache()
    emit("point_cloud", M=PC_M, S=PC_S, max_abs_err=results,
         share_inside=inside, launch=sdf_kernel.sdf_launch_config(PC_M, PC_S),
         query_ms=q_ms, kernel_ms=k_ms, kernel_ms_radii=var_ms,
         plain_ms=p_ms, cdist_ms=lib_ms,
         bound_ms=bound_ms(*sdf_work(PC_M, PC_S))[0])
    return dict(max_abs_err=results["M%d_S%d" % (PC_M, PC_S)], ms=k_ms,
                plain_ms=p_ms, library_ms=lib_ms, work=sdf_work(PC_M, PC_S),
                launches=launches["sphere_sdf"])


# ----------------------------------------------------------------------
# sGPMP (benchmarks/ilqr_sgpmp_bench.py "sgpmp"), its config-4 MultiRobot
# counterpart, and the unrouted solvers on the main path's inputs
# ----------------------------------------------------------------------
def sg_problem(start, goal, n_part: int, H_: int, dt: float, seed: int):
    """n_part GP-prior particles per problem (sample_gp_prior_trajs,
    sigma_gp_init 0.2, drawn on a seeded CUDA generator) -> (theta0 (B
    n_part, H, 2d), start, goal repeated per particle)."""
    import torch
    from torch_robotics_tpu_torch.solve import sample_gp_prior_trajs
    start_p = start.repeat_interleave(n_part, dim=0)
    goal_p = goal.repeat_interleave(n_part, dim=0)
    theta0 = sample_gp_prior_trajs(
        torch.Generator(device="cuda").manual_seed(seed), start_p, goal_p,
        H_, start_p.shape[0], dt, SG_INIT_SIGMA)
    return theta0, start_p, goal_p


def sg_free(task, trajs, n_part: int):
    """(B, n_part) bool: the particles' trajectories collision-free."""
    coll, _ = task.trajs_collision_masks(trajs)
    return (~coll).reshape(-1, n_part)


def phase_sgpmp(name, task, start, goal, n_part, params, kernel_key, seed):
    """One sGPMP path at full size (phases sgpmp and mr_sgpmp): a warm-up,
    then the timed solve with its normals drawn on a seeded CUDA generator;
    launches exactly 1 + 2 per iteration of ``kernel_key`` and nothing
    else; finite outputs of the expected shapes; the bench's metrics
    (ilqr_sgpmp_bench.py:215-233), ms per iteration, a profile."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import SGPMPParams, sgpmp_solve
    p = SGPMPParams(**params)
    theta0, start_p, goal_p = sg_problem(start, goal, n_part,
                                         p.n_support_points, p.dt, seed)
    res_fn = task.collision_residuals

    def solve(prm):
        return sgpmp_solve(res_fn, theta0, start_p, goal_p, prm,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1))

    solve(dataclasses.replace(p, opt_iters=2))                 # warm-up
    res, launches, ms = counted(lambda: solve(p))
    expected = {kernel_key: 2 * p.opt_iters + 1}
    check(launches == expected, "%s launches %s, expected %s"
          % (name, launches, expected))
    check(tuple(res.trajs.shape) == tuple(theta0.shape)
          and tuple(res.cost_trace.shape) == (p.opt_iters, theta0.shape[0]),
          name + " result shapes")
    check(all(bool(torch.isfinite(t).all()) for t in res),
          name + " produced non-finite results")
    free0, free = sg_free(task, theta0, n_part), sg_free(task, res.trajs,
                                                         n_part)
    busy, dev_ms, top = profile_device(
        lambda: solve(dataclasses.replace(p, opt_iters=5)), 5)
    B_ = start.shape[0]
    emit(name, batch=B_, particles=n_part, horizon=p.n_support_points,
         iters=p.opt_iters, samples_per_iter=p.num_samples,
         waypoints_scored_per_iter=p.num_samples * theta0.shape[0]
         * p.n_support_points, launches=launches, solve_ms=ms,
         ms_per_iteration=ms / p.opt_iters,
         particle_solves_per_s=B_ * n_part / (ms / 1e3),
         problems_per_s=B_ / (ms / 1e3),
         init_fraction_free_particles=float(free0.float().mean()),
         fraction_free_particles=float(free.float().mean()),
         init_fraction_problems_with_free=float(free0.any(1).float().mean()),
         fraction_problems_with_free=float(free.any(1).float().mean()),
         cost_trace_mean_first_last=[float(res.cost_trace[0].mean()),
                                     float(res.cost_trace[-1].mean())],
         profiled_device_busy_share=busy,
         profiled_device_ms_per_iteration=dev_ms,
         top_device_ms_per_iteration=top)
    return launches[kernel_key], theta0, start_p, goal_p


def phase_sgpmp_cpu(task_c, theta0, start_p, goal_p, task_h=None,
                    name="sgpmp_cpu", full_solve: bool = True,
                    params=SG_PARAMS, n_part: int = SG_PART):
    """At B = 32 problems (each's first of ``n_part`` particles; ``task_h``
    the task on the CPU, the iLQR path's when None; ``params`` the path's
    SGPMPParams): one iteration from the
    same normals on the card and on the CPU, each held to a float64 CPU
    iteration (hold_to_f64) for the candidate costs (relative to each
    lane's largest float64 cost) and the accepted means (relative to
    max|theta|); then the whole solve from the same normals, where the
    card's fraction of free lanes must be within 3 of 32 of the CPU
    float32 run's (unless ``full_solve`` is False).  The softmax weights
    and the acceptance amplify float32 rounding, so lanes are not compared
    after the whole solve."""
    import torch
    from torch_robotics_tpu_torch.solve import (SGPMPParams,
                                                sgpmp_solve_normals)
    from torch_robotics_tpu_torch.solve.gp_prior import \
        gp_bridge_sampler_matrix
    from torch_robotics_tpu_torch.solve.sampling import (_sgpmp_step,
                                                         _total_cost_fn)
    n = SG_CPU_B
    p = SGPMPParams(**params)
    th = theta0[::n_part][:n].contiguous()
    s_c = start_p[::n_part][:n].contiguous()
    g_c = goal_p[::n_part][:n].contiguous()
    task_h = ilqr_task("cpu") if task_h is None else task_h
    m = th.shape[-1]
    xi = torch.randn((p.opt_iters, p.num_samples, n, p.n_support_points * m),
                     generator=torch.Generator().manual_seed(SEED + 5))

    def one(task, t, s, g, dtype):
        dev = t.device
        fn = _total_cost_fn(task.collision_residuals, s.to(dtype),
                            g.to(dtype), p)
        M = gp_bridge_sampler_matrix(m // 2, p.n_support_points, p.dt,
                                     p.sigma_gp_sample, dtype=dtype,
                                     device=dev)
        t = t.to(dtype)
        theta, _, costs = _sgpmp_step(fn, t, fn(t), xi[0].to(dev, dtype), M,
                                      1.0, p)
        return theta, costs

    th_c, c_c = one(task_c, th, s_c, g_c, torch.float32)
    th_h, c_h = one(task_h, th.cpu(), s_c.cpu(), g_c.cpu(), torch.float32)
    th_64, c_64 = one(task_h, th.cpu(), s_c.cpu(), g_c.cpu(), torch.float64)
    check(bool(torch.isfinite(th_c).all() and torch.isfinite(c_c).all()),
          name + ": card iteration non-finite")
    gaps = theta_gaps(th_c, th_h, th_64)
    hold_to_f64(name + " iteration means", gaps)
    scale = c_64.abs().amax(0).clamp(min=1e-30)             # per lane
    cost_gaps = {}
    for who, c in (("card", c_c), ("cpu", c_h)):
        lane = ((c.cpu().double() - c_64).abs().amax(0) / scale)
        cost_gaps[who + "_vs_f64"] = float(lane.max())
        cost_gaps[who + "_vs_f64_median_lane"] = float(lane.median())
    hold_to_f64(name + " candidate costs", cost_gaps)
    if not full_solve:
        emit(name, B=n, one_iteration=dict(means=gaps,
                                           candidate_costs=cost_gaps))
        return

    full_c = sgpmp_solve_normals(task_c.collision_residuals, th, s_c, g_c, p,
                                 xi.cuda())
    full_h = sgpmp_solve_normals(task_h.collision_residuals, th.cpu(),
                                 s_c.cpu(), g_c.cpu(), p, xi)
    f_c = float(sg_free(task_c, full_c.trajs, 1).float().mean())
    f_h = float(sg_free(task_h, full_h.trajs, 1).float().mean())
    check(abs(f_c - f_h) <= SG_FREE_TOL + 1e-9,
          "%s fraction free: card %.3f, CPU %.3f" % (name, f_c, f_h))
    emit(name, B=n, iterations=p.opt_iters,
         one_iteration=dict(means=gaps, candidate_costs=cost_gaps),
         full_solve={"card_fraction_free": f_c, "cpu_fraction_free": f_h})


def phase_mr_cost(task, seen):
    """K8's MultiRobot branch vs its plain version (terms tolerances) on
    path 2's first candidate q (N = K B H = 131072) and proposal q (N = B
    H = 8192, the acceptance's), and on random in-limit q at the tighter poses, where
    mutual rows are active; a lane's bits the same at a ragged N and at 32
    lanes a block; timed at both path shapes, with K5 on the candidates."""
    import torch
    from torch_robotics_tpu_torch.ops.terms_kernel import \
        run_multirobot_cost_kernel
    rng = np.random.default_rng(13)
    tight = mr_task("cuda", MR_TIGHT_POSES)
    lo, hi = tight.robot.q_min.cpu().numpy(), tight.robot.q_max.cpu().numpy()
    q_tight = torch.as_tensor(
        lo[:, None] + rng.uniform(size=(lo.shape[0], 8192))
        * (hi - lo)[:, None], dtype=torch.float32, device="cuda")
    N = MR_SG_PARAMS["num_samples"] * MR_B * MR_H
    q_cand, q_acc = seen[N], seen[MR_B * MR_H]
    results, shares = {}, {}
    for name, t, q in (("path2_candidates_N%d" % N, task, q_cand),
                       ("path2_acceptance_N%d" % q_acc.shape[1], task, q_acc),
                       ("tight_poses_random_q_N8192", tight, q_tight)):
        cost = t.collision_residuals.collision_cost_lanes
        results[name] = hold_cost(name, cost(q), cost.plain(q))
        same_lane_bits(name, cost, run_multirobot_cost_kernel, q)
        plain = t.collision_residuals.obstacle_terms_lanes.plain
        r = plain.rows(q)[0]
        n_mut = sum(len(v) for v in plain.layout.groups.values())
        shares[name] = dict(rows=float((r > 0).float().mean()),
                            mutual_rows=float((r[-n_mut:] > 0).float().mean()))
    check(shares["tight_poses_random_q_N8192"]["mutual_rows"] > 0,
          "no mutual row is active at the tight poses")
    cost = task.collision_residuals.collision_cost_lanes
    terms = task.collision_residuals.obstacle_terms_lanes
    lay = terms.plain.layout
    n_rows = len(lay.obj_pos) * (2 if lay.df_obj_list else 1) + len(
        lay.pair_a)
    out = {}
    for key, q, iters in (("candidates", q_cand, 20), ("acceptance", q_acc,
                                                       50)):
        out[key] = dict(N=q.shape[1], ms=device_ms(lambda: cost(q), iters),
                        call_ms=cuda_ms(lambda: cost(q), iters=iters),
                        plain_ms=cuda_ms(lambda: cost.plain(q), iters=2,
                                         warmup=1),
                        work=mr_cost_work(lay, q.shape[1], n_rows))
    k5_ms = cuda_ms(lambda: terms.unscaled(q_cand), iters=20)
    torch.cuda.empty_cache()
    emit("mr_cost", max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                              for k, v in results.items()},
         active_row_share=shares,
         kernel_ms={k: v["ms"] for k, v in out.items()},
         call_ms={k: v["call_ms"] for k, v in out.items()},
         plain_ms={k: v["plain_ms"] for k, v in out.items()},
         bound_ms={k: bound_ms(*v["work"])[0] for k, v in out.items()},
         k5_terms_ms_same_q=k5_ms, launch=cost.params[3])
    out["candidates"]["max_abs_err"] = results["path2_candidates_N%d" % N][0]
    out["acceptance"]["max_abs_err"] = results[
        "path2_acceptance_N%d" % q_acc.shape[1]][0]
    return out


SOLVERS_ORDER = ("w", "sweep_trsm", "sweep_trsv", "cr")


def solvers_in_turns(D, U, b, order):
    """Device time of the solvers named in ``order`` (K2 "w", K3
    "sweep_trsm" / "sweep_trsv", K11 "cr") on one system, over a CUDA graph
    of 10 calls, in turns: the order, then reversed -> ({name: mean ms},
    {name: [its two times]})."""
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        solve_lanes_cr, solve_lanes_sweep, solve_lanes_w)
    fns = {"w": lambda: solve_lanes_w(D, U, b),
           "sweep_trsm": lambda: solve_lanes_sweep(D, U, b),
           "sweep_trsv": lambda: solve_lanes_sweep(D, U, b, bwd_trsv=True),
           "cr": lambda: solve_lanes_cr(D, U, b)}
    times = {k: [] for k in order}
    for k in tuple(order) + tuple(order[::-1]):
        times[k].append(device_ms(fns[k], iters=10))
    return {k: sum(v) / len(v) for k, v in times.items()}, times


def phase_solvers_wide(m: int):
    """K3 and K11 where the sweep's W stack is large (64, m, 4096) and K11
    at a long horizon (256, m, 1024), on random systems: each held to its
    plain version (SOLVE_TOL_RANDOM), K2 too, and timed in turns with K2
    (solvers_in_turns) -> {shape: {"ms": ..., "turns_ms": ...,
    "rel_to_plain": ...}}."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        solve_lanes_cr, solve_lanes_sweep, solve_lanes_w)
    from torch_robotics_tpu_torch.solve import solve_lanes_bcr
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    out = {}
    for H_, B_, order in ((H, 4 * B, SOLVERS_ORDER),
                          (4 * H, B, ("w", "cr"))):
        D, U, b = random_system(H_, m, B_, seed=16)
        x_p = solve_lanes_core(D, U, b)
        x_64 = solve_lanes_core(D.double(), U.double(), b.double())
        got = {"w": (solve_lanes_w(D, U, b), x_p),
               "cr": (solve_lanes_cr(D, U, b), solve_lanes_bcr(D, U, b))}
        if "sweep_trsm" in order:
            got["sweep_trsm"] = (solve_lanes_sweep(D, U, b), x_p)
            got["sweep_trsv"] = (solve_lanes_sweep(D, U, b, bwd_trsv=True),
                                 x_p)
        key = "H%d_B%d" % (H_, B_)
        errs = {k: hold_solve("%s_%s" % (k, key), x_k, x_r, x_64, True)
                for k, (x_k, x_r) in got.items()}
        del got, x_p, x_64
        ms, times = solvers_in_turns(D, U, b, order)
        out[key] = dict(shape=[H_, m, m, B_], ms=ms, turns_ms=times,
                        rel_to_plain={k: v["rel_to_max"]
                                      for k, v in errs.items()})
        del D, U, b
        torch.cuda.empty_cache()
    emit("solvers_wide", **out)
    return out


def phase_solvers(task, start, goal):
    """K3 (both tails) and K11 vs their plain versions, and K12: see the
    module doc.  Each solver on a random well-conditioned (64, 14, 1024)
    system to SOLVE_TOL_RANDOM of max|x| of its plain version, on the main
    path's first GN system held to float64 (hold_solve), and both at a
    ragged B = 100; K11 also at H = 48 (padded to 64).  K3's trsm tail
    recomputes W_k by K2's own operations: its x against K2's bit for bit
    on both systems (reported).  Timed on the GN system in turns K2, K3
    trsm, K3 trsv, K11, K11, K3 trsv, K3 trsm, K2 (each kernel's device
    time over a CUDA graph of calls, the mean of its two), with the plain
    versions and the dense torch.linalg.solve; then on random systems at
    (64, 14, 4096) (K2, K3, K11) and at H = 256 (K2, K11; m = 14, B =
    1024), each held to its plain version and timed in the same turns
    (``solvers_wide``).  K12 on the main path's first (r, Jr)
    (residuals_and_jacobian at N = H B) and at a ragged N, to the terms
    tolerances, timed with one torch.bmm on [r | Jr] as the library
    call.  The launch counts come from one call of each on the main
    path's inputs."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        solve_lanes_cr, solve_lanes_sweep, solve_lanes_w)
    from torch_robotics_tpu_torch.ops.gn_assembly_kernel import (
        gn_assembly, gn_assembly_reference)
    from torch_robotics_tpu_torch.solve import (GPMP2Params, solve_lanes_bcr,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    theta0 = straight_line_trajs(start, goal, H)
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        GPMP2Params(**GP_PARAMS))
    m = D_l.shape[1]
    solvers = {
        "sweep_trsm": (lambda D, U, b: solve_lanes_sweep(D, U, b),
                       solve_lanes_core),
        "sweep_trsv": (lambda D, U, b: solve_lanes_sweep(D, U, b,
                                                         bwd_trsv=True),
                       solve_lanes_core),
        "cr": (solve_lanes_cr, solve_lanes_bcr)}
    systems = {"gn": (D_l, U_l, b_l),
               "random": random_system(H, m, B, seed=14)}
    results = {k: {} for k in solvers}
    for sname, (D, U, b) in systems.items():
        for Bn in (B, 100):
            Dn = D[..., :Bn].contiguous()
            bn = b[..., :Bn].contiguous()
            x_64 = solve_lanes_core(Dn.double(), U.double(), bn.double())
            for kname, (fn, plain) in solvers.items():
                key = "%s_%s_B%d" % (kname, sname, Bn)
                results[kname]["%s_B%d" % (sname, Bn)] = hold_solve(
                    key, fn(Dn, U, bn), plain(Dn, U, bn), x_64,
                    random=sname == "random")
    D48, U48, b48 = random_system(48, m, B, seed=15)
    results["cr"]["random_H48"] = hold_solve(
        "cr_random_H48", solve_lanes_cr(D48, U48, b48),
        solve_lanes_bcr(D48, U48, b48),
        solve_lanes_core(D48.double(), U48.double(), b48.double()), True)

    # launches: one call of each on the main path's inputs
    launches = {}
    for kname, (fn, _) in solvers.items():
        launches[kname] = counted(lambda: fn(D_l, U_l, b_l))[1]
    d = start.shape[1] // 2
    q_main = theta0[..., :d].permute(1, 0, 2).reshape(-1, d).contiguous()
    r_b, J_b = task.collision_residuals.residuals_and_jacobian(q_main)
    r_gn = r_b.T.contiguous()                                 # (P, N)
    J_gn = J_b.permute(1, 2, 0).contiguous()                  # (P, d, N)
    gn_out, launches["gn_assembly"], _ = counted(lambda: gn_assembly(r_gn,
                                                                     J_gn))
    for kname, want in (("sweep_trsm", "btridiag_sweep"),
                        ("sweep_trsv", "btridiag_sweep"),
                        ("cr", "btridiag_cr"),
                        ("gn_assembly", "gn_assembly")):
        check(launches[kname] == {want: 1}, "%s launches %s"
              % (kname, launches[kname]))
    gn_errs = {}
    for name, (r_, J_) in (("main_N%d" % r_gn.shape[1], (r_gn, J_gn)),
                           ("ragged_N%d" % GN_RAGGED_N,
                            (r_gn[:, :GN_RAGGED_N].contiguous(),
                             J_gn[..., :GN_RAGGED_N].contiguous())),
                           ("odd_N%d" % GN_ODD_N,
                            (r_gn[:, :GN_ODD_N].contiguous(),
                             J_gn[..., :GN_ODD_N].contiguous()))):
        got = gn_out if name.startswith("main") else gn_assembly(r_, J_)
        ref = gn_assembly_reference(r_, J_)
        for g_, x_ in zip(got, ref):
            tol = TERMS_ATOL_REL * float(x_.abs().max()) + TERMS_RTOL * x_.abs()
            check(bool(torch.isfinite(g_).all()), name + ": non-finite")
            check(bool(((g_ - x_).abs() <= tol).all()),
                  "%s: GN assembly kernel disagrees with its plain version"
                  % name)
        gn_errs[name] = max_errs(got, ref)

    # K3's trsm tail is K2 bit for bit (the same L, y and W_k)
    same_bits = {name: bool(torch.equal(solve_lanes_sweep(D, U, b),
                                        solve_lanes_w(D, U, b)))
                 for name, (D, U, b) in systems.items()}

    # timing in turns on the GN system
    ms, times = solvers_in_turns(D_l, U_l, b_l, SOLVERS_ORDER)
    phase_solvers_wide(m)
    core_ms = cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l), iters=2,
                      warmup=1)
    bcr_ms = cuda_ms(lambda: solve_lanes_bcr(D_l, U_l, b_l), iters=2,
                     warmup=1)
    lib_ms = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=3, warmup=1)
    P_, d_, N_ = J_gn.shape
    X = torch.cat([r_gn[:, None], J_gn], 1).permute(2, 0, 1).contiguous()
    Xt = X.transpose(1, 2)
    # device time over a CUDA graph of calls, the inputs rotated over
    # GN_COPIES copies (126 MB at the main N) so that each call reads them
    # from device memory, not from the 50 MB L2
    gn_copies = [(r_gn.clone(), J_gn.clone()) for _ in range(GN_COPIES)]
    gn_turn = itertools.cycle(gn_copies)
    gn_ms = device_ms(lambda: gn_assembly(*next(gn_turn)),
                      iters=10 * GN_COPIES)
    del gn_copies, gn_turn
    gn_plain_ms = cuda_ms(lambda: gn_assembly_reference(r_gn, J_gn), iters=5,
                          warmup=1)
    gn_lib_ms = cuda_ms(lambda: torch.bmm(Xt, X), iters=20)
    torch.cuda.empty_cache()
    # the bound counts the work the solve needs (K2's); each algorithm's
    # own count, extra arithmetic included, is reported beside it
    works = {"sweep_trsm": solve_work(H, m, B),
             "sweep_trsv": solve_work(H, m, B), "cr": solve_work(H, m, B),
             "gn_assembly": gn_assembly_work(P_, d_, N_)}
    algo = {"sweep_trsm": sweep_work(H, m, B, False),
            "sweep_trsv": sweep_work(H, m, B, True), "cr": cr_work(H, m, B)}
    emit("solvers", shape=[H, m, m, B], max_errs=results,
         k3_trsm_bits_of_k2=same_bits, times_in_turns_ms=times,
         k2_ms=ms["w"],
         kernel_ms={k: ms[k] for k in solvers}, core_plain_ms=core_ms,
         bcr_plain_ms=bcr_ms, dense_solve_ms=lib_ms,
         bound_ms={k: bound_ms(*v)[0] for k, v in works.items()},
         algorithm_ops={k: v[1] for k, v in algo.items()},
         algorithm_bound_ms={k: bound_ms(*v)[0] for k, v in algo.items()},
         gn_assembly=dict(P=P_, d=d_, N=N_, max_errs={
             k: {"abs": v[0], "rel_to_max": v[1]} for k, v in gn_errs.items()},
             kernel_ms=gn_ms, plain_ms=gn_plain_ms, bmm_ms=gn_lib_ms))
    out = {}
    for kname in solvers:
        out[kname] = dict(max_abs_err=results[kname]["gn_B%d" % B]["abs"],
                          ms=ms[kname],
                          plain_ms=bcr_ms if kname == "cr" else core_ms,
                          library_ms=lib_ms, work=works[kname],
                          launches=sum(launches[kname].values()))
    out["gn_assembly"] = dict(
        max_abs_err=gn_errs["main_N%d" % N_][0], ms=gn_ms,
        plain_ms=gn_plain_ms, library_ms=gn_lib_ms,
        work=works["gn_assembly"], launches=1)
    return out


# ----------------------------------------------------------------------
# the learned self-collision Panda (benchmarks/net_terms_ab.py): phases
# net_terms, net_cost and net_main
# ----------------------------------------------------------------------
def net_bundled_arrays():
    """The bundled net's npz arrays (read in place)."""
    from torch_robotics_tpu_torch.utils.files import get_data_path
    with np.load(get_data_path() / "panda_self_collision_net.npz") as data:
        return {k: data[k] for k in data.files}


def net_spread_arrays(activation: str, q, widths=None, out_scale=1.0):
    """A net of the bundled widths (or ``widths``) with numpy-seeded He
    weights and small biases, the bundled mean_q and std_q, the bundled
    output scale times ``out_scale``, and scale_out[1] set from q (d, N) so
    that the hinge relu(0.001 - sd) is active on about half of q (the
    bundled net's hinge is almost never active: it saturates near sd =
    0.33)."""
    import torch
    from torch_robotics_tpu_torch.costs import SelfCollisionNet
    bundled = net_bundled_arrays()
    if widths is None:
        n_layers = sum(1 for k in bundled if k.startswith("W"))
        widths = [bundled["W0"].shape[0]] + [
            bundled["W%d" % i].shape[1] for i in range(n_layers)]
    rng = np.random.default_rng(NET_SEED)
    arrays = {"activation": activation, "mean_q": bundled["mean_q"],
              "std_q": bundled["std_q"],
              "scale_out": np.asarray([bundled["scale_out"][0] * out_scale,
                                       0.0], np.float32)}
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        arrays["W%d" % i] = (rng.normal(size=(n_in, n_out))
                             * np.sqrt(2.0 / n_in)).astype(np.float32)
        arrays["b%d" % i] = (0.1 * rng.normal(size=n_out)).astype(np.float32)
    raw = SelfCollisionNet.from_arrays(arrays, q.device).raw_distance(
        q.T.double())
    arrays["scale_out"][1] = -float(torch.median(raw)) - NET_CUTOFF
    return arrays


def net_robot(device, arrays=None):
    """The learned self-collision Panda: the bundled net, or ``arrays``."""
    import dataclasses

    from torch_robotics_tpu_torch.costs import SelfCollisionNet
    from torch_robotics_tpu_torch.robots import RobotPanda
    robot = RobotPanda.create(use_learned_self_collision=True, device=device)
    if arrays is None:
        return robot
    return dataclasses.replace(robot, self_collision_net=(
        SelfCollisionNet.from_arrays(arrays, device)))


def net_task(device, arrays=None, cutoff=0.03):
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.tasks import PlanningTask
    return PlanningTask(env=EnvSpheres3D(device=device),
                        robot=net_robot(device, arrays),
                        obstacle_cutoff_margin=cutoff)


def net_first_q(start, goal):
    """The main path's first q: the straight-line plans, h-major lanes."""
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    d = start.shape[1] // 2
    return (straight_line_trajs(start, goal, H)[..., :d]
            .permute(2, 1, 0).reshape(d, -1).contiguous())


def net_keep_lanes(name, net, q):
    """Lanes whose plain sd lies at least NET_EDGE from the cutoff (where
    two correct float32 orders cannot flip the hinge) -> (keep (N,), the
    count excluded, at most NET_EDGE_SHARE of the lanes)."""
    edge = (net.signed_distance(q.T) - NET_CUTOFF).abs() < NET_EDGE
    n_edge = int(edge.sum())
    check(n_edge <= NET_EDGE_SHARE * q.shape[1],
          "%s: %d lanes within %g of the hinge" % (name, n_edge, NET_EDGE))
    return ~edge, n_edge


def seq_fma_mm(x, W):
    """x (N, K) @ W (K, M) in float32, each output a sequential fmaf over k
    ascending from 0: the exact product and sum by TwoSum in float64,
    rounded to odd, then once to float32 (correctly, as 53 >= 24 + 2)."""
    import torch
    x64, W64 = x.double(), W.double()
    acc = torch.zeros((x.shape[0], W.shape[1]), device=x.device)
    for k in range(x.shape[1]):
        a = acc.double()
        p = x64[:, k:k + 1] * W64[k:k + 1]
        s = a + p
        v = s - a
        err = (a - (s - v)) + (p - v)
        inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
        s = torch.where(inexact_even, torch.nextafter(
            s, torch.copysign(torch.full_like(s, float("inf")), err)), s)
        acc = s.float()
    return acc


def net_plain_is_sequential(name, net, q):
    """The tf32x3 terms kernel takes its relu' decisions in the plain
    chain's order, on the premise that each hidden layer's product of the
    plain version on the card (x @ W, cuBLAS) is bit for bit a sequential
    FMA over k.  Check it on q (d, N), layer by layer as net_rows computes
    them -> the count of outputs checked."""
    import torch
    x = (q.T - net.mean_q.to(q)) / net.std_q.to(q)
    n = 0
    for li, (W, b) in enumerate(net._cast(q)[:-1]):
        y = x @ W
        n_off = int((y != seq_fma_mm(x, W)).sum())
        check(n_off == 0, "%s: the plain chain's layer %d on the card is not "
              "a sequential FMA over k on %d of %d outputs, which the tf32x3 "
              "terms kernel's relu' repair assumes" % (name, li, n_off,
                                                       y.numel()))
        n += y.numel()
        x = net._act(y + b)
    torch.cuda.empty_cache()
    return n


def hold_lanes(name, got, ref, keep):
    """Outputs (lanes last) held to their plain versions at the terms
    tolerance on the kept lanes -> (max abs error, relative to max|ref|)
    over those lanes."""
    import torch
    for g, r in zip(got, ref):
        tol = TERMS_ATOL_REL * float(r.abs().max()) + TERMS_RTOL * r.abs()
        check(bool(torch.isfinite(g).all()), name + ": non-finite output")
        check(bool(((g - r).abs() <= tol)[..., keep].all()),
              "%s: kernel disagrees with its plain version" % name)
    return max_errs([g[..., keep] for g in got], [r[..., keep] for r in ref])


def net_row_work(net, N: int, n_active: int, terms: bool):
    """(bytes, float ops) that the net row needs on N lanes, n_active of
    them active.  Bytes: q (d, N) and the weights read once; an active
    lane's g (d), Hqq (d, d) and cost read and written (the cost alone
    without terms).  Ops every lane needs: the forward pass (2 per
    multiply-add, a bias add per output, an activation per hidden output,
    2 per input for (q - mean) / std, 5 for the output scale and the
    hinge); an active lane also the backward pass (2 per multiply-add,
    one act' product per hidden output, 2 per input) and the row's adds
    (2 d to g, 2 d d to Hqq, 3 to cost)."""
    w = net.widths
    d = w[0]
    macs = sum(a * b for a, b in zip(w[:-1], w[1:]))
    hidden = sum(w[1:-1])
    n_params = macs + sum(w[1:]) + 2 * d + 2
    fwd = 2 * macs + sum(w[1:]) + hidden + 2 * d + 5
    per_active = 3 + (2 * macs + hidden + 2 * d + 2 * d + 2 * d * d
                      if terms else 0)
    out_floats = d + d * d + 1 if terms else 1
    return (4 * (d * N + n_params + 2 * out_floats * n_active),
            fwd * N + per_active * n_active)


def phase_net_terms():
    """K1 + the net row vs the plain terms on the main path's first q (N =
    64 * 1024) of the net Panda: the bundled net, a relu spread net and a
    tanh spread net; the row alone from zeros vs its plain contribution;
    timed with its plain version (the eager cuBLAS FP32 chain, also the
    row's library call) and with K1 on the same q."""
    import torch
    from torch_robotics_tpu_torch.ops.net_kernel import (add_net_terms,
                                                         net_terms_plain)
    from torch_robotics_tpu_torch.ops.terms_kernel import run_terms_kernel
    task_b, start, goal = bench_problem("cuda", B, robot=net_robot("cuda"))
    q = net_first_q(start, goal)
    d, N = q.shape
    out = {}
    for kind in ("bundled", "relu_spread", "tanh_spread"):
        task = task_b if kind == "bundled" else net_task(
            "cuda", net_spread_arrays(kind.split("_")[0], q))
        terms = task.collision_residuals.obstacle_terms_lanes
        row = terms.net_row
        net = row.net
        check(row.launch["route"] == "tf32x3", "%s: the bundled widths take "
              "route %s, not tf32x3" % (kind, row.launch["route"]))
        keep, n_edge = net_keep_lanes(kind, net, q)
        n_seq = net_plain_is_sequential(kind, net, q) \
            if net.activation == "relu" else 0
        err = hold_lanes(kind, terms.unscaled(q), terms.plain.unscaled(q),
                         keep)

        def zeros():
            return (torch.zeros((d, N), device="cuda"),
                    torch.zeros((d, d, N), device="cuda"),
                    torch.zeros((N,), device="cuda"))

        got, ref = zeros(), zeros()
        add_net_terms(row, q, *got)
        net_terms_plain(net, q, NET_CUTOFF, *ref)
        row_err = hold_lanes(kind + " row", got, ref, keep)
        n_active = int((ref[2] > 0).sum())
        if kind != "bundled":
            check(0.25 <= n_active / N <= 0.75, "%s: active share %g"
                  % (kind, n_active / N))
        bufs = zeros()
        ms = cuda_ms(lambda: add_net_terms(row, q, *bufs), iters=20)
        p_ms = cuda_ms(lambda: net_terms_plain(net, q, NET_CUTOFF, *bufs),
                       iters=3, warmup=1)
        d_, ints, floats, _, launch = terms.params
        out[kind] = dict(
            max_abs_err=row_err[0], ms=ms, plain_ms=p_ms, library_ms=p_ms,
            work=net_row_work(net, N, n_active, True),
            terms_max_errs={"abs": err[0], "rel_to_max": err[1]},
            row_max_errs={"abs": row_err[0], "rel_to_max": row_err[1]},
            active_share=n_active / N, excluded_lanes=n_edge,
            plain_sequential_fma_outputs=n_seq,
            k1_ms=device_ms(lambda: run_terms_kernel(q, ints, floats, d_,
                                                     launch), iters=20),
            route=row.launch["route"], tile_lanes=row.launch["lanes"],
            launch=row.launch)
    torch.cuda.empty_cache()
    emit("net_terms", N=N, **{k: dict(
        {key: v for key, v in r.items() if key not in ("max_abs_err",
                                                        "work")},
        bytes=r["work"][0], ops=r["work"][1],
        bound_ms=bound_ms(*r["work"])[0],
        bound_ms_tf32x3=bound_ms(*r["work"], PEAK_TF32X3_FLOPS)[0])
        for k, r in out.items()}, wide_nets=net_wide_rows(q))
    return out["relu_spread"]


def net_wide_rows(q_all):
    """Both net-row kernels of relu spread nets wider than the bundled one
    (NET_WIDE: the simt route at 16, 8 and 4 lanes a block, as
    ``net_launch_config`` picks them) on NET_WIDE_N lanes of q_all, from
    zeros, against their plain
    versions -> per net: its launch shape, errors, active share, lanes
    excluded at the hinge edge, and one timed call of each kernel."""
    import torch
    from torch_robotics_tpu_torch.costs import SelfCollisionNet
    from torch_robotics_tpu_torch.ops.net_kernel import (NetRowParams,
                                                         add_net_cost,
                                                         add_net_terms,
                                                         net_cost_plain,
                                                         net_terms_plain)
    d = q_all.shape[0]
    q = q_all[:, ::q_all.shape[1] // NET_WIDE_N][:, :NET_WIDE_N].contiguous()
    N = q.shape[1]
    out = {}
    for widths in NET_WIDE:
        name = "x".join(str(w) for w in widths)
        net = SelfCollisionNet.from_arrays(
            net_spread_arrays("relu", q, widths=widths), "cuda")
        row = NetRowParams(net, NET_CUTOFF, "cuda")
        keep, n_edge = net_keep_lanes(name, net, q)

        def zeros():
            return (torch.zeros((d, N), device="cuda"),
                    torch.zeros((d, d, N), device="cuda"),
                    torch.zeros((N,), device="cuda"))

        got, ref = zeros(), zeros()
        add_net_terms(row, q, *got)
        net_terms_plain(net, q, NET_CUTOFF, *ref)
        err = hold_lanes(name + " row", got, ref, keep)
        share = float((ref[2] > 0).float().mean())
        check(0.25 <= share <= 0.75, "%s: active share %g" % (name, share))
        c_got, c_ref = torch.zeros(N, device="cuda"), torch.zeros(
            N, device="cuda")
        add_net_cost(row, q, c_got)
        net_cost_plain(net, q, NET_CUTOFF, c_ref)
        c_err = hold_lanes(name + " cost row", [c_got], [c_ref], keep)
        bufs = zeros()
        out[name] = dict(
            launch=row.launch, N=N, active_share=share,
            excluded_lanes=n_edge,
            row_max_errs={"abs": err[0], "rel_to_max": err[1]},
            cost_row_max_errs={"abs": c_err[0], "rel_to_max": c_err[1]},
            terms_ms=cuda_ms(lambda: add_net_terms(row, q, *bufs), iters=3,
                             warmup=1),
            cost_ms=cuda_ms(lambda: add_net_cost(row, q, bufs[2]), iters=3,
                            warmup=1))
        del net, row
        torch.cuda.empty_cache()
    check(all(r["launch"]["route"] == "simt" for r in out.values())
          and sorted(r["launch"]["lanes"] for r in out.values()) == [4, 8, 16],
          "wide nets' routes and lanes a block %s"
          % [r["launch"] for r in out.values()])
    return out


def phase_net_cost(start, goal):
    """K8 + the value-only net row vs the plain cost on the sGPMP path's
    proposal q (N = B P H = 131,072) of the net Panda at the sGPMP bench's
    cutoff, with the bundled and a relu spread net (the tf32x3 route), and
    the row alone from zeros; timed at the candidates' N = 2,097,152 and
    at the proposal's 131,072 with its plain version;
    then the sGPMP path on the net Panda (the bench's 100 iterations):
    exactly 201 K8 and 201 net-cost launches and nothing else, finite
    results."""
    import torch
    from torch_robotics_tpu_torch.ops.net_kernel import (add_net_cost,
                                                         net_cost_plain)
    from torch_robotics_tpu_torch.solve import SGPMPParams, sgpmp_solve
    task_b = net_task("cuda", cutoff=0.06)
    problem = sg_problem(start, goal, SG_PART, IL_H, SG_PARAMS["dt"],
                         SEED + 2)
    seen = capture_cost_inputs(task_b, *problem, SG_PARAMS)
    N_cand = SG_PARAMS["num_samples"] * IL_B * SG_PART * IL_H
    q, q_cand = seen[IL_B * SG_PART * IL_H], seen[N_cand]
    out = {}
    for kind in ("bundled", "relu_spread"):
        task = task_b if kind == "bundled" else net_task(
            "cuda", net_spread_arrays("relu", q), cutoff=0.06)
        cost = task.collision_residuals.collision_cost_lanes
        row = task.collision_residuals.obstacle_terms_lanes.net_row
        net = row.net
        check(row.launch["route"] == "tf32x3", "%s: the bundled widths take "
              "route %s, not tf32x3" % (kind, row.launch["route"]))
        keep, n_edge = net_keep_lanes(kind, net, q)
        err = hold_lanes(kind, [cost(q)], [cost.plain(q)], keep)
        got = torch.zeros(q.shape[1], device="cuda")
        ref = torch.zeros(q.shape[1], device="cuda")
        add_net_cost(row, q, got)
        net_cost_plain(net, q, NET_CUTOFF, ref)
        row_err = hold_lanes(kind + " row", [got], [ref], keep)
        if kind != "bundled":
            share = float((ref > 0).float().mean())
            check(0.25 <= share <= 0.75, "%s: active share %g"
                  % (kind, share))
        buf = torch.zeros(N_cand, device="cuda")
        n_active = int((torch.relu(NET_CUTOFF - net.signed_distance(
            q_cand.T)) > 0).sum())
        n_act_q = int((ref > 0).sum())
        work_q = net_row_work(net, q.shape[1], n_act_q, False)
        out[kind] = dict(
            max_abs_err=row_err[0],
            ms=cuda_ms(lambda: add_net_cost(row, q_cand, buf), iters=10),
            plain_ms=cuda_ms(lambda: net_cost_plain(net, q_cand, NET_CUTOFF,
                                                    buf), iters=2, warmup=1),
            route=row.launch["route"], tile_lanes=row.launch["cost_lanes"],
            at_131072=dict(
                ms=cuda_ms(lambda: add_net_cost(row, q, got), iters=20),
                plain_ms=cuda_ms(lambda: net_cost_plain(net, q, NET_CUTOFF,
                                                        ref), iters=5),
                bound_ms=bound_ms(*work_q)[0],
                bound_ms_tf32x3=bound_ms(*work_q, PEAK_TF32X3_FLOPS)[0]),
            work=net_row_work(net, N_cand, n_active, False),
            cost_max_errs={"abs": err[0], "rel_to_max": err[1]},
            row_max_errs={"abs": row_err[0], "rel_to_max": row_err[1]},
            excluded_lanes=n_edge, active_share_candidates=n_active / N_cand,
            hook_ms=cuda_ms(lambda: cost(q_cand), iters=10))
        out[kind]["library_ms"] = out[kind]["plain_ms"]
    torch.cuda.empty_cache()

    p = SGPMPParams(**SG_PARAMS)
    res, launches, ms = counted(lambda: sgpmp_solve(
        task_b.collision_residuals, *problem, p,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 3)))
    expected = {"cost": 2 * p.opt_iters + 1, "net_cost": 2 * p.opt_iters + 1}
    check(launches == expected, "net sGPMP launches %s, expected %s"
          % (launches, expected))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "net sGPMP produced non-finite results")
    free0 = sg_free(task_b, problem[0], SG_PART)
    free = sg_free(task_b, res.trajs, SG_PART)
    emit("net_cost", N=q.shape[1], N_timed=N_cand, **{k: dict(
        {key: v for key, v in r.items() if key not in ("max_abs_err",
                                                        "work")},
        bytes=r["work"][0], ops=r["work"][1],
        bound_ms=bound_ms(*r["work"])[0],
        bound_ms_tf32x3=bound_ms(*r["work"], PEAK_TF32X3_FLOPS)[0])
        for k, r in out.items()},
        sgpmp=dict(launches=launches, ms_per_iteration=ms / p.opt_iters,
                   init_fraction_free_particles=float(free0.float().mean()),
                   fraction_free_particles=float(free.float().mean())))
    return dict(out["relu_spread"], launches=launches["net_cost"])


def chained_plain_terms_gap(task_c, task_h, card, cpu):
    """The chained MPC step on the card with the plain terms (eager ops, no
    terms or net-row kernel) against the float64 CPU step: its worst lane
    relative to max|theta|, the float32 spread beside the kernels'."""
    import types
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                                MPCState, mpc_step,
                                                straight_line_trajs)
    (start_c, goal_c), (start_h, goal_h) = card, cpu
    mp = MPCParams(gpmp2=GPMP2Params(**GP_PARAMS),
                   iters_per_step=ITERS_PER_STEP)
    th0 = straight_line_trajs(start_h, goal_h, H)
    plain = types.SimpleNamespace(obstacle_terms_lanes=(
        task_c.collision_residuals.obstacle_terms_lanes.plain))
    s_p, _ = mpc_step(plain, MPCState(th0.cuda(), start_c), goal_c, mp)
    s_64, _ = mpc_step(task_h.collision_residuals, MPCState(
        th0.double(), start_h.double()), goal_h.double(), mp)
    t64 = s_64.theta
    n = t64.shape[0]
    lane = ((s_p.theta.cpu().double() - t64).abs().reshape(n, -1).amax(1)
            / float(t64.abs().max()))
    return float(lane.max())


def phase_net_main():
    """The net Panda's main path (benchmarks/net_terms_ab.py): MPC at B =
    1024, H = 64, 2 GN iterations per step, 8 steps, once with the bundled
    net and once with a relu spread net: exactly 16 K1, 16 net-terms and 16
    K2 launches per run, finite outputs, step ms, solves/s, the final plans'
    fraction free, a profile with the net row's share; then the float64
    holds (net_f64) -> the spread run's net-terms launches."""
    import torch
    out, arrays = {}, None
    for kind in ("bundled", "relu_spread"):
        if kind != "bundled":
            arrays = net_spread_arrays("relu", net_first_q(start, goal))
        task, start, goal = bench_problem("cuda", B,
                                          robot=net_robot("cuda", arrays))
        route = task.collision_residuals.obstacle_terms_lanes.net_row.launch[
            "route"]
        check(route == "tf32x3", "%s net main path: route %s, not tf32x3"
              % (kind, route))
        run_mpc(task, start, goal, 1)                    # warm-up
        (state, costs, thetas), launches, ms = counted(
            lambda: run_mpc(task, start, goal, N_STEPS))
        expected = {k: N_STEPS * ITERS_PER_STEP
                    for k in ("terms", "net_terms", "btridiag_w")}
        check(launches == expected, "%s net main path launches %s, expected "
              "%s" % (kind, launches, expected))
        check(all(bool(torch.isfinite(t).all()) for t in thetas),
              kind + ": net main path produced non-finite theta")
        check(bool(torch.isfinite(costs).all()),
              kind + ": non-finite collision costs")
        step_ms = ms / N_STEPS
        busy, dev_ms, top = profile_device(
            lambda: run_mpc(task, start, goal, 2), 2, n_top=10)
        net_ms = sum(v for k, v in top.items()
                     if any(n in k for n in NET_ROW_KERNELS))
        out[kind] = dict(
            launches=launches, route=route, step_ms=step_ms,
            solves_per_s=B / (step_ms / 1e3),
            fraction_free=task.compute_fraction_free_trajs(state.theta),
            mean_collision_cost_last=float(costs[-1].mean()),
            profiled_device_busy_share=busy,
            profiled_device_ms_per_step=dev_ms,
            net_row_device_ms_per_step=net_ms,
            net_row_device_share=net_ms / dev_ms if dev_ms else None,
            top_device_ms_per_step=top)
    f64 = net_f64(arrays, net_first_q(start, goal))
    for kind, r in f64.items():
        out.setdefault(kind, {}).update(r)
    emit("net_main", B=B, H=H, steps=N_STEPS, **out)
    return out["relu_spread"]["launches"]["net_terms"]


def net_f64(spread, q_main):
    """The net Panda's MPC step at B = 32 on the card (K1 + the net row)
    and on the CPU, each held to a float64 CPU step as phase cpu holds the
    pair-field Panda, for the bundled net, the relu spread net ``spread``
    and a scaled spread net (output scale x NET_SCALED_OUT, shift from
    q_main: the same active lanes, smaller residuals), on the start / goal
    draws of NET_F64_SEEDS.

    Every GN iteration from the same input is held (worst and median lane)
    on every draw, the chained step's median lane too.  The chained step's
    worst lane is chaotic in float32 at lam = 1e8 (any change of op order
    moves which lanes blow up, and how far): it is held per draw only for
    the bundled net's first draw (as phase cpu), and on every net over all
    draws together: the card's worst lane (K1 + the net row) at most twice
    the worst lane of the other two float32 runs of the same steps, the
    CPU's and the plain terms' on the same card, + 1e-5 of max|theta| ->
    {kind: per-draw gaps and the pooled worst lanes}."""
    from torch_robotics_tpu_torch.solve import GPMP2Params
    nets = {"bundled": None, "relu_spread": spread,
            "relu_spread_scaled": net_spread_arrays(
                "relu", q_main, out_scale=NET_SCALED_OUT)}
    out = {}
    for kind, arrays in nets.items():
        draws = []
        for seed in NET_F64_SEEDS:
            task_c, s_c, g_c = bench_problem(
                "cuda", MPC_CPU_B, robot=net_robot("cuda", arrays), seed=seed)
            task_h, s_h, g_h = bench_problem(
                "cpu", MPC_CPU_B, robot=net_robot("cpu", arrays), seed=seed)
            label = "%s seed %d " % (kind, seed)
            iters, chained = step_vs_f64(
                task_c, task_h, (s_c, g_c), (s_h, g_h),
                GPMP2Params(**GP_PARAMS), H, ITERS_PER_STEP, label,
                chained_worst=kind == "bundled" and seed == NET_F64_SEEDS[0])
            chained["card_plain_terms_vs_f64"] = chained_plain_terms_gap(
                task_c, task_h, (s_c, g_c), (s_h, g_h))
            draws.append(dict(seed=seed, iterations=iters, chained=chained))
        worst = {who: max(r["chained"][key] for r in draws) for who, key in (
            ("card", "card_vs_f64"), ("cpu", "cpu_vs_f64"),
            ("card_plain_terms", "card_plain_terms_vs_f64"))}
        ref = max(worst["cpu"], worst["card_plain_terms"])
        check(worst["card"] <= 2.0 * ref + 1e-5,
              "%s: chained step's worst lane over draws %s: card %.3g, "
              "CPU float32 %.3g, plain terms on the card %.3g"
              % (kind, list(NET_F64_SEEDS), worst["card"], worst["cpu"],
                 worst["card_plain_terms"]))
        out[kind] = dict(f64_draws=draws, f64_chained_worst_lane=worst)
    return out


# ----------------------------------------------------------------------
# the grid scene (phases grid_main, grid_terms, grid_cost, mr_grid)
# ----------------------------------------------------------------------
def grid_env():
    """EnvSpheres3D on the card with its spheres precomputed into a
    GRID_CELL grid -> (env, precompute seconds)."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env = EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=GRID_CELL,
                       device="cuda")
    torch.cuda.synchronize()
    return env, time.perf_counter() - t0


def grid_start_goal(robot, n: int):
    """grid_sdf_bench.py's problem: every lane starts at the joint-range
    midpoint at rest, its goal clip(mid + 0.5) at rest."""
    import torch
    q0 = 0.5 * (robot.q_min + robot.q_max)
    qg = torch.maximum(torch.minimum(q0 + 0.5, robot.q_max), robot.q_min)
    z = torch.zeros_like(q0)
    return (torch.cat([q0, z]).expand(n, -1).contiguous(),
            torch.cat([qg, z]).expand(n, -1).contiguous())


def grid_chain(task, theta0, start, goal, n_steps):
    """n_steps chained gpmp2_step calls -> (theta, cost of the last)."""
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_step
    params = GPMP2Params(**GRID_GP)
    th, cost = theta0, None
    for _ in range(n_steps):
        th, cost = gpmp2_step(task.collision_residuals, th, start, goal,
                              params)
    return th, cost


def hold_grid(name, got, ref, near):
    """A grid-branch kernel's outputs (tuples of (..., N)) vs its plain
    version at the terms tolerance: a lane off it must be a lane with a
    point near a cell face (near (N,) bool), at most GRID_FACE_SHARE of the
    lanes -> dict(max abs error over the other lanes, relative to max|ref|,
    lanes off).  (A point that does not move with q, such as the Panda's
    base link at x = y = 0, may sit on a face in every lane: its cell is
    the same in both versions.)"""
    import torch
    off = torch.zeros_like(near)
    for g, r in zip(got, ref):
        check(bool(torch.isfinite(g).all()), name + ": non-finite output")
        tol = TERMS_ATOL_REL * float(r.abs().max()) + TERMS_RTOL * r.abs()
        off |= ((g - r).abs() > tol).reshape(-1, near.shape[0]).any(0)
    n_off = int(off.sum())
    check(not bool((off & ~near).any()),
          "%s: kernel and plain version disagree on a lane away from every "
          "cell face" % name)
    check(n_off <= GRID_FACE_SHARE * near.shape[0],
          "%s: %d lanes off at cell faces (at most %.1f%%)"
          % (name, n_off, 100 * GRID_FACE_SHARE))
    keep = ~off
    abs_err = max(float((g - r).reshape(-1, near.shape[0])[:, keep].abs()
                        .max()) for g, r in zip(got, ref))
    rel = max(float((g - r).reshape(-1, near.shape[0])[:, keep].abs().max())
              / (float(r.abs().max()) + 1e-30) for g, r in zip(got, ref))
    return dict(abs=abs_err, rel_to_max=rel, lanes_off=n_off)


def object_points_near_face(task, q):
    """(N,) bool: a lane of q (d, N) has an object collision point (the
    plain FK's) within GRID_FACE_TOL cell widths of a face of a grid."""
    from torch_robotics_tpu_torch.geom import GridSDF
    pts = task.robot.object_collision_points(
        task.robot.fk_map_collision(q.T))                   # (N, P, 3)
    near = None
    for g in task.df_obj_list:
        if isinstance(g, GridSDF):
            m = g.near_face(pts, GRID_FACE_TOL).any(-1)
            near = m if near is None else near | m
    return near


def grid_f64_hold(task_c, theta0, start, goal):
    """The card's first GRID_F64_B trajectories held to a float64 CPU run of
    those trajectories from the same input, beside a CPU float32 run, at
    phase cpu's rule (hold_to_f64): each of ITERS_PER_STEP GN steps from
    the card's input, and the chain of them from the straight lines.  The
    CPU task is the card's carried across (convert.py), so both read the
    same grid values (cast to float64 in the float64 run)."""
    from torch_robotics_tpu_torch.convert import task_arrays, task_from_numpy
    n = GRID_F64_B
    task_h = task_from_numpy(task_arrays(task_c), device="cpu")
    s_h, g_h = start[:n].cpu(), goal[:n].cpu()
    iters, theta = [], theta0
    for it in range(ITERS_PER_STEP):
        th_c, cost_c = grid_chain(task_c, theta, start, goal, 1)
        th_in = theta[:n].cpu()
        th_h, cost_h = grid_chain(task_h, th_in, s_h, g_h, 1)
        th_64, _ = grid_chain(task_h, th_in.double(), s_h.double(),
                              g_h.double(), 1)
        gaps = theta_gaps(th_c[:n], th_h, th_64)
        hold_to_f64("grid_main iteration %d" % it, gaps)
        iters.append(dict(gaps, cost_rel_err=float(
            ((cost_c[:n].cpu() - cost_h).abs()
             / cost_h.abs().clamp(min=1e-30)).max())))
        theta = th_c
    th0 = theta0[:n].cpu()
    chained = theta_gaps(
        grid_chain(task_c, theta0, start, goal, ITERS_PER_STEP)[0][:n],
        grid_chain(task_h, th0, s_h, g_h, ITERS_PER_STEP)[0],
        grid_chain(task_h, th0.double(), s_h.double(), g_h.double(),
                   ITERS_PER_STEP)[0])
    hold_to_f64("grid_main chained", chained)
    return dict(B=n, iterations=iters, chained=chained)


def phase_grid_main():
    """The grid scene's main path (grid_sdf_bench.py "panda_spheres3d"):
    the grid's precompute, then GRID_STEPS chained GN steps at B = 4096, H
    = 64 in the grid scene and in the analytic scene: exactly one K1 and
    one K2 launch a step and nothing else, finite outputs, ms per GN step
    (CUDA events), solves/s (two GN steps a solve, as the bench counts
    them), a profile; then the float64 hold (grid_f64_hold) -> (task,
    theta0, start, goal, env, K1 launches of the grid run)."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    from torch_robotics_tpu_torch.tasks import PlanningTask
    robot = RobotPanda.create(device="cuda")
    env, pre_s = grid_env()
    grid = env.grid_map_sdf_obj_fixed
    tasks = {"grid": PlanningTask(env=env, robot=robot,
                                  obstacle_cutoff_margin=GRID_CUTOFF),
             "analytic": PlanningTask(env=EnvSpheres3D(device="cuda"),
                                      robot=robot,
                                      obstacle_cutoff_margin=GRID_CUTOFF)}
    start, goal = grid_start_goal(robot, GRID_B)
    theta0 = straight_line_trajs(start, goal, GRID_H)
    out = {}
    for mode, task in tasks.items():
        grid_chain(task, theta0, start, goal, 1)               # warm-up
        (th, cost), launches, ms = counted(
            lambda: grid_chain(task, theta0, start, goal, GRID_STEPS))
        check(launches == {"terms": GRID_STEPS, "btridiag_w": GRID_STEPS},
              "grid_main %s launches %s, expected one K1 and one K2 a step"
              % (mode, launches))
        check(bool(torch.isfinite(th).all()) and bool(
            torch.isfinite(cost).all()), "grid_main %s: non-finite" % mode)
        busy, dev_ms, top = profile_device(
            lambda: grid_chain(task, theta0, start, goal, 2), 2)
        step_ms = ms / GRID_STEPS
        out[mode] = dict(ms_per_gn_step=step_ms,
                         solves_per_s=GRID_B / (step_ms / 1e3) / 2,
                         launches=launches,
                         mean_cost_last=float(cost.mean()),
                         profiled_device_busy_share=busy,
                         profiled_device_ms_per_step=dev_ms,
                         top_device_ms_per_step=top)
    hold = grid_f64_hold(tasks["grid"], theta0, start, goal)
    emit("grid_main", B=GRID_B, H=GRID_H, cell=GRID_CELL,
         grid_cells=grid.n_cells, grid_precompute_s=pre_s,
         grid_table_bytes=grid.table().numel() * 4, steps=GRID_STEPS,
         grid=out["grid"], analytic=out["analytic"],
         grid_vs_analytic=(out["grid"]["ms_per_gn_step"]
                           / out["analytic"]["ms_per_gn_step"]),
         f64_hold=hold)
    return (tasks["grid"], theta0, start, goal, env,
            out["grid"]["launches"]["terms"])


def phase_grid_terms(task, theta0):
    """K1's grid branch vs its plain version (hold_grid) on random q at N =
    GRID_TERMS_N and on grid_main's first q (N = H B = 262,144); timed on
    the latter, with its work counted."""
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    terms = task.collision_residuals.obstacle_terms_lanes
    check(terms.grid is not None, "the grid task's terms have no grid table")
    # the path's first q: the straight-line plans, h-major lanes
    q_main = theta0[..., :7].permute(2, 1, 0).reshape(7, -1).contiguous()
    results = {}
    for name, q in (("random_q_N%d" % GRID_TERMS_N,
                     random_q(task, GRID_TERMS_N, seed=21)),
                    ("main_q_N%d" % q_main.shape[1], q_main)):
        results[name] = hold_grid(name, terms.unscaled(q),
                                  terms.plain.unscaled(q),
                                  object_points_near_face(task, q))
    k_ms = device_ms(lambda: terms.unscaled(q_main), iters=20)
    p_ms = cuda_ms(lambda: terms.plain.unscaled(q_main), iters=3, warmup=1)
    r = terms.plain.rows(q_main)[0]
    work = terms_work(TermsLayout(task), q_main, r)
    q_rand = random_q(task, GRID_TERMS_N, seed=21)
    emit("grid_terms", max_errs=results, kernel_ms=k_ms, plain_ms=p_ms,
         call_ms=cuda_ms(lambda: terms.unscaled(q_main), iters=50),
         kernel_ms_random_q=device_ms(lambda: terms.unscaled(q_rand),
                                      iters=20),
         bytes=work[0], ops=work[1], bound_ms=bound_ms(*work)[0],
         active_row_share=float((r > 0).float().mean()))
    return dict(max_abs_err=results["main_q_N%d" % q_main.shape[1]]["abs"],
                ms=k_ms, plain_ms=p_ms, work=work)


def phase_grid_cost(env, start, goal):
    """K8's grid branch vs its plain version (hold_grid) on random q at the
    iLQR line search's N = 79,360 and on the sGPMP Panda's first
    candidates (N = 2,097,152) and proposal (N = 131,072) in the grid
    scene at the iLQR cutoff; a lane's bits the same at a ragged N and at
    32 lanes a block; timed at the three; then the sGPMP Panda in the grid scene (phase_sgpmp): exactly 201
    K8 launches -> (kernel numbers at 2,097,152, launches)."""
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.ops.terms_kernel import run_cost_kernel
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=env, robot=RobotPanda.create(device="cuda"),
                        obstacle_cutoff_margin=0.06)
    cost = task.collision_residuals.collision_cost_lanes
    N_ls = len(IL_ALPHAS) * IL_B * (IL_H - 1)
    N_sg = SG_PARAMS["num_samples"] * IL_B * SG_PART * IL_H
    seen_sg = capture_cost_inputs(task, *sg_problem(
        start, goal, SG_PART, IL_H, SG_PARAMS["dt"], SEED + 2), SG_PARAMS)
    q_sg, q_acc = seen_sg[N_sg], seen_sg[IL_B * SG_PART * IL_H]
    q_ls = random_q(task, N_ls, seed=22)
    results, out = {}, {}
    for name, q in (("random_q_N%d" % N_ls, q_ls),
                    ("sgpmp_candidates_N%d" % N_sg, q_sg),
                    ("sgpmp_acceptance_N%d" % q_acc.shape[1], q_acc)):
        results[name] = hold_grid(name, (cost(q),), (cost.plain(q),),
                                  object_points_near_face(task, q))
        same_lane_bits(name, cost, run_cost_kernel, q)
    lay = TermsLayout(task)
    n_rows = 2 * len(lay.obj_pos) + len(lay.pair_a)
    for key, q, iters in (("line_search", q_ls, 50), ("sgpmp", q_sg, 20),
                          ("acceptance", q_acc, 50)):
        out[key] = dict(N=q.shape[1], ms=device_ms(lambda: cost(q), iters),
                        call_ms=cuda_ms(lambda: cost(q), iters=iters),
                        plain_ms=cuda_ms(lambda: cost.plain(q), iters=2,
                                         warmup=1),
                        work=cost_work(lay, q.shape[1], n_rows))
    torch.cuda.empty_cache()
    emit("grid_cost", max_errs=results,
         kernel_ms={k: v["ms"] for k, v in out.items()},
         call_ms={k: v["call_ms"] for k, v in out.items()},
         plain_ms={k: v["plain_ms"] for k, v in out.items()},
         bound_ms={k: bound_ms(*v["work"])[0] for k, v in out.items()})
    launches = phase_sgpmp("grid_sgpmp", task, start, goal, SG_PART,
                           SG_PARAMS, "cost", SEED + 2)[0]
    out["sgpmp"]["max_abs_err"] = results["sgpmp_candidates_N%d" % N_sg][
        "abs"]
    return out["sgpmp"], launches


def phase_mr_grid(env, start, goal):
    """Config 4's task in the grid scene: K5 vs its plain version
    (hold_grid) on the path's first q (N = H B = 8192), K8's MultiRobot
    branch on the sGPMP path's first candidates (N = 131,072) with a
    lane's bits at a ragged N and at 32 lanes a block; both timed; then
    two MPC steps (exactly 4 K5 and 4 K4 launches) and the config-4 sGPMP
    (exactly 201 K8-MultiRobot launches), finite outputs -> (K5 numbers,
    K8-MultiRobot numbers)."""
    import torch
    from torch_robotics_tpu_torch.ops.terms_kernel import \
        run_multirobot_cost_kernel
    task = mr_task("cuda", env=env)
    res = task.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    lay = terms.plain.layout
    q_main = mr_first_q(start, goal)
    N_c = MR_SG_PARAMS["num_samples"] * MR_B * MR_H
    q_cand = capture_cost_inputs(task, *sg_problem(
        start, goal, 1, MR_H, MR_GP["dt"], SEED + 3), MR_SG_PARAMS)[N_c]
    errs = {"terms_first_q_N%d" % q_main.shape[1]: hold_grid(
        "mr_grid terms", terms.unscaled(q_main), terms.plain.unscaled(q_main),
        object_points_near_face(task, q_main)),
        "cost_candidates_N%d" % N_c: hold_grid(
        "mr_grid cost", (cost(q_cand),), (cost.plain(q_cand),),
        object_points_near_face(task, q_cand))}
    same_lane_bits("mr_grid cost", cost, run_multirobot_cost_kernel, q_cand)
    r = terms.plain.rows(q_main)[0]
    k5 = dict(ms=device_ms(lambda: terms.unscaled(q_main), iters=20),
              call_ms=cuda_ms(lambda: terms.unscaled(q_main), iters=50),
              plain_ms=cuda_ms(lambda: terms.plain.unscaled(q_main), iters=3,
                               warmup=1),
              work=mr_terms_work(lay, q_main, r),
              max_abs_err=errs["terms_first_q_N%d" % q_main.shape[1]]["abs"])
    n_rows = 2 * len(lay.obj_pos) + len(lay.pair_a)
    k8 = dict(ms=device_ms(lambda: cost(q_cand), 20),
              call_ms=cuda_ms(lambda: cost(q_cand), iters=20),
              plain_ms=cuda_ms(lambda: cost.plain(q_cand), iters=2,
                               warmup=1),
              work=mr_cost_work(lay, N_c, n_rows),
              max_abs_err=errs["cost_candidates_N%d" % N_c]["abs"])
    torch.cuda.empty_cache()
    mr_rollout(task, start, goal, 1)                 # warm-up
    (xs, info), launches, ms = counted(lambda: mr_rollout(task, start, goal,
                                                          2))
    check(launches == {"multirobot_terms": 2 * MR_ITERS,
                       "btridiag_cols": 2 * MR_ITERS},
          "mr_grid MPC launches %s, expected %d K5 and K4" % (
              launches, 2 * MR_ITERS))
    check(bool(torch.isfinite(xs).all()) and bool(torch.isfinite(
        info["final_state"].theta).all()), "mr_grid MPC: non-finite")
    k5["launches"] = launches["multirobot_terms"]
    emit("mr_grid", max_errs=errs, k5_ms=k5["ms"], k5_call_ms=k5["call_ms"],
         k5_plain_ms=k5["plain_ms"],
         k5_bound_ms=bound_ms(*k5["work"])[0], k8_ms=k8["ms"],
         k8_call_ms=k8["call_ms"], k8_plain_ms=k8["plain_ms"],
         k8_bound_ms=bound_ms(*k8["work"])[0],
         mpc_launches=launches, mpc_ms_per_step=ms / 2)
    k8["launches"] = phase_sgpmp("mr_grid_sgpmp", task, start, goal, 1,
                                 MR_SG_PARAMS, "multirobot_cost",
                                 SEED + 3)[0]
    return k5, k8


# ----------------------------------------------------------------------
# the grasped-object Panda (phases grasp_terms, grasp_main, grasp_cost,
# mr_grasp)
# ----------------------------------------------------------------------
def grasp_robot(device, size=None):
    """The Panda holding GraspedObjectPandaBox (its default size, or
    ``size``)."""
    from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
    from torch_robotics_tpu_torch.robots import RobotPanda
    box = (GraspedObjectPandaBox(device=device) if size is None
           else GraspedObjectPandaBox(size=size, device=device))
    return RobotPanda.create(grasped_object=box, device=device)


def grasp_task(device, env=None, cutoff=GRASP_CUTOFF):
    """The grasped Panda in EnvSpheres3D (or ``env``) at ``cutoff``."""
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.tasks import PlanningTask
    return PlanningTask(env=EnvSpheres3D(device=device) if env is None
                        else env, robot=grasp_robot(device),
                        obstacle_cutoff_margin=cutoff)


def uniform_q(task, N: int, seed: int):
    """q (d, N) uniform over the joint limits (pallas_terms_ab.py's draw),
    from a numpy seed."""
    import torch
    lo, hi = task.robot.model.q_lower, task.robot.model.q_upper
    u = np.random.default_rng(seed).uniform(size=(lo.shape[0], N))
    return torch.as_tensor(lo[:, None] + u * (hi - lo)[:, None],
                           dtype=torch.float32, device=task.device)


def chunked(fn, q, n: int = 1 << 18):
    """fn over q (d, N) in chunks of n lanes, concatenated: the plain cost
    of the grasped robot at N = 2,097,152 in one call would hold its
    (104, 7, 7, N) Hessian products."""
    import torch
    return torch.cat([fn(q[:, i:i + n].contiguous())
                      for i in range(0, q.shape[1], n)])


def phase_grasp_terms(genv):
    """K1's grasped branch vs its plain version at the terms tolerance on
    the grasped Panda (pallas_terms_ab.py's workload, cutoff 0.03, N = H B
    = 65,536): q uniform over the joint limits, the grasped main path's
    first q, a ragged N (its lanes' bits those of the full launch), and in
    grid_main's 0.01 m grid scene (hold_grid); timed on both q (device
    time over a CUDA graph of calls, a call's by CUDA events) beside the
    pair-field K1 on the same q, the bound from the active rows."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task, start, goal = bench_problem("cuda", B, robot=grasp_robot("cuda"))
    terms = task.collision_residuals.obstacle_terms_lanes
    N = H * B
    d = start.shape[1] // 2
    q_main = (straight_line_trajs(start, goal, H)[..., :d]
              .permute(2, 1, 0).reshape(d, N).contiguous())
    q_uni = uniform_q(task, N, seed=31)
    results = {}
    hold_terms("uniform_q_N%d" % N, terms.unscaled(q_uni),
               terms.plain.unscaled(q_uni), results)
    hold_terms("main_q_N%d" % N, terms.unscaled(q_main),
               terms.plain.unscaled(q_main), results)
    q_rag = q_uni[:, :GRASP_RAGGED_N].contiguous()
    rag = terms.unscaled(q_rag)
    hold_terms("ragged_N%d" % GRASP_RAGGED_N, rag, terms.plain.unscaled(q_rag),
               results)
    full = terms.unscaled(q_uni)
    check(all(torch.equal(a, b[..., :GRASP_RAGGED_N])
              for a, b in zip(rag, full)),
          "grasp_terms: a lane's bits change with the batch")
    gtask = grasp_task("cuda", env=genv)
    gterms = gtask.collision_residuals.obstacle_terms_lanes
    check(gterms.grid is not None, "the grasped grid task has no grid table")
    results["grid_uniform_q_N%d" % N] = hold_grid(
        "grasp_terms grid", gterms.unscaled(q_uni),
        gterms.plain.unscaled(q_uni), object_points_near_face(gtask, q_uni))
    pair = PlanningTask(env=EnvSpheres3D(device="cuda"),
                        robot=RobotPanda.create(device="cuda"),
                        obstacle_cutoff_margin=GRASP_CUTOFF)
    pterms = pair.collision_residuals.obstacle_terms_lanes
    lay = TermsLayout(task)
    out = {}
    for key, q in (("main_q", q_main), ("uniform_q", q_uni)):
        r = terms.plain.rows(q)[0]
        out[key] = dict(
            ms=device_ms(lambda: terms.unscaled(q), iters=20),
            call_ms=cuda_ms(lambda: terms.unscaled(q), iters=50),
            pair_field_ms=device_ms(lambda: pterms.unscaled(q), iters=20),
            plain_ms=cuda_ms(lambda: terms.plain.unscaled(q), iters=3,
                             warmup=1),
            work=terms_work(lay, q, r),
            active_row_share=float((r > 0).float().mean()))
    grid_ms = device_ms(lambda: gterms.unscaled(q_uni), iters=20)
    torch.cuda.empty_cache()
    emit("grasp_terms", N=N, points=len(lay.point_links),
         rows=len(lay.row_joints()[0]),
         max_errs={k: (v if isinstance(v, dict)
                       else {"abs": v[0], "rel_to_max": v[1]})
                   for k, v in results.items()},
         kernel_ms={k: v["ms"] for k, v in out.items()},
         call_ms={k: v["call_ms"] for k, v in out.items()},
         pair_field_kernel_ms={k: v["pair_field_ms"] for k, v in out.items()},
         plain_ms={k: v["plain_ms"] for k, v in out.items()},
         bound_ms={k: bound_ms(*v["work"])[0] for k, v in out.items()},
         bound_by={k: bound_ms(*v["work"])[1] for k, v in out.items()},
         active_row_share={k: v["active_row_share"] for k, v in out.items()},
         grid_kernel_ms_uniform_q=grid_ms)
    res = out["main_q"]
    return dict(max_abs_err=results["main_q_N%d" % N][0], ms=res["ms"],
                plain_ms=res["plain_ms"], work=res["work"])


def phase_grasp_main():
    """The main path with the grasped Panda: bench_problem's draw, B =
    1024, H = 64, 2 GN iterations a step, 8 steps; exactly 16 K1 and 16 K2
    launches and nothing else, finite outputs, solves/s, step ms, a
    profile; then one step at B = 32 on the card and on the CPU held to a
    float64 CPU step (step_vs_f64, phase cpu's rule) -> K1 launches."""
    import torch
    task, start, goal = bench_problem("cuda", B, robot=grasp_robot("cuda"))
    run_mpc(task, start, goal, 1)                    # warm-up
    (state, costs, thetas), launches, ms = counted(
        lambda: run_mpc(task, start, goal, N_STEPS))
    expected = N_STEPS * ITERS_PER_STEP
    check(launches == {"terms": expected, "btridiag_w": expected},
          "grasp_main launches %s, expected %d K1 and K2" % (launches,
                                                             expected))
    check(all(bool(torch.isfinite(t).all()) for t in thetas)
          and bool(torch.isfinite(costs).all()),
          "grasp_main produced non-finite outputs")
    step_ms = ms / N_STEPS
    busy, dev_ms, top = profile_device(
        lambda: run_mpc(task, start, goal, 2), 2)
    from torch_robotics_tpu_torch.solve import GPMP2Params
    n = MPC_CPU_B
    task_c, start_c, goal_c = bench_problem("cuda", n,
                                            robot=grasp_robot("cuda"))
    task_h, start_h, goal_h = bench_problem("cpu", n, robot=grasp_robot("cpu"))
    iters, chained = step_vs_f64(task_c, task_h, (start_c, goal_c),
                                 (start_h, goal_h), GPMP2Params(**GP_PARAMS),
                                 H, ITERS_PER_STEP, "grasp_main ")
    emit("grasp_main", B=B, H=H, steps=N_STEPS, launches=launches,
         step_ms=step_ms, solves_per_s=B / (step_ms / 1e3),
         fraction_free=task.compute_fraction_free_trajs(state.theta),
         mean_collision_cost_last=float(costs[-1].mean()),
         profiled_device_busy_share=busy, profiled_device_ms_per_step=dev_ms,
         top_device_ms_per_step=top,
         f64_hold=dict(B=n, iterations=iters, chained_step=chained))
    return launches["terms"]


def phase_grasp_cost(start, goal):
    """K8's grasped branch vs its plain version (terms tolerance) on the
    grasped Panda at the iLQR cutoff 0.06: random q at the line search's N
    = 79,360 and the sGPMP path's first candidates (N = 2,097,152; the
    plain cost in chunks) and proposal (N = 131,072), a lane's bits the
    same at a ragged N and at 32 lanes a block (same_lane_bits); timed at
    the three; then sGPMP at phase
    sgpmp's shape on the grasped Panda: exactly 201 K8 launches, the
    fraction free before and after -> (kernel numbers at 2,097,152,
    launches)."""
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.ops.terms_kernel import run_cost_kernel
    task = grasp_task("cuda", cutoff=0.06)
    cost = task.collision_residuals.collision_cost_lanes
    N_ls = len(IL_ALPHAS) * IL_B * (IL_H - 1)
    N_sg = SG_PARAMS["num_samples"] * IL_B * SG_PART * IL_H
    seen_sg = capture_cost_inputs(task, *sg_problem(
        start, goal, SG_PART, IL_H, SG_PARAMS["dt"], SEED + 2), SG_PARAMS)
    q_sg, q_acc = seen_sg[N_sg], seen_sg[IL_B * SG_PART * IL_H]
    q_ls = random_q(task, N_ls, seed=32)
    results, out = {}, {}
    lay = TermsLayout(task)
    n_rows = 2 * len(lay.obj_pos) + len(lay.pair_a)
    for key, name, q, iters in (
            ("line_search", "random_q_N%d" % N_ls, q_ls, 50),
            ("sgpmp", "sgpmp_candidates_N%d" % N_sg, q_sg, 20),
            ("acceptance", "sgpmp_acceptance_N%d" % q_acc.shape[1], q_acc,
             50)):
        results[name] = hold_cost(name, cost(q), chunked(cost.plain, q))
        same_lane_bits(name, cost, run_cost_kernel, q)
        out[key] = dict(N=q.shape[1], ms=device_ms(lambda: cost(q), iters),
                        call_ms=cuda_ms(lambda: cost(q), iters=iters),
                        plain_ms=cuda_ms(lambda: chunked(cost.plain, q),
                                         iters=1, warmup=1),
                        work=cost_work(lay, q.shape[1], n_rows),
                        max_abs_err=results[name][0])
    torch.cuda.empty_cache()
    emit("grasp_cost", rows=n_rows, launch=cost.params[3],
         max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                   for k, v in results.items()},
         kernel_ms={k: v["ms"] for k, v in out.items()},
         call_ms={k: v["call_ms"] for k, v in out.items()},
         plain_ms={k: v["plain_ms"] for k, v in out.items()},
         bound_ms={k: bound_ms(*v["work"])[0] for k, v in out.items()},
         bound_by={k: bound_ms(*v["work"])[1] for k, v in out.items()})
    launches = phase_sgpmp("grasp_sgpmp", task, start, goal, SG_PART,
                           SG_PARAMS, "cost", SEED + 2)[0]
    return out["sgpmp"], launches


def phase_mr_grasp():
    """Config 4 with its first Panda holding a GRASP_MR_BOX box, the
    starts drawn free by its own check (mr_problem): K5 vs its plain
    version on the path's first q (N = 8192), two MPC steps (exactly 4 K5
    and 4 K4 launches, finite), K8's MultiRobot branch vs plain on the
    sGPMP candidates (N = 131,072) with same_lane_bits, timed; then the
    config-4 sGPMP on it: exactly 201 K8-MultiRobot launches -> (K5
    numbers, K8-MultiRobot numbers)."""
    import torch
    from torch_robotics_tpu_torch.ops.terms_kernel import \
        run_multirobot_cost_kernel
    task, start, goal, draw = mr_problem("cuda", grasp=True)
    res = task.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    lay = terms.plain.layout
    n_free = int((~task.compute_collision(start)).sum())
    check(n_free == MR_B, "mr_grasp: only %d of %d starts are free"
          % (n_free, MR_B))
    q_main = mr_first_q(start, goal)
    N_c = MR_SG_PARAMS["num_samples"] * MR_B * MR_H
    q_cand = capture_cost_inputs(task, *sg_problem(
        start, goal, 1, MR_H, MR_GP["dt"], SEED + 3), MR_SG_PARAMS)[N_c]
    results = {}
    hold_terms("terms_first_q_N%d" % q_main.shape[1], terms.unscaled(q_main),
               terms.plain.unscaled(q_main), results)
    name_c = "cost_candidates_N%d" % N_c
    results[name_c] = hold_cost(name_c, cost(q_cand), cost.plain(q_cand))
    same_lane_bits("mr_grasp cost", cost, run_multirobot_cost_kernel, q_cand)
    r = terms.plain.rows(q_main)[0]
    n_mut = sum(len(v) for v in lay.groups.values())
    k5 = dict(ms=device_ms(lambda: terms.unscaled(q_main), iters=20),
              call_ms=cuda_ms(lambda: terms.unscaled(q_main), iters=50),
              plain_ms=cuda_ms(lambda: terms.plain.unscaled(q_main), iters=3,
                               warmup=1),
              work=mr_terms_work(lay, q_main, r),
              max_abs_err=results["terms_first_q_N%d" % q_main.shape[1]][0])
    n_rows = 2 * len(lay.obj_pos) + len(lay.pair_a)
    k8 = dict(ms=device_ms(lambda: cost(q_cand), 20),
              call_ms=cuda_ms(lambda: cost(q_cand), iters=20),
              plain_ms=cuda_ms(lambda: cost.plain(q_cand), iters=2,
                               warmup=1),
              work=mr_cost_work(lay, N_c, n_rows),
              max_abs_err=results[name_c][0])
    torch.cuda.empty_cache()
    mr_rollout(task, start, goal, 1)                 # warm-up
    (xs, info), launches, ms = counted(lambda: mr_rollout(task, start, goal,
                                                          2))
    check(launches == {"multirobot_terms": 2 * MR_ITERS,
                       "btridiag_cols": 2 * MR_ITERS},
          "mr_grasp MPC launches %s, expected %d K5 and K4" % (
              launches, 2 * MR_ITERS))
    check(bool(torch.isfinite(xs).all()) and bool(torch.isfinite(
        info["final_state"].theta).all()), "mr_grasp MPC: non-finite")
    k5["launches"] = launches["multirobot_terms"]
    emit("mr_grasp", start_draw=draw, points=int(lay.point_joints().shape[0]),
         rows=n_rows, mutual_rows=n_mut,
         active_row_share=dict(rows=float((r > 0).float().mean()),
                               mutual_rows=float((r[-n_mut:] > 0).float()
                                                 .mean())),
         max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                   for k, v in results.items()},
         k5_ms=k5["ms"], k5_call_ms=k5["call_ms"], k5_plain_ms=k5["plain_ms"],
         k5_bound_ms=bound_ms(*k5["work"])[0],
         k5_bound_by=bound_ms(*k5["work"])[1], k8_ms=k8["ms"],
         k8_call_ms=k8["call_ms"], k8_plain_ms=k8["plain_ms"],
         k8_bound_ms=bound_ms(*k8["work"])[0],
         k8_bound_by=bound_ms(*k8["work"])[1], cost_launch=cost.params[3],
         mpc_launches=launches, mpc_ms_per_step=ms / 2)
    k8["launches"] = phase_sgpmp("mr_grasp_sgpmp", task, start, goal, 1,
                                 MR_SG_PARAMS, "multirobot_cost",
                                 SEED + 3)[0]
    return k5, k8


# ----------------------------------------------------------------------
# config 2's hybrid leg, CHOMP and config 5
# ----------------------------------------------------------------------
def k2_entry(name, D_l, U_l, b_l, launches):
    """K2 on a path's GN system vs its plain version, held to float64
    (hold_solve's GN rule), timed over a CUDA graph beside the plain
    version and the dense solve -> the kernels-line numbers."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import solve_lanes_w
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    x_k = solve_lanes_w(D_l, U_l, b_l)
    x_p = solve_lanes_core(D_l, U_l, b_l)
    held = hold_solve(name, x_k, x_p, solve_lanes_core(
        D_l.double(), U_l.double(), b_l.double()), random=False)
    H_, m, _, B_ = D_l.shape
    out = dict(max_abs_err=held["abs"], held=held, launches=launches,
               ms=device_ms(lambda: solve_lanes_w(D_l, U_l, b_l), iters=20),
               plain_ms=cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l),
                                iters=1, warmup=1),
               work=solve_work(H_, m, B_))
    del x_k, x_p
    torch.cuda.empty_cache()
    out["library_ms"] = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=1,
                                warmup=1)
    torch.cuda.empty_cache()
    return out


def hinge_edge_lanes(task, q):
    """Lanes (N,) with a residual row whose pre-hinge value lies within
    HINGE_EDGE of its threshold: active in the plain rows with every
    threshold raised by HINGE_EDGE, inactive with every one lowered by
    it."""
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    rows = task.collision_residuals.obstacle_terms_lanes.plain.rows
    thresh, margins = lay.obj_thresh, lay.self_margins
    lay.obj_thresh, lay.self_margins = (thresh + HINGE_EDGE,
                                        margins + HINGE_EDGE)
    up = rows(q)[0] > 0
    lay.obj_thresh, lay.self_margins = (thresh - HINGE_EDGE,
                                        margins - HINGE_EDGE)
    down = rows(q)[0] > 0
    lay.obj_thresh, lay.self_margins = thresh, margins
    return (up & ~down).any(0)


def terms_entry(name, task, q, launches, f64: bool = False):
    """K1 (K5 for a MultiRobot task) on a path's q (d, N) vs its plain
    version at the terms tolerance (Hqq off the hinge-edge lanes,
    HINGE_EDGE), timed over a CUDA graph beside the plain version -> the
    kernels-line numbers and the count of edge lanes.  With ``f64`` the
    kernel is held to the plain version in float64 on the card at that
    tolerance instead, and the plain float32 version's own share of it is
    reported (past 8 joints the two float32 orders are each up to ~0.6 of
    the tolerance off float64 in Hqq on the TIAGo's path, so they can be
    off each other by more than it)."""
    from torch_robotics_tpu_torch.ops.lanes_fk import MultiRobotLayout
    lanes_terms = task.collision_residuals.obstacle_terms_lanes
    lay = lanes_terms.plain.layout
    edge = hinge_edge_lanes(task, q)
    n_edge = int(edge.sum())
    check(n_edge <= HINGE_EDGE_SHARE * q.shape[1],
          "%s: %d of %d lanes at a hinge edge" % (name, n_edge, q.shape[1]))
    got, ref = lanes_terms.unscaled(q), lanes_terms.plain.unscaled(q)
    errs, extra = {}, {}
    if f64:
        ref64 = lanes_terms.plain.unscaled(q.double())
        hold_terms(name, (got[0], got[1][..., ~edge], got[2]),
                   (ref64[0], ref64[1][..., ~edge], ref64[2]), {})
        extra = dict(vs_plain=max_errs(got, ref), plain_share_of_tol_f64=max(
            float(((p.double() - r).abs() / (
                TERMS_ATOL_REL * float(r.abs().max())
                + TERMS_RTOL * r.abs())).max())
            for p, r in zip(ref, ref64)))
        del ref64
        errs[name] = extra["vs_plain"]
    else:
        hold_terms(name, (got[0], got[1][..., ~edge], got[2]),
                   (ref[0], ref[1][..., ~edge], ref[2]), errs)
    r = lanes_terms.plain.rows(q)[0]
    return dict(max_abs_err=errs[name][0], launches=launches,
                hinge_edge_lanes=n_edge, **extra,
                ms=device_ms(lambda: lanes_terms.unscaled(q), iters=20),
                plain_ms=cuda_ms(lambda: lanes_terms.plain.unscaled(q),
                                 iters=1, warmup=1),
                work=(mr_terms_work if isinstance(lay, MultiRobotLayout)
                      else terms_work)(lay, q, r))


def phase_hybrid():
    """Config 2's hybrid leg at full size (run_all.py:167-176): RRT-Connect
    with EnvDense2D's preset, the clamped spline, 1024 jittered copies
    refined by 150 GPMP2 iterations; see the module doc."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import (GPMP2Params, RRTConnectParams,
                                                gpmp2_solve, plan_hybrid,
                                                rrt_connect)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    from torch_robotics_tpu_torch.solve.hybrid import _hybrid_seed
    task, params, _, _, _ = pm_problem("cuda", 1)
    env, robot = task.env, task.robot
    rrt = RRTConnectParams.from_preset(env.get_rrt_connect_params(robot))
    start_q = torch.tensor(PM_START[:2], device="cuda")
    goal_q = torch.tensor(PM_GOAL[:2], device="cuda")
    start, goal = (torch.tensor(PM_START, device="cuda"),
                   torch.tensor(PM_GOAL, device="cuda"))
    H_ = params.n_support_points

    # plan_hybrid's seed, drawn as it draws it (its generator: the RRT's
    # pre-samples, then the jitter); warms the kd-tree build and the solve
    gen = torch.Generator(device="cuda").manual_seed(0)
    path0 = rrt_connect(task, start_q, goal_q, rrt, generator=gen)
    check(path0 is not None, "hybrid: RRT-Connect found no path")
    normals = torch.randn((PM_B, H_, 4), generator=gen, device="cuda")
    theta0 = _hybrid_seed(path0, start_q, goal_q, H_, params.dt, normals,
                          0.02)
    gpmp2_solve(task.collision_residuals, theta0, start, goal,
                dataclasses.replace(params, opt_iters=2))     # warm-up
    b_l, D_l, U_l, _ = _lanes_gn_system(
        task.collision_residuals.obstacle_terms_lanes, theta0, start, goal,
        params)
    check(tuple(D_l.shape) == (H_, 4, 4, PM_B),
          "hybrid's GN system is %s" % (tuple(D_l.shape),))
    k2 = k2_entry("k2_hybrid_gn", D_l, U_l, b_l, PM_ITERS)

    stats = {}

    def plan():
        t0 = time.perf_counter()
        out = plan_hybrid(task, start_q, goal_q, gpmp2_params=params,
                          num_samples=PM_B, stats=stats)
        torch.cuda.synchronize()
        stats["wall_s"] = time.perf_counter() - t0
        return out

    (res, path), launches, _ = counted(plan)
    check(path is not None, "hybrid: plan_hybrid's RRT found no path")
    check(stats["rrt_s"] < rrt.max_time,
          "hybrid: RRT ran into its max_time (%.1f s)" % stats["rrt_s"])
    check(np.array_equal(path, path0), "hybrid: the RRT path changed "
          "between two draws from the same seed")
    check(launches == {"btridiag_w": PM_ITERS},
          "hybrid launches %s, expected %d of btridiag_w only"
          % (launches, PM_ITERS))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "hybrid produced non-finite results")
    ends = max(float((res.trajs[:, 0, :2] - start_q).abs().max()),
               float((res.trajs[:, -1, :2] - goal_q).abs().max()))
    check(ends <= HY_END_TOL, "hybrid endpoints %.3g off" % ends)
    free = task.compute_fraction_free_trajs(res.trajs)
    check(free >= HY_MIN_FREE, "hybrid: fraction free %.4f below %.2f"
          % (free, HY_MIN_FREE))
    # the refinement's device time (5 iterations from the seed); the RRT's
    # queries are host-bound by construction (one synchronising check an
    # extend), its share is the wall's rest
    busy, dev_ms, top = profile_device(lambda: gpmp2_solve(
        task.collision_residuals, theta0, start, goal,
        dataclasses.replace(params, opt_iters=5)), 5)
    emit("hybrid", B=PM_B, H=H_, m=4, iterations=PM_ITERS,
         rrt_params=dataclasses.asdict(rrt), rrt_found=True,
         rrt_path_nodes=int(path.shape[0]), rrt_s=stats["rrt_s"],
         rrt_presample_s=stats["sample_s"], rrt_iterations=stats["n_iters"],
         rrt_segment_checks=stats["n_checks"],
         rrt_ms_per_check=stats["check_s"] * 1e3 / stats["n_checks"],
         plan_hybrid_wall_s=stats["wall_s"], launches=launches,
         fraction_free=free, jax_package_fraction_free=HY_JAX_FREE,
         endpoint_max_err=ends, mean_final_cost=float(res.costs.mean()),
         k2=dict(held=k2["held"], kernel_ms=k2["ms"],
                 plain_ms=k2["plain_ms"], dense_solve_ms=k2["library_ms"]),
         refinement_profiled_device_busy_share=busy,
         refinement_profiled_device_ms_per_iteration=dev_ms,
         refinement_top_device_ms_per_iteration=top)
    return k2


def plain_residuals(task):
    """The task's residuals without its lanes hooks: CHOMP then takes its
    autodiff branch."""
    def plain(q):
        return task.collision_residuals(q)
    plain.supports_batch = True
    return plain


def chomp_cpu_child(conn, theta0, start, goal):
    """Process body: CHOMP on the CPU from numpy theta0 (n, H, 14), start
    and goal (n, 14), in float32 and float64 through the task's hooks and
    in float32 through its plain residuals (the autodiff branch, phase
    chomp_autodiff's); the three trajectories and the wall clock
    (time.time()) at their end go back through ``conn``."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import CHOMPParams, chomp_solve
    from torch_robotics_tpu_torch.tasks import PlanningTask
    torch.set_num_threads(2)
    task = PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(device="cpu"),
                        obstacle_cutoff_margin=0.03)
    params = CHOMPParams(n_support_points=H, opt_iters=CH_ITERS)
    th, s, g = (torch.from_numpy(a) for a in (theta0, start, goal))
    out = [chomp_solve(fn, th.to(dt), s.to(dt), g.to(dt), params).trajs.numpy()
           for fn, dt in ((task.collision_residuals, torch.float32),
                          (task.collision_residuals, torch.float64),
                          (plain_residuals(task), torch.float32))]
    conn.send((out, time.time()))
    conn.close()


def chomp_theta0(start, goal):
    """Phase chomp's straight lines, drawn on the CPU (so the CPU runs and
    the card start from the same bits) -> theta0 on start's device."""
    from torch_robotics_tpu_torch.solve import straight_line_trajs
    return straight_line_trajs(start.cpu(), goal.cpu(), H).to(start.device)


def start_chomp_cpu():
    """Start phase chomp's CPU runs (its first CH_F64_B problems, float32
    and float64, and the autodiff branch's float32 run of phase
    chomp_autodiff, ~25-45 s of two threads) in a background process while
    nvcc builds the kernels (main() waits for their result before the
    first timed phase): spawned and daemonic, so it ends with this script
    -> (process, connection, theta0 of those lanes)."""
    import multiprocessing as mp
    _, start, goal = bench_problem("cpu", CH_F64_B)
    theta0 = chomp_theta0(start, goal)
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=chomp_cpu_child, daemon=True, args=(
        child, theta0.cpu().numpy(), start.cpu().numpy(),
        goal.cpu().numpy()))
    proc.start()
    child.close()
    return proc, parent, theta0


def phase_chomp(cpu_job):
    """CHOMP at BASELINE.md's size: the Panda in EnvSpheres3D, B = 512, H =
    64, 50 iterations of CHOMPParams' defaults from bench_problem's
    straight lines; its first lanes held to the CPU runs of ``cpu_job``
    (start_chomp_cpu); see the module doc."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.ops.terms_kernel import run_cost_kernel
    from torch_robotics_tpu_torch.solve import (CHOMPParams, chomp_solve,
                                                gp_prior_terms)
    task, start, goal = bench_problem("cuda", CH_B)
    params = CHOMPParams(n_support_points=H, opt_iters=CH_ITERS)
    theta0 = chomp_theta0(start, goal)
    res_fn = task.collision_residuals
    d, m, N = 7, 14, CH_B * H

    # the path's first inputs: q (b-major lanes), the clipped gradient and
    # the preconditioning system D + 1e-6 I shared over the batch
    q = theta0[..., :d].reshape(-1, d).T.contiguous()
    lam = 1.0 / params.sigma_coll ** 2
    k1 = terms_entry("chomp_q_N%d" % N, task, q, CH_ITERS)
    cost = res_fn.collision_cost_lanes
    k8_err = hold_cost("chomp_q_N%d" % N, cost(q), cost.plain(q))
    same_lane_bits("chomp_q_N%d" % N, cost, run_cost_kernel, q)
    r = res_fn.obstacle_terms_lanes.plain.rows(q)[0]
    k8 = dict(max_abs_err=k8_err[0], launches=CH_ITERS,
              ms=device_ms(lambda: cost(q), iters=20),
              plain_ms=cuda_ms(lambda: cost.plain(q), iters=1, warmup=1),
              work=cost_work(TermsLayout(task), N, r.shape[0]))
    g_gp, D, U = gp_prior_terms(theta0, start, goal, params.dt,
                                params.sigma_start, params.sigma_gp,
                                params.sigma_goal)
    g_q = res_fn.obstacle_terms_lanes(q, lam)[0]
    g = torch.clamp(params.weight_prior_cost * g_gp
                    + g_q.T.reshape(theta0.shape), -params.grad_clip,
                    params.grad_clip)
    eye = torch.eye(m, device="cuda")
    D_l = (D + 1e-6 * eye)[..., None].expand(H, m, m, CH_B).contiguous()
    U_l = torch.cat([U, torch.zeros_like(U[:1])])[..., None].contiguous()
    k2 = k2_entry("k2_chomp", D_l, U_l, g.permute(1, 2, 0).contiguous(),
                  CH_ITERS)

    chomp_solve(res_fn, theta0, start, goal,
                dataclasses.replace(params, opt_iters=2))     # warm-up
    res, launches, ms = counted(
        lambda: chomp_solve(res_fn, theta0, start, goal, params))
    expected = {"terms": CH_ITERS, "cost": CH_ITERS,
                "btridiag_w": CH_ITERS}
    check(launches == expected, "chomp launches %s, expected %s"
          % (launches, expected))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "chomp produced non-finite results")
    check(tuple(res.cost_trace.shape) == (CH_ITERS,), "chomp trace shape")
    n = CH_F64_B
    free = task.compute_fraction_free_trajs(res.trajs)
    busy, dev_ms, top = profile_device(lambda: chomp_solve(
        res_fn, theta0, start, goal,
        dataclasses.replace(params, opt_iters=5)), 5)
    ctl = chomp_solve(res_fn, theta0[:n], start[:n], goal[:n],
                      dataclasses.replace(params,
                                          sigma_coll=CH_CONTROL_SIGMA)).trajs

    proc, conn, theta0_job = cpu_job
    check(torch.equal(theta0_job, theta0[:n].cpu()),
          "chomp: the CPU runs start elsewhere")
    try:
        (th_h, th_64, th_ad), job_end = conn.recv()
    except EOFError:
        fail("chomp: the CPU runs' process ended with code %s and no result"
             % proc.exitcode)
    job_end_script_s = time.perf_counter() - T_START - (time.time()
                                                        - job_end)
    proc.join()
    th_h, th_64 = torch.from_numpy(th_h), torch.from_numpy(th_64)
    cpu_runs = {"hook": th_h, "autodiff": torch.from_numpy(th_ad),
                "f64": th_64}
    gaps = theta_gaps(res.trajs[:n], th_h, th_64)
    hold_to_f64("chomp", gaps)
    # the hold can fail a wrong gradient: the control misses its limits,
    # and the float64 run moves theta well past them
    limits = f64_limits(gaps)
    ctl_gaps = theta_gaps(ctl, th_h, th_64)
    moved = (float((th_64 - theta0_job.double()).abs().max())
             / float(th_64.abs().max()))
    for stat, limit in limits.items():
        check(ctl_gaps["card" + stat] >= CH_CONTROL_MARGIN * limit,
              "chomp: the zero-gradient control is off float64 by %.3g "
              "(theta%s), within %g x the hold's limit %.3g"
              % (ctl_gaps["card" + stat], stat, CH_CONTROL_MARGIN, limit))
    check(moved >= CH_CONTROL_MARGIN * limits["_vs_f64"],
          "chomp: float64 moves theta by %.3g of max|theta|, within %g x "
          "the hold's limit %.3g" % (moved, CH_CONTROL_MARGIN,
                                     limits["_vs_f64"]))
    emit("chomp", B=CH_B, H=H, iterations=CH_ITERS,
         params=dataclasses.asdict(params), launches=launches,
         wall_ms=ms, ms_per_iteration=ms / CH_ITERS,
         cost_trace_first_last=[float(res.cost_trace[0]),
                                float(res.cost_trace[-1])],
         fraction_free=free,
         fraction_free_start=task.compute_fraction_free_trajs(theta0),
         vs_float64=gaps, vs_float64_limits=limits,
         f64_moved_rel_to_max=moved,
         zero_gradient_control_vs_float64={
             k: ctl_gaps["card" + k] for k in limits},
         cpu_job_end_script_s=job_end_script_s,
         k1=dict(kernel_ms=k1["ms"], plain_ms=k1["plain_ms"],
                 hinge_edge_lanes=k1["hinge_edge_lanes"]),
         k8=dict(max_abs_err=k8_err, kernel_ms=k8["ms"],
                 plain_ms=k8["plain_ms"]),
         k2=dict(held=k2["held"], kernel_ms=k2["ms"],
                 plain_ms=k2["plain_ms"], dense_solve_ms=k2["library_ms"]),
         profiled_device_busy_share=busy,
         profiled_device_ms_per_iteration=dev_ms,
         top_device_ms_per_iteration=top)
    return k1, k8, k2, cpu_runs


def pod_problem(device, n_dev: int):
    """Config 5's problem -> (task, start (B, 14), goal (B, 14)): B =
    min(32768, 8192 x devices), start and goal uniform in the bands 0.2 of
    the joint range wide at either end (run_all.py:310-314), from a torch
    generator seeded SEED."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=EnvSpheres3D(device=device),
                        robot=RobotPanda.create(device=device),
                        obstacle_cutoff_margin=0.03)
    B_ = min(POD_B_MAX, POD_B_PER_DEVICE * n_dev)
    B_ = (B_ // n_dev) * n_dev
    robot = task.robot
    gen = torch.Generator().manual_seed(SEED)
    u1 = torch.rand((B_, robot.q_dim), generator=gen).to(device)
    u2 = torch.rand((B_, robot.q_dim), generator=gen).to(device)
    span = robot.q_max - robot.q_min
    qs = robot.q_min + 0.2 * span * (1 + u1) / 2
    qg = robot.q_max - 0.2 * span * (1 + u2) / 2
    return (task, torch.cat([qs, torch.zeros_like(qs)], -1),
            torch.cat([qg, torch.zeros_like(qg)], -1))


def phase_pod():
    """Config 5 on one card (run_all.py:295-337): mpc_rollout_sharded on a
    one-device mesh at the reference's chunk of 256 and unchunked; see the
    module doc."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.parallel import (make_mesh,
                                                   mpc_rollout_sharded,
                                                   shard_batch)
    from torch_robotics_tpu_torch.parallel.mesh import _POD_CHUNK
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    from torch_robotics_tpu_torch.tasks import PlanningTask
    mesh = make_mesh()
    n_dev = len(mesh)
    check(n_dev == 1, "pod: the phase runs on one card, %d are visible"
          % n_dev)
    task, start, goal = pod_problem("cuda", n_dev)
    B_ = start.shape[0]
    gp = GPMP2Params(**POD_GP)
    params = MPCParams(gpmp2=gp, iters_per_step=ITERS_PER_STEP)
    res_fn = task.collision_residuals
    s_sh, g_sh = shard_batch(start, mesh), shard_batch(goal, mesh)

    # the first chunk's first GN system (K1's q, K2's system) and the
    # whole batch's (the unchunked run's first launches)
    def first(n):
        theta = straight_line_trajs(start[:n], goal[:n], POD_H)
        q = theta[..., :7].permute(2, 1, 0).reshape(7, -1).contiguous()
        b_l, D_l, U_l, _ = _lanes_gn_system(res_fn.obstacle_terms_lanes,
                                            theta, start[:n], goal[:n], gp)
        return q, (D_l, U_l, b_l)

    steps_iters = POD_STEPS * ITERS_PER_STEP
    n_chunks = B_ // _POD_CHUNK
    q_c, sys_c = first(_POD_CHUNK)
    k1_c = terms_entry("pod_chunk_q_N%d" % q_c.shape[1], task, q_c,
                    n_chunks * steps_iters)
    k2_c = k2_entry("k2_pod_chunk", *sys_c, n_chunks * steps_iters)
    q_u, sys_u = first(B_)
    k1_u = terms_entry("pod_q_N%d" % q_u.shape[1], task, q_u, steps_iters)
    del q_u, q_c, sys_c
    torch.cuda.empty_cache()
    k2_u = k2_entry("k2_pod", *sys_u, steps_iters)
    del sys_u
    torch.cuda.empty_cache()

    mpc_rollout_sharded(res_fn, start[:2 * _POD_CHUNK],
                        goal[:2 * _POD_CHUNK], params, 1, mesh)  # warm-up
    runs = {}
    for key, chunk, n_launch in (("chunked", _POD_CHUNK,
                                  n_chunks * steps_iters),
                                 ("unchunked", None, steps_iters)):
        def roll(chunk=chunk):
            t0 = time.perf_counter()
            out = mpc_rollout_sharded(res_fn, s_sh, g_sh, params, POD_STEPS,
                                      mesh, chunk=chunk)
            torch.cuda.synchronize()
            runs.setdefault(key, {})["wall_s"] = time.perf_counter() - t0
            return out

        (xs, frac), launches, ms = counted(roll)
        expected = {"terms": n_launch, "btridiag_w": n_launch}
        check(launches == expected, "pod %s launches %s, expected %s"
              % (key, launches, expected))
        check(bool(torch.isfinite(xs).all()) and tuple(xs.shape) == (
            B_, POD_STEPS, 14), "pod %s: non-finite or misshapen states"
              % key)
        busy, dev_ms, top = profile_device(lambda: mpc_rollout_sharded(
            res_fn, s_sh, g_sh, params, 2, mesh, chunk=chunk), 2)
        runs[key].update(xs=xs, goal_fraction=float(frac),
                         launches=launches, event_ms=ms,
                         solves_per_s=B_ * POD_STEPS / runs[key]["wall_s"],
                         profiled_device_busy_share=busy,
                         profiled_device_ms_per_step=dev_ms,
                         top_device_ms_per_step=top)
    xs_c, xs_u = runs["chunked"].pop("xs"), runs["unchunked"].pop("xs")
    agree = float((xs_c - xs_u).abs().max()) / float(xs_u.abs().max())
    check(agree <= POD_AGREE, "pod: chunked and unchunked differ by %.3g of "
          "max|x|" % agree)
    check(runs["chunked"]["goal_fraction"]
          == runs["unchunked"]["goal_fraction"],
          "pod: the goal fraction depends on the chunking")
    task_h = PlanningTask(env=EnvSpheres3D(device="cpu"),
                          robot=RobotPanda.create(device="cpu"),
                          obstacle_cutoff_margin=0.03)
    n = POD_F64_B
    iters, chained = step_vs_f64(
        task, task_h, (start[:n], goal[:n]),
        (start[:n].cpu(), goal[:n].cpu()), gp, POD_H, ITERS_PER_STEP, "pod ")
    emit("pod", devices=n_dev, B=B_, H=POD_H, steps=POD_STEPS,
         iters_per_step=ITERS_PER_STEP, chunk=_POD_CHUNK, runs=runs,
         chunked_vs_unchunked_rel_to_max=agree,
         first_chunk_vs_f64=dict(iterations=iters, chained_step=chained),
         k1=dict(chunk_kernel_ms=k1_c["ms"], chunk_plain_ms=k1_c["plain_ms"],
                 kernel_ms=k1_u["ms"], plain_ms=k1_u["plain_ms"],
                 hinge_edge_lanes=[k1_c["hinge_edge_lanes"],
                                   k1_u["hinge_edge_lanes"]]),
         k2=dict(chunk_held=k2_c["held"], chunk_kernel_ms=k2_c["ms"],
                 held=k2_u["held"], kernel_ms=k2_u["ms"],
                 dense_solve_ms=[k2_c["library_ms"], k2_u["library_ms"]]))
    return k1_c, k2_c, k1_u, k2_u


def mp_problem(name, start_q, goal_q, device):
    """An MPOT workload -> (task, GPMP2Params, MPOTParams, start, goal,
    theta0 (MP_B, 64, 4)), theta0 from a seeded CPU generator."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.envs import make_env
    from torch_robotics_tpu_torch.robots import RobotPointMass
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPOTParams,
                                                gpmp2_init_trajs)
    from torch_robotics_tpu_torch.tasks import PlanningTask
    env = make_env(name, device=device)
    robot = RobotPointMass.create(device=device)
    task = PlanningTask(env=env, robot=robot,
                        obstacle_cutoff_margin=MP_CUTOFF)
    gp = dataclasses.replace(
        GPMP2Params.from_preset(env.get_gpmp2_params(robot)),
        num_samples=MP_B)
    mp = MPOTParams.from_preset({**env.get_mpot_params(robot),
                                 "sigma_start": 1e-3, "sigma_goal": 1e-3})
    start = torch.tensor(start_q + (0.0, 0.0), device=device)
    goal = torch.tensor(goal_q + (0.0, 0.0), device=device)
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(SEED), gp, start,
                              goal)
    return task, gp, mp, start, goal, theta0


def traj_quality(task, trajs):
    """(fraction free, mean path length, mean smoothness) of trajs."""
    from torch_robotics_tpu_torch.trajectory import (compute_path_length,
                                                     compute_smoothness)
    return dict(fraction_free=task.compute_fraction_free_trajs(trajs),
                path_length=float(compute_path_length(trajs,
                                                      task.robot).mean()),
                smoothness=float(compute_smoothness(trajs,
                                                    task.robot).mean()))


def mpot_f64(task, mp, start, goal, theta0):
    """MPOT alone on the first MP_F64_B trajectories, MP_F64_ITERS OT
    iterations and MP_F64_SMOOTH smoothing steps, on the card and on the
    CPU from the same inputs and rotations, each held to a float64 CPU run
    (hold_to_f64)."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve.mpot import (_mpot_solve_core,
                                                     mpot_rotations)
    from torch_robotics_tpu_torch.tasks import PlanningTask
    p = dataclasses.replace(mp, opt_iters=MP_F64_ITERS,
                            smooth_iters=MP_F64_SMOOTH)
    Q = mpot_rotations(torch.Generator().manual_seed(SEED + 5),
                       MP_F64_ITERS, 2)
    th0 = theta0[:MP_F64_B].cpu()

    def run(env, robot, th, s, g):
        t = PlanningTask(env=env, robot=robot,
                         obstacle_cutoff_margin=MP_CUTOFF)
        t_h = PlanningTask(env=env, robot=robot,
                           obstacle_cutoff_margin=MP_CUTOFF,
                           clamp_sdf_cost=True)
        return _mpot_solve_core(
            lambda x: t._compute_cost(x[..., :2]), th, s, g, p, Q,
            hinge_cost_fn=lambda x: t_h._compute_cost(x[..., :2])).trajs

    task_h, _, _, s_h, g_h, _ = mp_problem(
        task.env.name, tuple(start.tolist()[:2]), tuple(goal.tolist()[:2]),
        "cpu")
    env_h, robot_h = task_h.env, task_h.robot
    card = run(task.env, task.robot, th0.cuda(), start, goal)
    cpu = run(env_h, robot_h, th0, s_h, g_h)
    f64 = run(env_h, robot_h, th0.double(), s_h.double(), g_h.double())
    check(bool(torch.isfinite(card).all()), "mpot f64 hold: non-finite")
    gaps = theta_gaps(card, cpu, f64)
    hold_to_f64("mpot vs float64", gaps)
    return dict(B=MP_F64_B, ot_iterations=MP_F64_ITERS,
                smoothing_steps=MP_F64_SMOOTH, **gaps)


def phase_mpot():
    """plan_mpot_gpmp2 in both scenes at the workload's size, the float64
    hold, K2 on the polish's first GN system; see the module doc."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import plan_mpot_gpmp2
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    scenes, total, k2, f64 = {}, 0, None, None
    for name, start_q, goal_q in MP_SCENES:
        task, gp, mp, start, goal, theta0 = mp_problem(name, start_q,
                                                       goal_q, "cuda")
        check(task.collision_residuals.collision_cost_lanes is None,
              "mpot: the point mass has no lanes cost")
        plan_mpot_gpmp2(task, theta0, start, goal,        # warm-up
                        mpot_params=dataclasses.replace(
                            mp, opt_iters=2, smooth_iters=1),
                        gpmp2_params=gp, polish_iters=2)
        stats = {}
        (res, res_m), launches, ms = counted(lambda: plan_mpot_gpmp2(
            task, theta0, start, goal, mpot_params=mp, gpmp2_params=gp,
            polish_iters=MP_POLISH,
            generator=torch.Generator().manual_seed(SEED), stats=stats))
        expect = MP_POLISH * (2 if stats["fallback_ran"] else 1)
        check(launches == {"btridiag_w": expect},
              "mpot %s launches %s, expected %d of btridiag_w only"
              % (name, launches, expect))
        total += expect
        check(all(bool(torch.isfinite(t).all())
                  for t in (res.trajs, res.costs, res_m.trajs)),
              "mpot %s produced non-finite results" % name)
        check(tuple(res.trajs.shape) == (MP_B, gp.n_support_points, 4),
              "mpot %s result shape" % name)
        ends = max(float((res.trajs[:, 0, :2] - start[:2]).abs().max()),
                   float((res.trajs[:, -1, :2] - goal[:2]).abs().max()))
        check(ends <= MP_END_TOL, "mpot %s endpoints %.3g off"
              % (name, ends))
        b_l, D_l, U_l, _ = _lanes_gn_system(
            task.collision_residuals.obstacle_terms_lanes, res_m.trajs,
            start, goal, gp)
        check(tuple(D_l.shape) == (gp.n_support_points, 4, 4, MP_B),
              "mpot's GN system is %s" % (tuple(D_l.shape),))
        if k2 is None:
            k2 = k2_entry("k2_mpot_gn", D_l, U_l, b_l, None)
            f64 = mpot_f64(task, mp, start, goal, theta0)
        # a shortened pipeline under the profiler: its busy share
        busy, dev_ms, top = profile_device(lambda: plan_mpot_gpmp2(
            task, theta0, start, goal, mpot_params=dataclasses.replace(
                mp, opt_iters=20, smooth_iters=10), gpmp2_params=gp,
            polish_iters=10, fallback_polish=False), 1)
        scenes[name] = dict(
            mpot_params=dataclasses.asdict(mp), polish_iters=MP_POLISH,
            launches=launches, fallback_ran=stats["fallback_ran"],
            wall_ms=ms, mpot_s=stats["mpot_s"], polish_s=stats["polish_s"],
            fallback_s=stats["fallback_s"],
            after_mpot=traj_quality(task, res_m.trajs),
            after_pipeline=traj_quality(task, res.trajs),
            jax_package_pipeline_fraction_free=MP_JAX_FREE[name],
            endpoint_max_err=ends,
            cost_trace_first_last=[float(res_m.cost_trace[0].mean()),
                                   float(res_m.cost_trace[-1].mean())],
            short_pipeline_profiled_device_busy_share=busy,
            short_pipeline_profiled_device_ms=dev_ms,
            short_pipeline_top_device_ms=top)
    k2["launches"] = total
    emit("mpot", B=MP_B, H=64, scenes=scenes, vs_float64=f64,
         k2=dict(held=k2["held"], kernel_ms=k2["ms"],
                 plain_ms=k2["plain_ms"], dense_solve_ms=k2["library_ms"],
                 launches_both_scenes=total))
    return k2


def p2_problem(device, n_batch: int = P2_B):
    """The planar 2-link workload -> (task, params, start, goal, theta0
    (n, 32, 4)), theta0 from a seeded CPU generator (the first n of the
    P2_B samples)."""
    import torch
    from torch_robotics_tpu_torch.envs import EnvPlanar2Link
    from torch_robotics_tpu_torch.robots import RobotPlanar2Link
    from torch_robotics_tpu_torch.solve import GPMP2Params, gpmp2_init_trajs
    from torch_robotics_tpu_torch.tasks import PlanningTask
    task = PlanningTask(env=EnvPlanar2Link(device=device),
                        robot=RobotPlanar2Link.create(device=device),
                        obstacle_cutoff_margin=0.01)
    params = GPMP2Params(**P2_GP)
    start = torch.tensor(P2_START, device=device)
    goal = torch.tensor(P2_GOAL, device=device)
    theta0 = gpmp2_init_trajs(torch.Generator().manual_seed(SEED), params,
                              start, goal)
    return task, params, start, goal, theta0[:n_batch].contiguous()


def phase_planar2link():
    """gpmp2_solve on the planar 2-link arm through the generic GN step;
    see the module doc."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import gpmp2_solve
    from torch_robotics_tpu_torch.solve.gpmp2 import (_generic_gn_system,
                                                      _lanes_layout)
    task, params, start, goal, theta0 = p2_problem("cuda")
    res_fn = task.collision_residuals
    check(res_fn.obstacle_terms_lanes is None
          and res_fn.collision_cost_lanes is None,
          "planar2link: the arm's task has no lanes hooks")
    g, D, U, _ = _generic_gn_system(res_fn, theta0, start, goal, params)
    D_l, U_l, b_l = _lanes_layout(D, U, -g)
    H_ = params.n_support_points
    check(tuple(D_l.shape) == (H_, 4, 4, P2_B),
          "planar2link's GN system is %s" % (tuple(D_l.shape),))
    gpmp2_solve(res_fn, theta0, start, goal,
                dataclasses.replace(params, opt_iters=2))     # warm-up
    res, launches, ms = counted(
        lambda: gpmp2_solve(res_fn, theta0, start, goal, params))
    iters = params.opt_iters
    check(launches == {"btridiag_w": iters},
          "planar2link launches %s, expected %d of btridiag_w only"
          % (launches, iters))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "planar2link produced non-finite results")
    first, last = (float(res.cost_trace[0].mean()),
                   float(res.cost_trace[-1].mean()))
    check(last <= first, "planar2link: mean cost rose %.6g -> %.6g"
          % (first, last))
    busy, dev_ms, top = profile_device(lambda: gpmp2_solve(
        res_fn, theta0, start, goal,
        dataclasses.replace(params, opt_iters=5)), 5)
    task_h, _, s_h, g_h, th_h = p2_problem("cpu", P2_F64_B)
    th_h = theta0[:P2_F64_B].cpu()
    r_h = gpmp2_solve(task_h.collision_residuals, th_h, s_h, g_h, params)
    r_64 = gpmp2_solve(task_h.collision_residuals, th_h.double(),
                       s_h.double(), g_h.double(), params)
    gaps = theta_gaps(res.trajs[:P2_F64_B], r_h.trajs, r_64.trajs)
    hold_to_f64("planar2link vs float64", gaps)
    k2 = k2_entry("k2_planar2link_gn", D_l, U_l, b_l, iters)
    emit("planar2link", B=P2_B, H=H_, m=4, iterations=iters,
         launches=launches, solve_ms=ms, ms_per_iteration=ms / iters,
         trajs_per_s=P2_B / (ms / 1e3),
         cost_trace_mean_first_last=[first, last],
         fraction_free=task.compute_fraction_free_trajs(res.trajs),
         vs_float64=dict(B=P2_F64_B, **gaps),
         k2=dict(held=k2["held"], kernel_ms=k2["ms"],
                 plain_ms=k2["plain_ms"], dense_solve_ms=k2["library_ms"]),
         profiled_device_busy_share=busy,
         profiled_device_ms_per_iteration=dev_ms,
         top_device_ms_per_iteration=top)
    return k2


# ----------------------------------------------------------------------
# the robot zoo past eight joints: config 1's FK over the whole zoo, and
# the dual-arm TIAGo through MPC and sGPMP (K1 and K8 at D = 14, K4 at m
# = 28), the terms kernel's wide route at D = 14 and 24
# ----------------------------------------------------------------------
def zoo_fk_f64(model, q):
    """fk_all_links and the lane positions on the CPU in float64 from the
    same q -> (H (B, L, 4, 4), positions (B, L, 3))."""
    from torch_robotics_tpu_torch.kin import fk_all_links
    from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
    q64 = q.cpu().double()
    return fk_all_links(model, q64), fk_positions_lanes(model, q64)


def phase_zoo_fk():
    """Config 1's FK over the zoo (examples/forward_kinematics.py's robots
    and the UR10's suction gripper) at B = ZOO_B on the card: fk_all_links
    and fk_positions_lanes finite, their first ZOO_F64_B lanes held to a
    float64 CPU FK (the float32 FK golden tolerance, FK_ATOL, times the
    largest coordinate past 1 m), the goldens' q held to the goldens (the
    Shadow hand's lf* links, which the reference turns about z, left
    out); ms a call and rollouts/s of each."""
    import torch
    from torch_robotics_tpu_torch.kin import fk_all_links, robot_zoo
    from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
    golden_dir = Path(__file__).resolve().parent / "tests" / "golden"
    out = {}
    for name, kw, golden, exclude in ZOO_MODELS:
        model = getattr(robot_zoo, name)(device="cuda", **kw)
        lo, hi = model.q_lower, model.q_upper
        u = np.random.default_rng(ZOO_SEED).uniform(-0.2, 1.2, (
            ZOO_B, model.n_dofs))
        q = torch.as_tensor(lo + u * (hi - lo), dtype=torch.float32,
                            device="cuda")
        H_all = fk_all_links(model, q)
        pos = fk_positions_lanes(model, q)
        check(tuple(H_all.shape) == (ZOO_B, model.n_links, 4, 4)
              and tuple(pos.shape) == (ZOO_B, model.n_links, 3)
              and bool(torch.isfinite(H_all).all())
              and bool(torch.isfinite(pos).all()), name + ": FK output")
        H64, pos64 = zoo_fk_f64(model, q[:ZOO_F64_B])
        err = float((H_all[:ZOO_F64_B].cpu().double() - H64).abs().max())
        err_pos = float((pos[:ZOO_F64_B].cpu().double() - pos64)
                        .abs().max())
        # float32 rounding grows with the coordinates: the holonomic
        # TIAGo's base moves up to 140 m
        tol = FK_ATOL * max(1.0, float(H64.abs().max()))
        check(max(err, err_pos) <= tol, "%s: FK off float64 by %.3g / %.3g "
              "(at most %.3g)" % (name, err, err_pos, tol))
        entry = dict(dofs=model.n_dofs, links=model.n_links,
                     vs_float64=err, positions_vs_float64=err_pos)
        if golden is not None:
            g = json.loads((golden_dir / (golden + ".json")).read_text())
            check(list(model.link_names) == list(g["link_names"]),
                  name + ": link names differ from the golden's")
            Hg = fk_all_links(model, torch.as_tensor(
                g["q"], dtype=torch.float32, device="cuda")).cpu()
            keep = [i for i, n in enumerate(g["link_names"])
                    if exclude is None or not n.startswith(exclude)]
            err_g = float((Hg[:, keep] - torch.as_tensor(
                g["link_tensor"])[:, keep]).abs().max())
            check(err_g <= FK_ATOL, "%s: FK off its golden by %.3g"
                  % (name, err_g))
            entry["vs_golden"] = err_g
        ms = cuda_ms(lambda: fk_all_links(model, q), iters=10)
        ms_pos = cuda_ms(lambda: fk_positions_lanes(model, q), iters=10)
        entry.update(fk_all_links_ms=ms, rollouts_per_s=ZOO_B / (ms / 1e3),
                     positions_ms=ms_pos)
        out[name + ("_gripper" if kw else "")] = entry
        del H_all, pos
    torch.cuda.empty_cache()
    emit("zoo_fk", B=ZOO_B, robots=out)


def tiago_task(device):
    """The dual-arm TIAGo in EnvTableShelf (tasks/zoo_tasks.py), the main
    path's cutoff."""
    from torch_robotics_tpu_torch.envs import EnvTableShelf
    from torch_robotics_tpu_torch.tasks.zoo_tasks import tiago_dual_task
    return tiago_dual_task(EnvTableShelf(device=device), device=device)


def tiago_problem(device, n_batch: int, seed: int = SEED):
    """tiago_task -> (task, start, goal): n_batch free start and goal
    draws (free_start_goal)."""
    import torch
    from torch_robotics_tpu_torch.tasks.zoo_tasks import free_start_goal
    task = tiago_task(device)
    start, goal = free_start_goal(task, n_batch, seed)
    return (task, torch.as_tensor(start, device=device),
            torch.as_tensor(goal, device=device))


def goal_dist(q, goal):
    """Median over lanes of |q - q_goal| (q (B, d))."""
    d = q.shape[-1]
    return float((q - goal[:, :d]).norm(dim=-1).median())


def cols_entry(name, D_l, U_l, b_l, launches, random: bool = False):
    """K4 (the route cols_launch_config gives m) on a path's GN system vs
    its plain version, held to float64 (hold_solve's GN rule, or its
    random rule), timed over a CUDA graph beside the plain version and the
    dense solve -> the kernels-line numbers."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import (
        cols_launch_config, solve_lanes_cols, solve_lanes_cols_wide)
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    solve = (solve_lanes_cols_wide if cols_launch_config(
        D_l.shape[1], D_l.shape[3])["route"] == "shared" else solve_lanes_cols)
    x_k = solve(D_l, U_l, b_l)
    x_p = solve_lanes_core(D_l, U_l, b_l)
    held = hold_solve(name, x_k, x_p, solve_lanes_core(
        D_l.double(), U_l.double(), b_l.double()), random=random)
    H_, m, _, B_ = D_l.shape
    out = dict(max_abs_err=held["abs"], held=held, launches=launches,
               launch=cols_launch_config(m, B_),
               ms=device_ms(lambda: solve(D_l, U_l, b_l), iters=10),
               plain_ms=cuda_ms(lambda: solve_lanes_core(D_l, U_l, b_l),
                                iters=1, warmup=1),
               work=cols_solve_work(H_, m, B_))
    del x_k, x_p
    torch.cuda.empty_cache()
    out["library_ms"] = cuda_ms(dense_solve_fn(D_l, U_l, b_l), iters=1,
                                warmup=1)
    torch.cuda.empty_cache()
    return out


def phase_tiago_mpc():
    """The dual-arm TIAGo's MPC at the main path's protocol (B = 1024, H =
    64, 2 GN iterations a step, 8 steps, phase main's GPMP2Params) in
    EnvTableShelf from free start and goal draws: exactly 16 K1 (D = 14, N
    = 65,536) and 16 K4 ((64, 28, 28, 1024)) launches and nothing else,
    finite outputs, the active-row share on the first q, fraction free,
    the plans' and the state's goal distance, step ms, solves/s, a
    profile; one step at B = TG_F64_B on the card and on the CPU held to a
    float64 CPU step (phase cpu's rule); K1 and K4 on the path's first
    inputs vs plain and timed -> (K1, K4) kernels-line numbers."""
    import torch
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    task, start, goal = tiago_problem("cuda", B)
    terms = task.collision_residuals.obstacle_terms_lanes
    q0 = net_first_q(start, goal)
    rows0 = terms.plain.rows(q0)[0]
    active = float((rows0 > 0).float().mean())
    lanes_active = float((rows0 > 0).any(0).float().mean())
    check(active > 0.0, "tiago_mpc: no residual row active on the first q")
    run_mpc(task, start, goal, 1)                    # warm-up
    (state, costs, thetas), launches, ms = counted(
        lambda: run_mpc(task, start, goal, N_STEPS))
    expected = N_STEPS * ITERS_PER_STEP
    check(launches == {"terms": expected, "btridiag_cols": expected},
          "tiago_mpc launches %s, expected %d of terms and btridiag_cols"
          % (launches, expected))
    check(all(bool(torch.isfinite(t).all()) for t in thetas)
          and bool(torch.isfinite(costs).all()),
          "tiago_mpc produced non-finite results")
    step_ms = ms / N_STEPS
    busy, dev_ms, top = profile_device(
        lambda: run_mpc(task, start, goal, 2), 2)
    d = start.shape[1] // 2
    th0 = straight_line_trajs(start, goal, H)
    free0 = task.compute_fraction_free_trajs(th0)
    free = task.compute_fraction_free_trajs(state.theta)

    n = TG_F64_B
    iters, chained = step_vs_f64(
        task, tiago_task("cpu"), (start[:n].contiguous(),
                                  goal[:n].contiguous()),
        (start[:n].cpu(), goal[:n].cpu()), GPMP2Params(**GP_PARAMS), H,
        ITERS_PER_STEP, "tiago ")

    k1 = terms_entry("tiago_first_q_N%d" % q0.shape[1], task, q0, expected,
                  f64=True)
    b_l, D_l, U_l, _ = _lanes_gn_system(terms, th0, start, goal,
                                        GPMP2Params(**GP_PARAMS))
    check(tuple(D_l.shape) == (H, 2 * d, 2 * d, B),
          "tiago's GN system is %s" % (tuple(D_l.shape),))
    k4 = cols_entry("tiago_gn_system", D_l, U_l, b_l, expected)
    del D_l, U_l, b_l
    torch.cuda.empty_cache()
    emit("tiago_mpc", B=B, H=H, dofs=d, steps=N_STEPS,
         rows=int(rows0.shape[0]), active_row_share_first_q=active,
         lanes_with_active_row_first_q=lanes_active, launches=launches,
         step_ms=step_ms, solves_per_s=B / (step_ms / 1e3),
         init_fraction_free=free0, fraction_free=free,
         plan_end_goal_dist_median=goal_dist(state.theta[:, -1, :d], goal),
         state_goal_dist_median=goal_dist(state.x[:, :d], goal),
         start_goal_dist_median=goal_dist(start[:, :d], goal),
         mean_collision_cost_first_last=[float(costs[0].mean()),
                                         float(costs[-1].mean())],
         vs_float64=dict(B=n, iterations=iters, chained_step=chained),
         k1=dict(kernel_ms=k1["ms"], plain_ms=k1["plain_ms"],
                 hinge_edge_lanes=k1["hinge_edge_lanes"],
                 vs_plain=k1["vs_plain"],
                 plain_share_of_tol_f64=k1["plain_share_of_tol_f64"],
                 launch=terms.params[4], bound_ms=bound_ms(*k1["work"])[0]),
         k4=dict(held=k4["held"], kernel_ms=k4["ms"],
                 plain_ms=k4["plain_ms"], dense_solve_ms=k4["library_ms"],
                 launch=k4["launch"], bound_ms=bound_ms(*k4["work"])[0]),
         profiled_device_busy_share=busy, profiled_device_ms_per_step=dev_ms,
         top_device_ms_per_step=top)
    return k1, k4


def phase_tiago_sgpmp():
    """sGPMP on the TIAGo at phase sgpmp's shape (B = 512 free start and
    goal draws, 8 particles, H = 32, 100 iterations of K = 16): exactly
    201 K8 launches (D = 14; 100 at 2,097,152 lanes, 101 at 131,072) and
    nothing else, the metrics of phase sgpmp; K8 on its first candidates
    and proposal vs plain (the plain cost in chunks), a lane's bits the
    same at a ragged N and at 32 lanes a block, timed; one iteration at B
    = 32 held to float64 (phase sgpmp_cpu's rule) -> the kernels-line
    numbers at 2,097,152."""
    import torch
    from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
    from torch_robotics_tpu_torch.ops.terms_kernel import run_cost_kernel
    task, start, goal = tiago_problem("cuda", IL_B, seed=SEED + 2)
    cost = task.collision_residuals.collision_cost_lanes
    N_sg = SG_PARAMS["num_samples"] * IL_B * SG_PART * IL_H
    seen = capture_cost_inputs(task, *sg_problem(
        start, goal, SG_PART, IL_H, SG_PARAMS["dt"], SEED + 2), SG_PARAMS)
    lay = TermsLayout(task)
    n_rows = 2 * len(lay.obj_pos) + len(lay.pair_a)
    results, out = {}, {}
    for key, q, iters in (("sgpmp", seen[N_sg], 10),
                          ("acceptance", seen[IL_B * SG_PART * IL_H], 20)):
        name = "tiago_%s_N%d" % (key, q.shape[1])
        results[name] = hold_cost(name, cost(q), chunked(cost.plain, q))
        same_lane_bits(name, cost, run_cost_kernel, q)
        out[key] = dict(N=q.shape[1], ms=device_ms(lambda: cost(q), iters),
                        plain_ms=cuda_ms(lambda: chunked(cost.plain, q),
                                         iters=1, warmup=1),
                        work=cost_work(lay, q.shape[1], n_rows),
                        max_abs_err=results[name][0])
    del seen
    torch.cuda.empty_cache()
    launches, theta0, start_p, goal_p = phase_sgpmp(
        "tiago_sgpmp", task, start, goal, SG_PART, SG_PARAMS, "cost",
        SEED + 2)
    check(launches == 2 * SG_PARAMS["opt_iters"] + 1,
          "tiago_sgpmp: %d K8 launches" % launches)
    # the whole solve on the CPU takes ~60 s at D = 14 (its plain cost
    # builds the terms' Jacobians): one iteration is held
    phase_sgpmp_cpu(task, theta0, start_p, goal_p, task_h=tiago_task("cpu"),
                    name="tiago_sgpmp_cpu", full_solve=False)
    emit("tiago_cost", rows=n_rows, launch=cost.params[3],
         max_errs={k: {"abs": v[0], "rel_to_max": v[1]}
                   for k, v in results.items()},
         kernel_ms={k: v["ms"] for k, v in out.items()},
         plain_ms={k: v["plain_ms"] for k, v in out.items()},
         bound_ms={k: bound_ms(*v["work"])[0] for k, v in out.items()},
         bound_by={k: bound_ms(*v["work"])[1] for k, v in out.items()})
    return dict(out["sgpmp"], launches=launches)


def crossed_q(task, N: int, seed: int):
    """q (d, N) on the card where a self-collision pair is active: a
    random_q pool of 16 N, the lanes with an active pair row kept, tiled to
    N and jittered by 0.01 rad (the TIAGo's arms come within a pair's
    margin on ~0.15% of uniform q)."""
    import torch
    terms = task.collision_residuals.obstacle_terms_lanes
    pool = random_q(task, 16 * N, seed)
    n_pt = 2 * len(terms.plain.layout.obj_pos)
    keep = pool[:, (terms.plain.rows(pool)[0][n_pt:] > 0).any(0)]
    check(keep.shape[1] > 0, "no q with an active pair in the pool")
    q = keep.repeat(1, -(-N // keep.shape[1]))[:, :N]
    noise = torch.as_tensor(np.random.default_rng(seed).normal(
        0.0, 0.01, q.shape), dtype=torch.float32, device=q.device)
    return (q + noise).contiguous()


def chain_task(n: int, device):
    """A chain of n revolute joints about z, 5 cm apart (a URDF built in
    memory), its last three links' origins as collision points and one
    pair, in EnvSpheres3D: past the terms kernel's 32 joints for n = 33,
    within the cost kernel's 64."""
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.kin import KinematicModel
    from torch_robotics_tpu_torch.kin.urdf import (UrdfJoint, UrdfLink,
                                                   UrdfRobot)
    from torch_robotics_tpu_torch.robots import KinematicRobot
    from torch_robotics_tpu_torch.tasks import PlanningTask
    joints = [UrdfJoint(name="j%d" % i, type="revolute", parent="l%d" % i,
                        child="l%d" % (i + 1), origin_xyz=(0.05, 0.0, 0.0),
                        origin_rpy=(0.0, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
                        limit_lower=-2.0, limit_upper=2.0, has_limit=True)
              for i in range(n)]
    model = KinematicModel.from_urdf_robot(UrdfRobot(
        name="chain%d" % n, links=[UrdfLink(name="l%d" % i)
                                   for i in range(n + 1)], joints=joints),
        name="chain%d" % n, device=device)
    robot = KinematicRobot.create(
        model, object_coll_links=["l%d" % i for i in (n // 2, n - 1, n)],
        object_coll_margins=[0.05] * 3, self_coll_pairs={"l%d" % n: ["l0"]})
    return PlanningTask(env=EnvSpheres3D(device=device), robot=robot,
                        obstacle_cutoff_margin=0.03)


def phase_wide_terms():
    """K1's route past eight joints (terms_wide_kernel) vs its plain
    version on the card at N = TG_WIDE_N: the TIAGo (D = 14) in
    EnvTableShelf on random q and on q where its arms' pairs are active,
    the Shadow hand (D = 24) holding its ball on random q; held to the
    plain version in float64 at the terms tolerance (terms_entry's f64), Hqq
    off the hinge-edge lanes (HINGE_EDGE); a lane's bits the same at a
    ragged N and at each other lane count of 32, 64, 96, 128 that fits,
    timed over a CUDA graph at each; then one MPC step of the
    Shadow hand (B = 1024, H = 64, from straight lines between q drawn in
    its limits): exactly 2 K1 and 2 K4 launches; a 33-joint chain's terms
    hook raises NotImplementedError in its words on the card while its
    cost hook runs K8 there (held to plain) -> the kernels-line numbers
    at D = 24."""
    import torch
    from torch_robotics_tpu_torch.ops.terms_kernel import (
        _terms_block, run_terms_kernel)
    from torch_robotics_tpu_torch.tasks.zoo_tasks import shadow_hand_task
    N = TG_WIDE_N
    tiago = tiago_task("cuda")
    shadow = shadow_hand_task(device="cuda")
    results, timed = {}, {}
    for name, task, q in (
            ("tiago_random_q", tiago, random_q(tiago, N, seed=41)),
            ("tiago_crossed_arms_q", tiago, crossed_q(tiago, N, seed=42)),
            ("shadow_random_q", shadow, random_q(shadow, N, seed=43))):
        terms = task.collision_residuals.obstacle_terms_lanes
        d_, ints, floats, _, launch = terms.params
        check(terms.refusal is None and d_ in (14, 24),
              name + ": the terms hook refuses: %s" % terms.refusal)
        entry = terms_entry(name, task, q, 0, f64=True)
        rows = terms.plain.rows(q)[0]
        n_pt = len(terms.plain.layout.obj_pos)
        full = terms.unscaled(q)
        ragged = terms.unscaled(q[:, :GN_RAGGED_N].contiguous())
        by_lanes = {launch["lanes"]: entry["ms"]}
        for lanes in (32, 64, 96, 128):
            lc, refused = _terms_block(ints.cpu().numpy(), floats.numel(),
                                       lanes)
            if refused is not None or lanes == launch["lanes"]:
                continue
            check(all(torch.equal(a, b) for a, b in zip(
                run_terms_kernel(q, ints, floats, d_, lc, terms.grid),
                full)), name + ": a lane's bits change with the lanes a "
                "block (%d)" % lanes)
            by_lanes[lanes] = device_ms(lambda lc=lc: run_terms_kernel(
                q, ints, floats, d_, lc, terms.grid), iters=20)
        check(all(torch.equal(a[..., :GN_RAGGED_N], b)
                  for a, b in zip(full, ragged)),
              name + ": a lane's bits change with the batch")
        results[name] = dict(
            dofs=d_, launch=launch, max_abs_err=entry["max_abs_err"],
            plain_share_of_tol_f64=entry["plain_share_of_tol_f64"],
            hinge_edge_lanes=entry["hinge_edge_lanes"],
            active_row_share=float((rows > 0).float().mean()),
            active_pair_row_share=float((rows[2 * n_pt:] > 0).float()
                                        .mean()),
            kernel_ms=entry["ms"], kernel_ms_by_lanes=by_lanes,
            plain_ms=entry["plain_ms"], bound_ms=bound_ms(*entry["work"])[0],
            bound_by=bound_ms(*entry["work"])[1])
        timed[name] = entry
        del full, ragged
        torch.cuda.empty_cache()
    check(results["tiago_crossed_arms_q"]["active_pair_row_share"] > 0,
          "wide_terms: no pair row active on the crossed-arms q")
    # past 32 joints the terms hook raises on the card; the cost kernel,
    # on its own limits (64 joints), runs there
    chain = chain_task(33, "cuda")
    res = chain.collision_residuals
    q33 = random_q(chain, 4096, seed=45)
    words = res.obstacle_terms_lanes.refusal or ""
    raised = False
    try:
        res.obstacle_terms_lanes.unscaled(q33)
    except NotImplementedError as e:
        raised = str(e) == words
    check(raised and "32 joints" in words,
          "wide_terms: the 33-joint terms hook did not refuse: %r" % words)
    cost33 = res.collision_cost_lanes
    check(cost33.refusal is None, "wide_terms: the cost kernel refuses 33 "
          "joints: %s" % cost33.refusal)
    c33 = hold_cost("chain33_cost_N4096", cost33(q33), cost33.plain(q33))
    # the Shadow hand's terms hook on a path: one MPC step
    lo, hi = shadow.robot.model.q_lower, shadow.robot.model.q_upper
    rng = np.random.default_rng(44)
    z = np.zeros((B, lo.shape[0]))
    s_g = [torch.as_tensor(np.concatenate([lo + rng.uniform(
        size=(B, lo.shape[0])) * (hi - lo), z], -1), dtype=torch.float32,
        device="cuda") for _ in range(2)]
    run_mpc(shadow, *s_g, 1)                         # warm-up
    (state, costs, _), launches, ms = counted(
        lambda: run_mpc(shadow, *s_g, 1))
    check(launches == {"terms": ITERS_PER_STEP,
                       "btridiag_cols": ITERS_PER_STEP},
          "shadow MPC step launches %s" % launches)
    check(bool(torch.isfinite(state.theta).all()),
          "shadow MPC step non-finite")
    emit("wide_terms", N=N, cases=results,
         chain33=dict(terms_refusal=words, cost_launch=cost33.params[3],
                      cost_max_errs=c33,
                      active_row_share=float((res.obstacle_terms_lanes.plain
                                              .rows(q33)[0] > 0).float()
                                             .mean())),
         shadow_mpc_step=dict(B=B, H=H, launches=launches, step_ms=ms,
                              mean_collision_cost=float(costs[0].mean())))
    return {"d24": dict(timed["shadow_random_q"], launches=ITERS_PER_STEP)}


# ----------------------------------------------------------------------
# the MultiRobot cells past K5's first caps (MR_CELLS): a same-member
# mutual pair, a member with the learned net, a member past eight joints,
# five members
# ----------------------------------------------------------------------
def mr_in_limits_q(task, N: int, seed: int):
    """q (d, N) on the card, uniform within a MultiRobot's joint limits."""
    import torch
    lo = task.robot.q_min.cpu().numpy()
    hi = task.robot.q_max.cpu().numpy()
    u = np.random.default_rng(seed).uniform(size=(lo.shape[0], N))
    return torch.as_tensor(lo[:, None] + u * (hi - lo)[:, None],
                           dtype=torch.float32, device="cuda")


def mr_cell_mpc(cell, task, start, goal, k4: str = "btridiag_cols",
                n_f64: int = MR_CPU_B):
    """Config 4's MPC on a cell (B = 256, H = 32, 30 steps of 2 GN
    iterations, mpc_rollout): exactly 60 K5 and 60 K4 launches (``k4``,
    the counter of its route) and nothing else, finite outputs, step ms,
    solves/s, goal distance and fraction free of the executed paths; one
    step at B = ``n_f64`` on the card and on the CPU held to a float64
    CPU step (step_vs_f64, phase mr_cpu's rule) -> the phase line's MPC
    fields."""
    import torch
    from torch_robotics_tpu_torch.solve import GPMP2Params
    mr_rollout(task, start, goal, 1)                 # warm-up
    (xs, info), launches, ms = counted(
        lambda: mr_rollout(task, start, goal, MR_STEPS))
    expected = MR_STEPS * MR_ITERS
    check(launches == {"multirobot_terms": expected, k4: expected},
          "%s MPC launches %s, expected %d K5 and %d K4"
          % (cell, launches, expected, expected))
    final = info["final_state"]
    check(all(bool(torch.isfinite(t).all()) for t in
              (xs, info["dist_to_goal"], final.theta, final.x)),
          cell + " MPC produced non-finite outputs")
    d = start.shape[1] // 2
    executed = torch.cat([start[:, None], xs], dim=1)
    n = n_f64
    iters, chained = step_vs_f64(
        task, mr_task("cpu", *MR_CELLS[cell]),
        (start[:n].contiguous(), goal[:n].contiguous()),
        (start[:n].cpu(), goal[:n].cpu()), GPMP2Params(**MR_GP), MR_H,
        MR_ITERS, cell + " ")
    return dict(launches=launches, ms_per_step=ms / MR_STEPS,
                solves_per_s=MR_B * MR_STEPS / (ms / 1e3),
                mean_final_goal_dist=float(info["dist_to_goal"][-1].mean()),
                fraction_free_executed=task.compute_fraction_free_trajs(
                    executed[..., :d]),
                vs_float64=dict(B=n, iterations=iters, chained_step=chained))


def mr_cell_sgpmp(cell, task, start, goal):
    """Config 4's sGPMP on a cell (one particle a problem, H = 32, 100
    iterations of K = 16): K8's MultiRobot branch vs plain on the first
    candidates (N = 131,072; the plain cost in chunks) with a lane's bits
    the same at a ragged N and at 32 lanes a block, timed; the solve with
    exactly 201 K8-MultiRobot launches and nothing else (phase_sgpmp); one
    iteration at B = 32 held to float64 (phase_sgpmp_cpu) -> the
    kernels-line numbers at 131,072."""
    import torch
    from torch_robotics_tpu_torch.ops.terms_kernel import \
        run_multirobot_cost_kernel
    cost = task.collision_residuals.collision_cost_lanes
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    check(cost.refusal is None, cell + ": the cost hook refuses: %s"
          % cost.refusal)
    N_c = MR_SG_PARAMS["num_samples"] * MR_B * MR_H
    q = capture_cost_inputs(task, *sg_problem(
        start, goal, 1, MR_H, MR_GP["dt"], SEED + 3), MR_SG_PARAMS)[N_c]
    name = "%s_candidates_N%d" % (cell, N_c)
    err = hold_cost(name, cost(q), chunked(cost.plain, q))
    same_lane_bits(name, cost, run_multirobot_cost_kernel, q)
    n_rows = 2 * len(lay.obj_pos) + len(lay.pair_a)
    out = dict(max_abs_err=err[0], rel_to_max=err[1],
               ms=device_ms(lambda: cost(q), 20),
               plain_ms=cuda_ms(lambda: chunked(cost.plain, q), iters=1,
                                warmup=1),
               work=mr_cost_work(lay, N_c, n_rows), launch=cost.params[3])
    del q
    torch.cuda.empty_cache()
    out["launches"], theta0, start_p, goal_p = phase_sgpmp(
        cell + "_sgpmp", task, start, goal, 1, MR_SG_PARAMS,
        "multirobot_cost", SEED + 3)
    phase_sgpmp_cpu(task, theta0, start_p, goal_p,
                    task_h=mr_task("cpu", *MR_CELLS[cell]),
                    name=cell + "_sgpmp_cpu", full_solve=False,
                    params=MR_SG_PARAMS, n_part=1)
    return out


def mr_cell_shape(task):
    """A cell's layout counts for its phase line."""
    lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
    return dict(members=len(lay.members), dofs=list(lay.d_list),
                rows=2 * len(lay.obj_pos) + len(lay.pair_a),
                mutual_rows=sum(len(v) for v in lay.groups.values()),
                same_member_pairs=len(lay.same_member),
                launch=task.collision_residuals.obstacle_terms_lanes
                .params[4])


def k5_fields(k5):
    """terms_entry's numbers for a phase line."""
    return dict(kernel_ms=k5["ms"], plain_ms=k5["plain_ms"],
                max_abs_err=k5["max_abs_err"],
                hinge_edge_lanes=k5["hinge_edge_lanes"],
                bound_ms=bound_ms(*k5["work"])[0],
                bound_by=bound_ms(*k5["work"])[1],
                **{k: k5[k] for k in ("vs_plain", "plain_share_of_tol_f64")
                   if k in k5})


def k8_fields(k8):
    """mr_cell_sgpmp's numbers for a phase line."""
    return dict(kernel_ms=k8["ms"], plain_ms=k8["plain_ms"],
                max_abs_err=k8["max_abs_err"], rel_to_max=k8["rel_to_max"],
                launch=k8["launch"], launches=k8["launches"],
                bound_ms=bound_ms(*k8["work"])[0],
                bound_by=bound_ms(*k8["work"])[1])


def phase_mr_same_pair():
    """Config 4 with a mutual pair between two object points of its first
    Panda (MR_CELLS): the task builds with the reference's warning and the
    generic padded assembly as its plain terms, and K5 takes the pair on
    the Panda's diagonal block; K5 vs that plain version on the path's
    first q (N = 8192) and on uniform in-limit q (where the pair's row is
    active in some lanes), Hqq off the hinge-edge lanes, timed; config 4's
    MPC on it (mr_cell_mpc: exactly 60 K5 and 60 K4, held to float64)
    -> K5's kernels-line numbers."""
    task, start, goal, draw = mr_problem(
        "cuda", task=mr_task("cuda", *MR_CELLS["mr_same_pair"]))
    terms = task.collision_residuals.obstacle_terms_lanes
    check(terms.refusal is None and len(terms.plain.layout.same_member) == 1,
          "mr_same_pair: refused (%s) or no same-member pair"
          % terms.refusal)
    q_main = mr_first_q(start, goal)
    k5 = terms_entry("mr_same_pair_first_q_N%d" % q_main.shape[1], task,
                     q_main, MR_STEPS * MR_ITERS)
    q_r = mr_in_limits_q(task, 8192, seed=61)
    k5_r = terms_entry("mr_same_pair_random_q_N8192", task, q_r, 0)
    pair_share = float((terms.plain.rows(q_r)[0][-1] > 0).float().mean())
    check(pair_share > 0, "mr_same_pair: the pair's row is never active")
    mpc = mr_cell_mpc("mr_same_pair", task, start, goal)
    emit("mr_same_pair", **mr_cell_shape(task), start_draw=draw,
         pair_row_active_share_random_q=pair_share,
         k5=k5_fields(k5), k5_random_q=k5_fields(k5_r), mpc=mpc)
    return k5


def phase_mr_net():
    """Config 4 with its first Panda carrying the learned self-collision
    net (MR_CELLS): the reference's XLA MultiRobot terms read no member's
    net and keep its pair rows, and so do K5 and K8 on the members'
    packing; K5 vs plain on the path's first q, timed; config 4's MPC
    (mr_cell_mpc) and sGPMP (mr_cell_sgpmp: exactly 201 K8-MultiRobot
    launches) on it, both held to float64 -> (K5, K8-MultiRobot)
    kernels-line numbers."""
    task, start, goal, draw = mr_problem(
        "cuda", task=mr_task("cuda", *MR_CELLS["mr_net"]))
    check(task.robot.robots[0].self_collision_net is not None,
          "mr_net: the first Panda carries no net")
    q_main = mr_first_q(start, goal)
    k5 = terms_entry("mr_net_first_q_N%d" % q_main.shape[1], task, q_main,
                     MR_STEPS * MR_ITERS)
    mpc = mr_cell_mpc("mr_net", task, start, goal)
    k8 = mr_cell_sgpmp("mr_net", task, start, goal)
    emit("mr_net", **mr_cell_shape(task), start_draw=draw, k5=k5_fields(k5),
         mpc=mpc, k8=k8_fields(k8))
    return k5, k8


def phase_mr_wide():
    """The dual-arm TIAGo (14 joints) and a Panda (MR_CELLS; d = 21, m =
    42): K5 on its route with H in shared memory (mr_terms_kernel<16>)
    vs its plain version in float64 on the card at the terms tolerance
    (terms_entry's f64, as K1 past 8 joints), Hqq off the hinge-edge
    lanes, on the path's first q, timed; config 4's MPC (mr_cell_mpc:
    exactly 60 K5 and 60 K4 at (32, 42, 42, 256), bin 48) and K4 on the
    path's first GN system vs plain (held to float64), timed beside the
    dense solve; config 4's sGPMP (mr_cell_sgpmp: exactly 201
    K8-MultiRobot launches at D = 21, three threads a lane) -> (K5, K4,
    K8-MultiRobot) kernels-line numbers."""
    import torch
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    task, start, goal, draw = mr_problem(
        "cuda", task=mr_task("cuda", *MR_CELLS["mr_wide"]))
    terms = task.collision_residuals.obstacle_terms_lanes
    check(terms.refusal is None and terms.params[4]["member_dof"] == 14,
          "mr_wide: not on K5's wide route: %s / %s"
          % (terms.refusal, terms.params[4]))
    q_main = mr_first_q(start, goal)
    expected = MR_STEPS * MR_ITERS
    k5 = terms_entry("mr_wide_first_q_N%d" % q_main.shape[1], task, q_main,
                     expected, f64=True)
    mpc = mr_cell_mpc("mr_wide", task, start, goal)
    d = start.shape[1] // 2
    b_l, D_l, U_l, _ = _lanes_gn_system(
        terms, straight_line_trajs(start, goal, MR_H), start, goal,
        GPMP2Params(**MR_GP))
    check(tuple(D_l.shape) == (MR_H, 2 * d, 2 * d, MR_B),
          "mr_wide's GN system is %s" % (tuple(D_l.shape),))
    k4 = cols_entry("mr_wide_gn_system", D_l, U_l, b_l, expected)
    del D_l, U_l, b_l
    torch.cuda.empty_cache()
    k8 = mr_cell_sgpmp("mr_wide", task, start, goal)
    emit("mr_wide", **mr_cell_shape(task), start_draw=draw, k5=k5_fields(k5),
         mpc=mpc, k4=dict(held=k4["held"], kernel_ms=k4["ms"],
                          plain_ms=k4["plain_ms"],
                          dense_solve_ms=k4["library_ms"],
                          launch=k4["launch"],
                          bound_ms=bound_ms(*k4["work"])[0]),
         k8=k8_fields(k8))
    return k5, k4, k8


def phase_mr_five():
    """Five Pandas (MR_CELLS; d = 35, m = 70, 15 block pairs on 10 warps):
    K5 vs plain on the first q of config 4's straight-line plans (N =
    8192, B = 256, H = 32) and a lane's bits the same at a ragged N,
    timed; config 4's MPC on it (mr_cell_mpc: exactly 60 K5 and 60
    launches of K4's shared-memory route at (32, 70, 70, 256), width 80,
    held to float64 on MR_FIVE_F64_B problems); config 4's sGPMP (mr_cell_sgpmp: exactly 201
    K8-MultiRobot launches at 5 members, eight threads a lane) held to
    float64 -> (K5, K8-MultiRobot) kernels-line numbers, the path's first
    GN system (D, U, b) for phase cols_wide and its K4 launches."""
    import torch
    from torch_robotics_tpu_torch.ops.btridiag_kernel import \
        cols_launch_config
    from torch_robotics_tpu_torch.solve import (GPMP2Params,
                                                straight_line_trajs)
    from torch_robotics_tpu_torch.solve.gpmp2 import _lanes_gn_system
    task, start, goal, draw = mr_problem(
        "cuda", task=mr_task("cuda", *MR_CELLS["mr_five"]))
    terms = task.collision_residuals.obstacle_terms_lanes
    launch = terms.params[4]
    check(terms.refusal is None and (launch["block_pairs"], launch["warps"])
          == (15, 10), "mr_five: %s / %s" % (terms.refusal, launch))
    q_main = mr_first_q(start, goal)
    k5 = terms_entry("mr_five_first_q_N%d" % q_main.shape[1], task, q_main,
                     MR_STEPS * MR_ITERS)
    full = terms.unscaled(q_main)
    ragged = terms.unscaled(q_main[:, :GN_RAGGED_N].contiguous())
    check(all(torch.equal(a[..., :GN_RAGGED_N], b)
              for a, b in zip(full, ragged)),
          "mr_five: a lane's bits change with the batch")
    del full, ragged
    b_l, D_l, U_l, _ = _lanes_gn_system(
        terms, straight_line_trajs(start, goal, MR_H), start, goal,
        GPMP2Params(**MR_GP))
    m = D_l.shape[1]
    check(m == 70 and cols_launch_config(m, MR_B)["route"] == "shared",
          "mr_five's GN system is %s" % (tuple(D_l.shape),))
    mpc = mr_cell_mpc("mr_five", task, start, goal, k4="btridiag_cols_wide",
                      n_f64=MR_FIVE_F64_B)
    k8 = mr_cell_sgpmp("mr_five", task, start, goal)
    emit("mr_five", **mr_cell_shape(task), start_draw=draw,
         k5=k5_fields(k5), mpc=mpc, k4_launch=cols_launch_config(m, MR_B),
         k8=k8_fields(k8))
    return k5, k8, (D_l, U_l, b_l), mpc["launches"]["btridiag_cols_wide"]


def random_wide_system(H_: int, m: int, B_: int, seed: int):
    """A random SPD block-tridiagonal system (D, U, b) on the card at a
    wide m: D >= 3 I and |U| about 1 (random_system's U would not stay
    positive definite past m ~ 40), as tests/test_torch_cols_wide.py
    builds them."""
    import torch
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B_, H_, m, m)) * 0.3 / np.sqrt(m / 14)
    D = np.transpose(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(m),
                     (1, 2, 3, 0))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                            device="cuda")
            for a in (D, rng.normal(size=(H_, m, m, 1)) * (0.5 / np.sqrt(m)),
                      rng.normal(size=(H_, m, B_)))]


def ptxas_lines(text: str, names: dict) -> dict:
    """nvcc's -Xptxas -v report for the kernels whose mangled names hold a
    fragment of ``names`` -> {label: "registers | stack and spill"}."""
    report = {}
    lines = text.splitlines()
    for i, line in enumerate(lines):
        for name, label in names.items():
            if "Compiling entry function '_ZN" in line and name in line:
                report[label] = " | ".join(
                    s.strip().split("info    : ")[-1]
                    for s in lines[i + 1:i + 4])
    return report


def phase_cols_wide(D_g, U_g, b_g, launches):
    """K4's shared-memory route (csrc/btridiag_cols_wide.cu, m 65..128):
    on phase mr_five's first GN system (32, 70, 70, 256) vs plain, held
    to float64 (hold_solve's GN rule), timed over a CUDA graph beside its
    bound and the dense solve (cols_entry), and at B = 64 and 132 (its
    first lanes: one lane an SM, the lane's chain alone) and 1024 (tiled:
    waves) beside 256; on random SPD systems at m = 96, 112 and 128 (H =
    32, B = 64) vs plain, held to float64 (the random rule), timed, each
    beside its bound and the dense solve; a lane's x the same bits in
    every wider width; ptxas' registers of its four instantiations, none
    with a stack frame or a spill; at m = 40 (config 4's random system)
    solve_lanes_auto takes the register route (exactly one btridiag_cols
    launch, torch.equal to solve_lanes_cols), and the new route in width
    80 (another order of the same solve) is held to float64 beside it and
    timed; m = 129 is refused in K4's words -> the kernels-line numbers
    of the GN system."""
    import torch
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk
    from torch_robotics_tpu_torch.ops.cuda_build import build_all
    from torch_robotics_tpu_torch.solve.btridiag_lanes import (
        solve_lanes_core)
    gn = cols_entry("mr_five_gn_system", D_g, U_g, b_g, launches)
    by_batch = {MR_B: gn["ms"]}
    for n in CW_BATCHES:
        idx = torch.arange(n, device="cuda") % MR_B
        D_n, b_n = D_g[..., idx].contiguous(), b_g[..., idx].contiguous()
        by_batch[n] = device_ms(
            lambda: bk.solve_lanes_cols_wide(D_n, U_g, b_n), iters=5)
        del D_n, b_n
        torch.cuda.empty_cache()
    cases = {}
    for i, m in enumerate(CW_M):
        D, U, b = random_wide_system(MR_H, m, CW_B, seed=SEED + 70 + i)
        e = cols_entry("cols_wide_random_m%d" % m, D, U, b, 0, random=True)
        x = bk.solve_lanes_cols_wide(D, U, b)
        same = {w: bool(torch.equal(bk._launch_cols_wide(D, U, b, w), x))
                for w in bk._COLS_WIDE_WIDTHS if w > e["launch"]["width"]}
        check(all(same.values()), "cols_wide m = %d: a lane's bits change "
              "with the width: %s" % (m, same))
        b_ms, b_by = bound_ms(*e["work"])
        cases["m%d" % m] = dict(
            held=e["held"], kernel_ms=e["ms"], plain_ms=e["plain_ms"],
            dense_solve_ms=e["library_ms"], launch=e["launch"],
            bound_ms=b_ms, bound_by=b_by, same_bits_wider=same)
        del D, U, b, x
        torch.cuda.empty_cache()
    # today's register route at m = 40, and the new route beside it
    D, U, b = random_system(MR_H, 40, MR_B, seed=SEED + 40)
    x_reg = bk.solve_lanes_cols(D, U, b)
    x_auto, auto_launches, _ = counted(lambda: bk.solve_lanes_auto(D, U, b))
    check(auto_launches == {"btridiag_cols": 1}
          and torch.equal(x_auto, x_reg),
          "cols_wide: m = 40 left the register route: %s" % auto_launches)
    x_w = bk._launch_cols_wide(D, U, b, 80)
    x_64 = solve_lanes_core(D.double(), U.double(), b.double())
    m40 = dict(wide=hold_solve("cols_wide_m40", x_w,
                               solve_lanes_core(D, U, b), x_64, random=True),
               register_vs_f64=max_errs([x_reg.double()], [x_64])[1],
               register_ms=device_ms(lambda: bk.solve_lanes_cols(D, U, b),
                                     iters=10),
               wide_ms=device_ms(lambda: bk._launch_cols_wide(D, U, b, 80),
                                 iters=5))
    del D, U, b, x_reg, x_auto, x_w, x_64
    words = ""
    try:
        bk.solve_lanes_auto(*(torch.zeros(s, device="cuda") for s in (
            (2, 129, 129, 4), (2, 129, 129, 1), (2, 129, 4))))
    except NotImplementedError as e:
        words = str(e)
    check("m <= 128" in words, "cols_wide: m = 129 not refused in K4's "
          "words: %r" % words)
    names = {"25btridiag_cols_wide_kernelILi%dE" % w:
             "btridiag_cols_wide_kernel<%d>" % w
             for w in bk._COLS_WIDE_WIDTHS}
    ptxas = ptxas_lines(build_all([bk.COLS_WIDE_KERNEL])[
        "btridiag_cols_wide.cu"], names)
    for label in names.values():
        check("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads" in ptxas.get(label, ""), "%s: ptxas reports a stack "
              "frame, a spill or no line: %r" % (label, ptxas.get(label)))
    b_ms, b_by = bound_ms(*gn["work"])
    emit("cols_wide", gn_system=dict(
        shape=list(D_g.shape), held=gn["held"], kernel_ms=gn["ms"],
        plain_ms=gn["plain_ms"], dense_solve_ms=gn["library_ms"],
        launch=gn["launch"], launches=launches, bound_ms=b_ms,
        bound_by=b_by, kernel_ms_by_batch=by_batch), random=cases, m40=m40,
         refusal_m129=words, ptxas=ptxas)
    return gn


# five Pandas' float64 hold (step_vs_f64) on this many problems.  At m =
# 70 the worst of 16 lanes is one ill-conditioned lane, decided by which
# float32 order rounds it worse: the card's 2.317e-4 of max|theta|
# against the CPU float32 run's 1.338e-4 (limit 2.78e-4; an earlier design
# of K4's route read 1.98e-4 against 8.95e-5 and failed), medians 3.95e-5
# against 5.18e-5; at 64 and 256 lanes the card's worst lane is 1.02x and
# 0.80x the CPU's (chip_cols_wide_f64.py; PERF.md, PR 25)
MR_FIVE_F64_B = 64
# K4's shared-memory route on random SPD systems: its widths past 80, at
# this batch (phase mr_five's GN system takes width 80)
CW_M, CW_B = (96, 112, 128), 64
# phase cols_wide times the route on phase mr_five's GN system at these
# batches beside its own 256: one lane an SM, and four waves
CW_BATCHES = (64, 132, 1024)
# the harness on the main path's plans: a lane whose frozen flag or
# contacts differ between the card and the float64 run (a configuration
# on the check's margin, decided apart by two roundings) is counted, at
# most EX_FLIP_SHARE of the lanes; on the others q and qd are held to
# EX_TOL of max|q| and max|qd| (256 PD substeps in float32)
EX_FLIP_SHARE, EX_TOL = 0.01, 1e-4


def phase_execute(plans):
    """The PD execution harness on phase main's final plans (B = 1024, H
    = 64, [q, qd] states): MotionPlanningController on the card (no
    kernel launched: the contact check is plain PyTorch), timed by CUDA
    events over the call (host-bound: H collision checks and 4 H PD
    substeps), against a float64 CPU run of the same harness on the same
    plans: lanes whose frozen flags or contacts differ are counted, and on
    the others q and qd are held to EX_TOL -> the phase line."""
    import torch
    from torch_robotics_tpu_torch.sim import MotionPlanningController
    ctrl = MotionPlanningController(bench_problem("cuda", 1)[0])
    ctrl.run_trajectories(plans)                      # warm-up
    (res, n_free), launches, ms = counted(lambda: ctrl.run_trajectories(
        plans))
    check(not launches, "execute: the harness launched %s" % launches)
    check(all(bool(torch.isfinite(t).all()) for t in (
        res.q, res.qd, res.tracking_error)), "execute: non-finite states")
    t0 = time.perf_counter()
    res_h, n_free_h = MotionPlanningController(
        bench_problem("cpu", 1)[0]).run_trajectories(plans.cpu().double())
    cpu_s = time.perf_counter() - t0
    differ = ((res.frozen.cpu() != res_h.frozen)
              | (res.contact.cpu() != res_h.contact).any(-1))
    n_differ = int(differ.sum())
    check(n_differ <= EX_FLIP_SHARE * plans.shape[0],
          "execute: %d of %d lanes freeze apart from float64"
          % (n_differ, plans.shape[0]))
    keep = ~differ
    gaps = {}
    for name in ("q", "qd"):
        got, ref = getattr(res, name).cpu()[keep], getattr(res_h, name)[keep]
        gaps[name] = float((got.double() - ref).abs().max()
                           / ref.abs().max())
        check(gaps[name] <= EX_TOL, "execute: %s off float64 by %.3g of "
              "its max" % (name, gaps[name]))
    emit("execute", B=plans.shape[0], H=plans.shape[1], ms=ms,
         n_free=n_free, n_free_f64=n_free_h,
         contacts=int(res.contact.sum()), lanes_frozen=int(res.frozen.sum()),
         lanes_differing_from_f64=n_differ, rel_to_max_vs_f64=gaps,
         mean_tracking_error=float(res.tracking_error.mean()),
         cpu_f64_s=cpu_s)


def phase_examples():
    """The examples that drive the solvers (torch_robotics_tpu_torch/
    examples/), each main() on the card at its own size, its printing
    sent to stderr: mpc_panda (B = 32, 60 steps: exactly 120 K1 and 120
    K2 launches, then the PD harness), ilqr_panda (B = 64, 30 iterations,
    --track's 40 steps), multi_robot_mpc (B = 16, 150 steps: exactly 300
    K5 and 300 K4 launches) and planning_point_mass (EnvDense2D's
    preset); every number each returns finite -> wall seconds, launches
    and numbers of each."""
    import contextlib
    import math
    from torch_robotics_tpu_torch.examples import (ilqr_panda, mpc_panda,
                                                   multi_robot_mpc,
                                                   planning_point_mass)
    out = {}
    for name, fn in (("mpc_panda", mpc_panda.main),
                     ("ilqr_panda", lambda: ilqr_panda.main(track=True)),
                     ("multi_robot_mpc", multi_robot_mpc.main),
                     ("planning_point_mass", planning_point_mass.main)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res, launches, _ = counted(fn)
        wall = time.perf_counter() - t0
        check(all(math.isfinite(v) for v in res.values()),
              "examples: %s returned %s" % (name, res))
        out[name] = dict(wall_s=wall, launches=launches, **res)
    for name, want in (("mpc_panda", {"terms": 120, "btridiag_w": 120}),
                       ("multi_robot_mpc", {"multirobot_terms": 300,
                                            "btridiag_cols": 300})):
        check(out[name]["launches"] == want, "examples: %s launched %s, "
              "expected %s" % (name, out[name]["launches"], want))
    emit("examples", **out)

# ----------------------------------------------------------------------
# CHOMP's autodiff branch, the SE(3) / manifold layer and serialization
# ----------------------------------------------------------------------
def phase_chomp_autodiff(ch_cpu):
    """CHOMP through autograd of the residuals: the planar 2-link arm at
    B = 1024, H = 32 (exactly CA_ITERS K2 launches a solve at m = 4, the
    trace falls, held to float64), then phase chomp's Panda problem through
    the hooks (K1, K8, K2) and through the plain residuals (K2 alone), each
    held to phase chomp's float64 CPU run by its own float32 CPU run
    (``ch_cpu``: phase chomp's "hook", "autodiff" and "f64" trajectories of
    the first CH_F64_B problems)."""
    import dataclasses

    import torch
    from torch_robotics_tpu_torch.solve import CHOMPParams, chomp_solve
    out = {}
    # the planar arm: no lanes hooks, so autodiff through its residuals
    task, _, start, goal, theta0 = p2_problem("cuda")
    res_fn = task.collision_residuals
    check(res_fn.obstacle_terms_lanes is None
          and res_fn.collision_cost_lanes is None,
          "chomp_autodiff: the planar arm's task has lanes hooks")
    params = CHOMPParams(**CA_P2)
    chomp_solve(res_fn, theta0, start, goal,
                dataclasses.replace(params, opt_iters=2))     # warm-up
    res, launches, ms = counted(
        lambda: chomp_solve(res_fn, theta0, start, goal, params))
    check(launches == {"btridiag_w": CA_ITERS},
          "chomp_autodiff planar2link launches %s, expected %d of "
          "btridiag_w only" % (launches, CA_ITERS))
    check(all(bool(torch.isfinite(t).all()) for t in res),
          "chomp_autodiff planar2link: non-finite results")
    first, last = float(res.cost_trace[0]), float(res.cost_trace[-1])
    check(last < first, "chomp_autodiff planar2link: the trace did not "
          "fall (%.9g -> %.9g)" % (first, last))
    busy, dev_ms, top = profile_device(lambda: chomp_solve(
        res_fn, theta0, start, goal,
        dataclasses.replace(params, opt_iters=5)), 5)
    n = P2_F64_B
    task_h, _, s_h, g_h, _ = p2_problem("cpu", n)
    th_h = theta0[:n].cpu()
    r_h = chomp_solve(task_h.collision_residuals, th_h, s_h, g_h,
                      params).trajs
    r_64 = chomp_solve(task_h.collision_residuals, th_h.double(),
                       s_h.double(), g_h.double(), params).trajs
    gaps = theta_gaps(res.trajs[:n], r_h, r_64)
    hold_to_f64("chomp_autodiff planar2link", gaps)
    limits = f64_limits(gaps)
    ctl = chomp_solve(res_fn, theta0[:n], start, goal, dataclasses.replace(
        params, sigma_coll=CH_CONTROL_SIGMA)).trajs
    ctl_gaps = theta_gaps(ctl, r_h, r_64)
    for stat, limit in limits.items():
        check(ctl_gaps["card" + stat] >= CH_CONTROL_MARGIN * limit,
              "chomp_autodiff planar2link: the zero-gradient control is "
              "off float64 by %.3g (theta%s), within %g x the hold's limit "
              "%.3g" % (ctl_gaps["card" + stat], stat, CH_CONTROL_MARGIN,
                        limit))
    out["planar2link"] = dict(
        B=P2_B, H=CA_P2["n_support_points"], m=4, iterations=CA_ITERS,
        params=dataclasses.asdict(params), launches=launches, solve_ms=ms,
        ms_per_iteration=ms / CA_ITERS, cost_trace_first_last=[first, last],
        fraction_free=task.compute_fraction_free_trajs(res.trajs),
        vs_float64=dict(B=n, **gaps), vs_float64_limits=limits,
        zero_gradient_control_vs_float64={
            k: ctl_gaps["card" + k] for k in limits},
        profiled_device_busy_share=busy,
        profiled_device_ms_per_iteration=dev_ms,
        top_device_ms_per_iteration=top)
    del task, res, ctl

    # the Panda: the hooks and the plain residuals on phase chomp's inputs
    task, start, goal = bench_problem("cuda", CH_B)
    params = CHOMPParams(n_support_points=H, opt_iters=CH_ITERS)
    theta0 = chomp_theta0(start, goal)
    n = CH_F64_B
    trajs = {}
    for name, fn, expected in (
            ("hook", task.collision_residuals,
             {"terms": CH_ITERS, "cost": CH_ITERS, "btridiag_w": CH_ITERS}),
            ("autodiff", plain_residuals(task),
             {"btridiag_w": CH_ITERS})):
        chomp_solve(fn, theta0, start, goal,
                    dataclasses.replace(params, opt_iters=2))  # warm-up
        res, launches, ms = counted(
            lambda: chomp_solve(fn, theta0, start, goal, params))
        check(launches == expected, "chomp_autodiff panda %s launches %s, "
              "expected %s" % (name, launches, expected))
        check(all(bool(torch.isfinite(t).all()) for t in res),
              "chomp_autodiff panda %s: non-finite results" % name)
        first, last = float(res.cost_trace[0]), float(res.cost_trace[-1])
        check(last < first, "chomp_autodiff panda %s: the trace did not "
              "fall (%.9g -> %.9g)" % (name, first, last))
        gaps = theta_gaps(res.trajs[:n], ch_cpu[name], ch_cpu["f64"])
        hold_to_f64("chomp_autodiff panda %s" % name, gaps)
        busy, dev_ms, top = profile_device(lambda: chomp_solve(
            fn, theta0, start, goal,
            dataclasses.replace(params, opt_iters=5)), 5)
        trajs[name] = res.trajs
        out["panda_" + name] = dict(
            launches=launches, solve_ms=ms, ms_per_iteration=ms / CH_ITERS,
            cost_trace_first_last=[first, last],
            vs_float64=dict(B=n, **gaps), vs_float64_limits=f64_limits(gaps),
            profiled_device_busy_share=busy,
            profiled_device_ms_per_iteration=dev_ms,
            top_device_ms_per_iteration=top)
    scale = float(trajs["hook"].abs().max())
    emit("chomp_autodiff", **out, panda=dict(
        B=CH_B, H=H, iterations=CH_ITERS,
        autodiff_vs_hook_rel_to_max=float(
            (trajs["autodiff"] - trajs["hook"]).abs().max()) / scale))


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|, on the CPU in float64."""
    ref = ref.double().cpu()
    return float((got.double().cpu() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-300))


def hold_rel(name: str, card, cpu32, ref) -> dict:
    """The card result off the float64 one by at most twice the CPU float32
    run's error plus SE_FLOOR (relative to max|ref|) -> the two errors."""
    card_err, cpu_err = rel_err(card, ref), rel_err(cpu32, ref)
    check(card_err <= 2.0 * cpu_err + SE_FLOOR,
          "se3_manifold %s: card off float64 by %.3g of max|ref|, CPU "
          "float32 by %.3g" % (name, card_err, cpu_err))
    return dict(card_vs_f64=card_err, cpu_vs_f64=cpu_err)


def s3_r3_batch(B_: int, H_: int, seed: int):
    """(B, H, 7) trajectories of S^3 x R^3 drawn on the CPU in float64: a
    rotation about a random axis by a jittered ramp, and a random walk."""
    import torch
    from torch_robotics_tpu_torch.core import q_exp_map
    gen = torch.Generator().manual_seed(seed)
    axis = torch.randn((B_, 1, 3), generator=gen, dtype=torch.float64)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    ang = (torch.linspace(0.0, 1.2, H_, dtype=torch.float64)[None, :, None]
           + 0.05 * torch.randn((B_, H_, 1), generator=gen,
                                dtype=torch.float64))
    walk = torch.cumsum(0.02 * torch.randn((B_, H_, 3), generator=gen,
                                           dtype=torch.float64), dim=1)
    return torch.cat([q_exp_map(ang * axis), walk], dim=-1)


def phase_se3_manifold():
    """The SE(3) / manifold layer on the card against CPU float64 runs
    (hold_rel): ee_se3_cost of the Panda's fk_all_links link tensors at
    SE_N configurations; the quaternion log / exp / transport between
    consecutive points of an S^3 x R^3 batch (SE_TRAJ trajectories), its
    velocity and smoothing; the Karcher mean of its points; SE_N samples
    of a Gaussian at that mean from a CUDA generator, finite, on the card
    and on S^3 to SE_UNIT; the ms of each."""
    import torch
    from torch_robotics_tpu_torch.core import (pack_homogeneous,
                                               q_exp_map, q_log_map,
                                               q_parallel_transport, z_rot)
    from torch_robotics_tpu_torch.core.manifold import Gaussian, Manifold
    from torch_robotics_tpu_torch.costs import ee_se3_cost
    from torch_robotics_tpu_torch.kin import fk_all_links, robot_zoo
    from torch_robotics_tpu_torch.trajectory.manifold_ops import (
        compute_traj_velocity, smooth_traj)
    out = {}
    # ee_se3_cost of the link poses against a target pose
    model, model_h = (robot_zoo.franka_panda(device="cuda"),
                      robot_zoo.franka_panda(device="cpu"))
    gen = torch.Generator().manual_seed(SEED + 61)
    lo = torch.as_tensor(model_h.q_lower, dtype=torch.float64)
    hi = torch.as_tensor(model_h.q_upper, dtype=torch.float64)
    q64 = lo + (hi - lo) * torch.rand((SE_N, 7), generator=gen,
                                      dtype=torch.float64)
    q_h = q64.float()
    q = q_h.cuda()
    target64 = pack_homogeneous(z_rot(torch.tensor(0.3, dtype=torch.float64)),
                                torch.tensor([0.4, 0.1, 0.5],
                                             dtype=torch.float64))
    target = target64.float().cuda()

    def ee():
        return ee_se3_cost(fk_all_links(model, q), target)
    card = ee()
    check(tuple(card.shape) == (SE_N,) and bool(torch.isfinite(card).all()),
          "se3_manifold: ee_se3_cost is not finite of shape (%d,)" % SE_N)
    out["ee_se3_cost"] = dict(
        N=SE_N, ms=cuda_ms(ee, iters=10), **hold_rel(
            "ee_se3_cost", card,
            ee_se3_cost(fk_all_links(model_h, q_h), target64.float()),
            ee_se3_cost(fk_all_links(model_h, q64), target64)))

    # the quaternion maps and the trajectory operations on S^3 x R^3
    M = Manifold.sphere_S3().cartesian_product(Manifold.euclidean(3))
    t64 = s3_r3_batch(*SE_TRAJ, SEED + 62)
    t_h = t64.float()
    traj = t_h.cuda()

    def maps(t):
        g, h = t[:, :-1, :4], t[:, 1:, :4]
        v = q_log_map(h, base=g)
        return (v, q_exp_map(v, base=g), q_parallel_transport(v, g, h))
    got, cpu32, ref = maps(traj), maps(t_h), maps(t64)
    for i, name in enumerate(("q_log_map", "q_exp_map",
                              "q_parallel_transport")):
        out[name] = hold_rel(name, got[i], cpu32[i], ref[i])
    out["quaternion_maps_ms"] = cuda_ms(lambda: maps(traj), iters=10)
    for name, fn in (
            ("compute_traj_velocity",
             lambda t: compute_traj_velocity(t, SE_DT, M)),
            ("smooth_traj", lambda t: smooth_traj(t, M))):
        card = fn(traj)
        check(bool(torch.isfinite(card).all()),
              "se3_manifold: %s is not finite" % name)
        out[name] = dict(ms=cuda_ms(lambda: fn(traj), iters=3, warmup=1),
                         **hold_rel(name, card, fn(t_h), fn(t64)))

    # the Karcher mean of the batch's points and a Gaussian at it
    pts = traj.reshape(-1, 7)
    mu = M.mean(pts)
    out["karcher_mean"] = dict(
        points=pts.shape[0], ms=cuda_ms(lambda: M.mean(pts), iters=3,
                                        warmup=1),
        **hold_rel("karcher_mean", mu, M.mean(t_h.reshape(-1, 7)),
                   M.mean(t64.reshape(-1, 7))))
    A = torch.randn((6, 6), generator=torch.Generator().manual_seed(
        SEED + 63))
    cov = (A @ A.T / 6 + 0.01 * torch.eye(6)) * 0.05
    gauss = Gaussian(M, mu, cov.cuda())
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 64)
    smp = gauss.sample(SE_N, generator=cuda_gen)
    unit = float((torch.linalg.vector_norm(smp[:, :4], dim=-1) - 1.0)
                 .abs().max())
    check(smp.is_cuda and tuple(smp.shape) == (SE_N, 7)
          and bool(torch.isfinite(smp).all()),
          "se3_manifold: Gaussian samples not finite (SE_N, 7) on the card")
    check(unit <= SE_UNIT, "se3_manifold: samples off S^3 by %.3g" % unit)
    out["gaussian_sample"] = dict(
        n=SE_N, max_unit_norm_error=unit,
        ms=cuda_ms(lambda: gauss.sample(SE_N, generator=cuda_gen), iters=10))
    emit("se3_manifold", traj_batch=list(SE_TRAJ) + [7],
         worst_rel_err=max(v["card_vs_f64"] for v in out.values()
                           if isinstance(v, dict) and "card_vs_f64" in v),
         **out)


def trace_names(logdir) -> tuple:
    """(every event name, the kernel events' names) of the Chrome trace
    that utils.profiling.trace_to wrote into logdir."""
    files = list(Path(logdir).glob("*.json"))
    check(len(files) == 1, "serialize: %d traces written, expected 1"
          % len(files))
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    return ({e.get("name", "") for e in events},
            {e.get("name", "") for e in events if e.get("cat") == "kernel"})


def phase_serialize():
    """The grid scene's artifacts through utils.serialization: EnvSpheres3D
    precomputed at SER_CELL and the Panda's KinematicModel saved to .npz in
    a temporary directory and loaded onto the card; a task built from the
    loaded grid and model gives K1's grid branch bit for bit against the
    original task's at SER_N lanes, one launch, run under
    utils.profiling.trace_to with an annotate span around it, both of
    which the written trace must hold; the files' bytes and the load ms."""
    import dataclasses
    import tempfile

    import torch
    from torch_robotics_tpu_torch.envs import EnvSpheres3D
    from torch_robotics_tpu_torch.robots import RobotPanda
    from torch_robotics_tpu_torch.tasks import PlanningTask
    from torch_robotics_tpu_torch.utils.profiling import annotate, trace_to
    from torch_robotics_tpu_torch.utils.serialization import (
        load_grid_sdf, load_kinematic_model, save_grid_sdf,
        save_kinematic_model)
    env = EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=SER_CELL,
                       device="cuda")
    robot = RobotPanda.create(device="cuda")
    task = PlanningTask(env=env, robot=robot,
                        obstacle_cutoff_margin=GRID_CUTOFF)
    q = random_q(task, SER_N, seed=65)
    ref = task.collision_residuals.obstacle_terms_lanes.unscaled(q)
    span = "serialize/k1_grid"
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"grid": Path(tmp) / "grid.npz",
                 "model": Path(tmp) / "panda.npz"}
        t0 = time.perf_counter()
        save_grid_sdf(paths["grid"], env.grid_map_sdf_obj_fixed)
        save_kinematic_model(paths["model"], robot.model)
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = load_grid_sdf(paths["grid"], device="cuda")
        model = load_kinematic_model(paths["model"], device="cuda")
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        env2 = EnvSpheres3D(device="cuda")
        env2.grid_map_sdf_obj_fixed = grid
        task2 = PlanningTask(env=env2,
                             robot=dataclasses.replace(robot, model=model),
                             obstacle_cutoff_margin=GRID_CUTOFF)
        terms = task2.collision_residuals.obstacle_terms_lanes
        check(terms.grid is not None,
              "serialize: the loaded task's terms have no grid table")
        terms.unscaled(q)                                      # warm-up

        def annotated():
            with annotate(span):
                return terms.unscaled(q)
        # a profiler session can miss a kernel (profile_device): take the
        # trace again, up to SER_TRACES times, until it holds K1
        for attempt in range(1, SER_TRACES + 1):
            logdir = Path(tmp) / ("trace%d" % attempt)
            with trace_to(logdir):
                got, launches, ms = counted(annotated)
            names, kernels = trace_names(logdir)
            k1 = sorted(k for k in kernels if "terms_kernel" in k)
            if k1:
                break
        sizes = {k: p.stat().st_size for k, p in paths.items()}
    check(launches == {"terms": 1}, "serialize: launches %s, expected one "
          "K1" % (launches,))
    same = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    check(all(same), "serialize: K1 on the loaded task differs from the "
          "original task's (g, Hqq, cost equal: %s)" % same)
    check(span in names, "serialize: the trace has no %r span" % span)
    check(bool(k1), "serialize: %d traces hold no K1 kernel event "
          "(kernels: %s)" % (SER_TRACES, sorted(kernels)[:8]))
    emit("serialize", cell=SER_CELL, grid_cells=grid.n_cells, N=SER_N,
         file_bytes=sizes, save_s=save_s, load_ms=load_ms,
         k1_launches=launches, k1_call_ms=ms, bit_equal=same,
         trace_span=span, trace_kernels=k1, trace_attempts=attempt)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "GPU port and needs a CUDA card")
    try:
        import torch_robotics_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("run from the root of a checkout: %s" % e)
    chomp_cpu = start_chomp_cpu()
    smi = phase_build()
    chomp_cpu[1].poll(None)     # no timed phase shares the host with it
    phase_serialize()           # the first profiler session of the script
    terms = phase_terms()
    solve = phase_solve()
    launches, main_plans = phase_main()
    phase_cpu()
    phase_fk()
    ee_terms, ee_solve = phase_ee_goal()
    phase_ik()

    il_task, il_start, il_goal = ilqr_problem("cuda")
    seen = capture_first_iteration(il_task, il_start, il_goal)
    mpc_seen = capture_mpc_first(il_task, il_start, il_goal)
    sweeps = phase_riccati(seen, mpc_seen)
    cost = phase_cost(il_task, seen, il_start, il_goal)
    il_launches, il_res = phase_ilqr(il_task, il_start, il_goal)
    phase_ilqr_cpu(il_task, il_start, il_goal)
    roll_mpc = phase_ilqr_mpc(il_task, il_start, il_goal, il_res.trajs,
                              mpc_seen["roll"], sweeps["rollout_mpc_err"])

    mr, mr_start, mr_goal, draw = mr_problem("cuda")
    mr_terms = phase_mr_terms(mr, mr_start, mr_goal)
    mr_solve = phase_mr_solve(mr, mr_start, mr_goal)
    mr_launches = phase_mr_mpc(mr, mr_start, mr_goal, draw)
    phase_mr_cpu(mr_start, mr_goal)

    pm = pm_problem("cuda")
    phase_pm_solve(*pm)
    phase_pm_restarts(*pm)
    ru = ru_problem()
    factor, subst = phase_k9(pm, ru)
    k9_launches = phase_reuse(ru)
    cloud = phase_point_cloud()

    sg_launches, sg_theta0, sg_start, sg_goal = phase_sgpmp(
        "sgpmp", il_task, il_start, il_goal, SG_PART, SG_PARAMS, "cost",
        SEED + 2)
    phase_sgpmp_cpu(il_task, sg_theta0, sg_start, sg_goal)
    mr_cost = phase_mr_cost(mr, capture_cost_inputs(
        mr, *sg_problem(mr_start, mr_goal, 1, MR_H, MR_GP["dt"], SEED + 3),
        MR_SG_PARAMS))
    mr_sg_launches = phase_sgpmp("mr_sgpmp", mr, mr_start, mr_goal, 1,
                                 MR_SG_PARAMS, "multirobot_cost", SEED + 3)[0]
    solvers = phase_solvers(*bench_problem("cuda", B))
    net_terms = phase_net_terms()
    net_cost = phase_net_cost(il_start, il_goal)
    net_launches = phase_net_main()

    grid_task, grid_theta0, _, _, genv, grid_k1 = phase_grid_main()
    grid_terms = phase_grid_terms(grid_task, grid_theta0)
    grid_cost, grid_cost_launches = phase_grid_cost(genv, il_start, il_goal)
    mr_grid_k5, mr_grid_k8 = phase_mr_grid(genv, mr_start, mr_goal)

    grasp_terms = phase_grasp_terms(genv)
    del genv, grid_task, grid_theta0
    grasp_k1 = phase_grasp_main()
    grasp_cost, grasp_cost_launches = phase_grasp_cost(il_start, il_goal)
    mr_grasp_k5, mr_grasp_k8 = phase_mr_grasp()

    hy_k2 = phase_hybrid()
    ch_k1, ch_k8, ch_k2, ch_cpu = phase_chomp(chomp_cpu)
    pod_k1_c, pod_k2_c, pod_k1, pod_k2 = phase_pod()
    mp_k2 = phase_mpot()
    p2_k2 = phase_planar2link()
    phase_zoo_fk()
    wide = phase_wide_terms()
    tg_k1, tg_k4 = phase_tiago_mpc()
    tg_k8 = phase_tiago_sgpmp()
    sp_k5 = phase_mr_same_pair()
    net_k5, net_k8 = phase_mr_net()
    wd_k5, wd_k4, wd_k8 = phase_mr_wide()
    fv_k5, fv_k8, fv_system, fv_k4_launches = phase_mr_five()
    fv_k4 = phase_cols_wide(*fv_system, fv_k4_launches)
    del fv_system
    phase_execute(main_plans)
    del main_plans
    phase_examples()
    phase_chomp_autodiff(ch_cpu)
    phase_se3_manifold()

    entries = []
    for name, src, rep, res, n in (
            ("obstacle_terms", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", terms,
             launches[0]),
            ("btridiag_w", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", solve,
             launches[1]),
            ("obstacle_terms_ee_goal", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", ee_terms,
             ee_terms["launches"]),
            ("btridiag_w_ee_goal", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", ee_solve,
             ee_solve["launches"]),
            ("riccati_backward", "torch_robotics_tpu_torch/csrc/riccati.cu",
             "torch_robotics_tpu/ops/pallas_riccati.py:206",
             sweeps["riccati"], il_launches[0]),
            ("linesearch_rollout", "torch_robotics_tpu_torch/csrc/riccati.cu",
             "torch_robotics_tpu/ops/pallas_riccati.py:309",
             sweeps["rollout"], il_launches[1]),
            ("linesearch_rollout_tracking",
             "torch_robotics_tpu_torch/csrc/riccati.cu",
             "torch_robotics_tpu/ops/pallas_riccati.py:309", roll_mpc,
             roll_mpc["launches"]),
            ("collision_cost", "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029",
             cost["line_search"], il_launches[2]),
            ("collision_cost_sgpmp", "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", cost["sgpmp"],
             sg_launches),
            ("multirobot_terms", "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", mr_terms,
             mr_launches[0]),
            ("btridiag_cols", "torch_robotics_tpu_torch/csrc/btridiag_cols.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:583", mr_solve,
             mr_launches[1]),
            ("btridiag_factor", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:374", factor,
             k9_launches["btridiag_factor"]),
            ("btridiag_subst", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:423", subst,
             k9_launches["btridiag_subst"]),
            ("sphere_sdf", "torch_robotics_tpu_torch/csrc/sphere_sdf.cu",
             "torch_robotics_tpu/ops/pallas_sdf.py:75", cloud,
             cloud["launches"]),
            ("collision_cost_multirobot",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029",
             mr_cost["candidates"], mr_sg_launches),
            ("collision_cost_multirobot_acceptance",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029",
             mr_cost["acceptance"], mr_sg_launches),
            ("btridiag_sweep_trsm",
             "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:689",
             solvers["sweep_trsm"], solvers["sweep_trsm"]["launches"]),
            ("btridiag_sweep_trsv",
             "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:689",
             solvers["sweep_trsv"], solvers["sweep_trsv"]["launches"]),
            ("btridiag_cr", "torch_robotics_tpu_torch/csrc/btridiag_cr.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:900", solvers["cr"],
             solvers["cr"]["launches"]),
            ("gn_assembly", "torch_robotics_tpu_torch/csrc/gn_assembly.cu",
             "torch_robotics_tpu/ops/pallas_gn_assembly.py:85",
             solvers["gn_assembly"], solvers["gn_assembly"]["launches"]),
            ("net_terms", "torch_robotics_tpu_torch/csrc/net_row.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", net_terms,
             net_launches),
            ("net_cost", "torch_robotics_tpu_torch/csrc/net_row.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", net_cost,
             net_cost["launches"]),
            ("obstacle_terms_grid", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", grid_terms,
             grid_k1),
            ("collision_cost_grid", "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", grid_cost,
             grid_cost_launches),
            ("multirobot_terms_grid",
             "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", mr_grid_k5,
             mr_grid_k5["launches"]),
            ("collision_cost_multirobot_grid",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", mr_grid_k8,
             mr_grid_k8["launches"]),
            ("obstacle_terms_grasped",
             "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", grasp_terms,
             grasp_k1),
            ("collision_cost_grasped", "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", grasp_cost,
             grasp_cost_launches),
            ("multirobot_terms_grasped",
             "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", mr_grasp_k5,
             mr_grasp_k5["launches"]),
            ("collision_cost_multirobot_grasped",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", mr_grasp_k8,
             mr_grasp_k8["launches"]),
            ("btridiag_w_hybrid", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", hy_k2,
             hy_k2["launches"]),
            ("obstacle_terms_chomp", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", ch_k1,
             ch_k1["launches"]),
            ("collision_cost_chomp", "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", ch_k8,
             ch_k8["launches"]),
            ("btridiag_w_chomp", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", ch_k2,
             ch_k2["launches"]),
            ("obstacle_terms_pod", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", pod_k1_c,
             pod_k1_c["launches"]),
            ("btridiag_w_pod", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", pod_k2_c,
             pod_k2_c["launches"]),
            ("obstacle_terms_pod_unchunked",
             "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", pod_k1,
             pod_k1["launches"]),
            ("btridiag_w_pod_unchunked",
             "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", pod_k2,
             pod_k2["launches"]),
            ("btridiag_w_mpot", "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", mp_k2,
             mp_k2["launches"]),
            ("btridiag_w_planar2link",
             "torch_robotics_tpu_torch/csrc/btridiag.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:330", p2_k2,
             p2_k2["launches"]),
            ("obstacle_terms_tiago", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", tg_k1,
             tg_k1["launches"]),
            ("obstacle_terms_shadow", "torch_robotics_tpu_torch/csrc/terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", wide["d24"],
             wide["d24"]["launches"]),
            ("btridiag_cols_tiago",
             "torch_robotics_tpu_torch/csrc/btridiag_cols.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:583", tg_k4,
             tg_k4["launches"]),
            ("collision_cost_tiago", "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", tg_k8,
             tg_k8["launches"]),
            ("multirobot_terms_same_pair",
             "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", sp_k5,
             sp_k5["launches"]),
            ("multirobot_terms_net",
             "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", net_k5,
             net_k5["launches"]),
            ("collision_cost_multirobot_net",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", net_k8,
             net_k8["launches"]),
            ("multirobot_terms_wide",
             "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", wd_k5,
             wd_k5["launches"]),
            ("btridiag_cols_mr_wide",
             "torch_robotics_tpu_torch/csrc/btridiag_cols.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:583", wd_k4,
             wd_k4["launches"]),
            ("collision_cost_multirobot_wide",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", wd_k8,
             wd_k8["launches"]),
            ("multirobot_terms_five",
             "torch_robotics_tpu_torch/csrc/mr_terms.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:533", fv_k5,
             fv_k5["launches"]),
            ("btridiag_cols_wide",
             "torch_robotics_tpu_torch/csrc/btridiag_cols_wide.cu",
             "torch_robotics_tpu/ops/pallas_btridiag.py:583", fv_k4,
             fv_k4["launches"]),
            ("collision_cost_multirobot_five",
             "torch_robotics_tpu_torch/csrc/cost.cu",
             "torch_robotics_tpu/ops/pallas_terms.py:1029", fv_k8,
             fv_k8["launches"])):
        # a tf32x3 kernel's float32-accurate products run at 495 / 3
        b_ms, b_by = bound_ms(*res["work"], PEAK_TF32X3_FLOPS
                              if res.get("route") == "tf32x3"
                              else PEAK_F32_FLOPS)
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n,
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"], "bound_ms": b_ms,
                        "bound_by": b_by,
                        "library_ms": res.get("library_ms")})
    emit("profiler", launches_without_kernel=PROFILE_MISSED)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

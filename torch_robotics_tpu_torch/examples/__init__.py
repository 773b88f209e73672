"""Runnable counterparts of the JAX package's examples (config 1's FK
over the robot zoo, the Panda's IK, MPC for the Panda with its rollouts
executed through the PD harness, the Panda's iLQR, config 4's MPC and the
point mass's GPMP2); each runs on the card unless ``--device cpu`` is
given, and each has a ``main(...)`` that returns its numbers."""

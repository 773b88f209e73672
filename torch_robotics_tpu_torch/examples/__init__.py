"""Runnable counterparts of the JAX package's examples (config 1's FK
over the robot zoo and the Panda's IK); each runs on the card unless
``--device cpu`` is given."""

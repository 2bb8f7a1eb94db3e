"""The paper's rate calculus, the (j, h) DSE, the DAG planner and the
Hopper tile rule."""

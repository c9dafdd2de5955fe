"""The port's counterparts of the reference's paper benches
(``benchmarks/bench_{boot,load_exec,hostcall}.py``): each runs on the card
unless asked for the CPU, and prints one JSON object that names the
device it ran on."""

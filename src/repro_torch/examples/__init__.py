"""The paper's examples in the port, each runnable as
`python -m repro_torch.examples.<name>` (on the card unless `--device cpu`
is passed): `quickstart` (every strategy on the Sec 5.1 game, the async
runtime and the flaky-population finale), `agnostic_federated` (Appendix
A.2), `robust_regression` (Sec 5.2, Fig 2), `train_federated_lm`
(FedGDA-GT over a ~25M-parameter language model with an adversarial
embedding perturbation) and `serve_batched` (batched prefill and decode
through the SPMD step builders on a one-rank mesh).  Each prints the signals
of its counterpart in the top-level `examples/` and returns them to a
caller (`main(argv)`)."""

"""CPU tests of the benchmark at tiny sizes; test_portbench_card.py needs a card."""

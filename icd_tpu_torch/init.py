"""Init CLI of the port, with the flags of the root ``init.py``
(init.py:17-24)::

    python -m icd_tpu_torch.init [--vocab True] [--vocab_threshold 6]
        [--glove True]

``--vocab`` builds the vocabulary of the train2014 captions and pickles
it to ``pkldata/vocab.pkl`` (the same ids as ``icd_tpu``'s); ``--glove``
builds the vocabulary-aligned GloVe matrix from a local
``glove.6B/glove.6B.300d.txt``.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create resized dataset and vocabulary.")
    parser.add_argument("--vocab", nargs="?", type=bool, default=False,
                        help="Build vocabulary.")
    parser.add_argument("--vocab_threshold", nargs="?", type=int, default=6,
                        help="Vocabulary frequency threshold.")
    parser.add_argument("--glove", nargs="?", type=bool, default=False,
                        help="Generate glove vectors.")
    args = parser.parse_args(argv)

    from .pathconf import PathConfig

    if args.vocab:
        print("Building vocabulary...")
        from .vocabulary import build_vocab, save_vocab

        vocab = build_vocab(args.vocab_threshold)
        os.makedirs(PathConfig.pkldata_dir, exist_ok=True)
        save_vocab(vocab)
        print("Vocabulary saved to {}.".format(PathConfig.vocab_file))

    if args.glove:
        from .data.embed import generate_glove_vectors

        generate_glove_vectors()


if __name__ == "__main__":
    main()

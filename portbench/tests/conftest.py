"""The repository's manifest has cells that ``cells``' four tiny cells
do not stand for (``sat_train_bert_b32``, whose tiny cell is
``bert_cells``'): ``cells.manifest`` becomes ``bert_cells.four_cells``,
which leaves them out of the metrics' lists where it would fail on
them, and is otherwise the same manifest."""

from portbench.tests import bert_cells, cells

cells.manifest = bert_cells.four_cells

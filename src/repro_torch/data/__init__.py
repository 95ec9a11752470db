from .loader import PromptLoader
from .tasks import ArithmeticTask, BracketTask, PatternTask, Problem, Task, make_task
from .tokenizer import BOS, EOS, PAD, SEP, TOKENIZER, Tokenizer

__all__ = [
    "PromptLoader",
    "ArithmeticTask",
    "BracketTask",
    "PatternTask",
    "Problem",
    "Task",
    "make_task",
    "BOS",
    "EOS",
    "PAD",
    "SEP",
    "TOKENIZER",
    "Tokenizer",
]

"""CJK word segmentation (reference: pkg/monlp/tokenizer/jieba.go:161 —
the cgo jieba tokenizer + dictionaries feeding fulltext indexing).

Redesign, not a port: a dictionary-driven bidirectional maximum-match
segmenter in pure host Python. Forward and backward maximum matching
both run; on disagreement the segmentation with fewer words (then fewer
single-character tokens) wins — the classic MM disambiguation rule,
which resolves the standard overlap ambiguities without jieba's HMM.
Unknown spans (not in the dictionary) stay as single characters for
`cut`, and become character bigrams in the fulltext tokenizer wrapper
(recall-preserving fallback, same as the pre-dictionary behavior).

The embedded lexicon covers frequent everyday + database-domain words;
`load_dict` extends it from a jieba-format file ("word[ freq]" lines).

The port's copy of `matrixone_tpu/monlp.py` (pure Python).
"""

from __future__ import annotations

from typing import Iterable, List, Set

# frequent everyday words + database/tech domain vocabulary
_EMBEDDED = """
我们 你们 他们 她们 自己 大家 什么 怎么 为什么 哪里 这个 那个 这些 那些
今天 明天 昨天 现在 时间 时候 以后 以前 已经 马上 永远 刚才
可以 不能 应该 必须 需要 希望 喜欢 知道 认为 觉得 发现 开始 结束 继续
因为 所以 但是 如果 虽然 而且 或者 并且 然后 还是 不过 只要 只有
工作 学习 生活 问题 方法 办法 事情 东西 地方 世界 国家 社会 文化 历史
经济 政治 政府 公司 企业 市场 产品 服务 客户 用户 朋友 老师 学生 孩子
中国 美国 日本 德国 法国 英国 北京 上海 广州 深圳 香港 台湾
电话 手机 电脑 计算机 网络 互联网 网站 软件 硬件 程序 代码 开发 设计
测试 调试 发布 部署 运行 性能 优化 安全 加密 压缩
数据 数据库 数据表 查询 搜索 索引 向量 矩阵 张量 模型 训练 推理
分布式 存储 计算 内存 磁盘 文件 文件系统 日志 事务 提交 回滚 快照
分区 分片 集群 节点 副本 主节点 从节点 检查点 恢复 备份 容灾 高可用
吞吐 延迟 并发 一致性 隔离 锁 死锁 调度 队列 缓存 命中
天气 下雨 下雪 太阳 月亮 星星 地球 海洋 高山 河流 森林 动物 植物
吃饭 喝水 睡觉 起床 上班 下班 上学 放学 开会 出差 旅游 运动 跑步
飞机 火车 汽车 地铁 公交 自行车 司机 乘客 车站 机场
医院 医生 护士 病人 药品 健康 银行 超市 商店 餐厅 饭店 学校 大学
快乐 高兴 难过 生气 担心 害怕 奇怪 重要 容易 困难 简单 复杂 方便
非常 特别 比较 可能 一定 当然 其实 真的 大概 差不多
""".split()


class Segmenter:
    def __init__(self, words: Iterable[str] = ()):
        self.words: Set[str] = set(_EMBEDDED)
        self.words.update(w for w in words if w)
        self.max_len = max((len(w) for w in self.words), default=1)

    def add_words(self, words: Iterable[str]) -> None:
        for w in words:
            w = w.strip()
            if w:
                self.words.add(w)
                self.max_len = max(self.max_len, len(w))

    def load_dict(self, path: str) -> int:
        """jieba-format dictionary: one "word [freq [tag]]" per line."""
        n = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                w = line.split()[0] if line.split() else ""
                if w:
                    self.add_words([w])
                    n += 1
        return n

    # ------------------------------------------------------------- MM
    def _fmm(self, text: str) -> List[str]:
        out, i, n = [], 0, len(text)
        while i < n:
            for ln in range(min(self.max_len, n - i), 1, -1):
                if text[i:i + ln] in self.words:
                    out.append(text[i:i + ln])
                    i += ln
                    break
            else:
                out.append(text[i])
                i += 1
        return out

    def _bmm(self, text: str) -> List[str]:
        out, j = [], len(text)
        while j > 0:
            for ln in range(min(self.max_len, j), 1, -1):
                if text[j - ln:j] in self.words:
                    out.append(text[j - ln:j])
                    j -= ln
                    break
            else:
                out.append(text[j - 1])
                j -= 1
        out.reverse()
        return out

    def cut(self, text: str) -> List[str]:
        """Segment one CJK run: bidirectional maximum matching, fewer
        words wins, then fewer single-character tokens (the standard MM
        tie-break for overlap ambiguity)."""
        if not text:
            return []
        f = self._fmm(text)
        b = self._bmm(text)
        if f == b:
            return f
        if len(f) != len(b):
            return f if len(f) < len(b) else b
        fs = sum(1 for w in f if len(w) == 1)
        bs = sum(1 for w in b if len(w) == 1)
        return f if fs <= bs else b


#: process-wide default (the fulltext tokenizer consumes this; SQL-side
#: dictionaries extend it via add_words/load_dict)
DEFAULT = Segmenter()


def cut(text: str) -> List[str]:
    return DEFAULT.cut(text)


def tokenize_cjk_run(run: str) -> List[str]:
    """Fulltext tokens for one contiguous CJK run: dictionary words
    where the segmenter finds them; unknown spans fall back to character
    bigrams (and lone singles stay singles) so out-of-vocabulary text
    remains searchable."""
    toks: List[str] = []
    pending: List[str] = []        # consecutive unknown single chars

    def flush():
        if not pending:
            return
        if len(pending) == 1:
            toks.append(pending[0])
        else:
            toks.extend("".join(pending[i:i + 2])
                        for i in range(len(pending) - 1))
        pending.clear()

    for w in DEFAULT.cut(run):
        if len(w) == 1 and w not in DEFAULT.words:
            pending.append(w)
            continue
        flush()
        toks.append(w)
    flush()
    return toks

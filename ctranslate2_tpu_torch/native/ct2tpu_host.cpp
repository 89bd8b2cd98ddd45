// ct2tpu_host: native host-side runtime core of ctranslate2_tpu_torch.
//
// The C++ host runtime pieces that stay on the host whatever runs on the
// device: vocabulary lookups (reference: src/vocabulary.cc), length-sorted
// rebatching (reference: src/batch_reader.cc:174-227), model.bin header
// indexing for zero-copy weight mapping (reference:
// src/models/model.cc:594-784), and a bounded job queue with timeout-based
// batch collection for the serving scheduler (reference:
// include/ctranslate2/thread_pool.h:16-115,
// src/buffered_translation_wrapper.cc). The same source as
// ctranslate2_tpu/native/ct2tpu_host.cpp; ctranslate2_tpu_torch/native
// builds it with g++ into the package's _build/ directory on first use.
//
// Built as a plain CPython extension (no pybind11 needed).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Vocabulary: token <-> id with single-hash batch conversion.
// ---------------------------------------------------------------------------

struct VocabObject {
  PyObject_HEAD
  std::unordered_map<std::string, int64_t>* token_to_id;
  std::vector<std::string>* id_to_token;
  int64_t unk_id;
};

static PyObject* Vocab_new(PyTypeObject* type, PyObject*, PyObject*) {
  VocabObject* self = reinterpret_cast<VocabObject*>(type->tp_alloc(type, 0));
  if (self) {
    self->token_to_id = new std::unordered_map<std::string, int64_t>();
    self->id_to_token = new std::vector<std::string>();
    self->unk_id = 0;
  }
  return reinterpret_cast<PyObject*>(self);
}

static int Vocab_init(VocabObject* self, PyObject* args, PyObject*) {
  PyObject* tokens;
  const char* unk_token = "<unk>";
  if (!PyArg_ParseTuple(args, "O|s", &tokens, &unk_token))
    return -1;
  PyObject* seq = PySequence_Fast(tokens, "expected a sequence of tokens");
  if (!seq)
    return -1;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  self->id_to_token->reserve(n);
  self->token_to_id->reserve(n * 2);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    Py_ssize_t len = 0;
    const char* data = PyUnicode_AsUTF8AndSize(item, &len);
    if (!data) {
      Py_DECREF(seq);
      return -1;
    }
    std::string token(data, len);
    self->token_to_id->emplace(token, self->id_to_token->size());
    self->id_to_token->emplace_back(std::move(token));
  }
  Py_DECREF(seq);
  auto it = self->token_to_id->find(unk_token);
  if (it == self->token_to_id->end()) {
    self->token_to_id->emplace(unk_token, self->id_to_token->size());
    self->unk_id = static_cast<int64_t>(self->id_to_token->size());
    self->id_to_token->emplace_back(unk_token);
  } else {
    self->unk_id = it->second;
  }
  return 0;
}

static void Vocab_dealloc(VocabObject* self) {
  delete self->token_to_id;
  delete self->id_to_token;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

static PyObject* Vocab_size(VocabObject* self, PyObject*) {
  return PyLong_FromSsize_t(self->id_to_token->size());
}

// tokens_to_ids(batch: list[list[str]]) -> list[list[int]]
static PyObject* Vocab_tokens_to_ids(VocabObject* self, PyObject* arg) {
  PyObject* batch = PySequence_Fast(arg, "expected a sequence");
  if (!batch)
    return nullptr;
  const Py_ssize_t nb = PySequence_Fast_GET_SIZE(batch);
  PyObject* out = PyList_New(nb);
  for (Py_ssize_t i = 0; i < nb; ++i) {
    PyObject* row = PySequence_Fast(PySequence_Fast_GET_ITEM(batch, i),
                                    "expected a sequence of tokens");
    if (!row) {
      Py_DECREF(batch);
      Py_DECREF(out);
      return nullptr;
    }
    const Py_ssize_t nt = PySequence_Fast_GET_SIZE(row);
    PyObject* ids = PyList_New(nt);
    for (Py_ssize_t t = 0; t < nt; ++t) {
      Py_ssize_t len = 0;
      const char* data =
          PyUnicode_AsUTF8AndSize(PySequence_Fast_GET_ITEM(row, t), &len);
      int64_t id = self->unk_id;
      if (data) {
        auto it = self->token_to_id->find(std::string(data, len));
        if (it != self->token_to_id->end())
          id = it->second;
      }
      PyList_SET_ITEM(ids, t, PyLong_FromLongLong(id));
    }
    PyList_SET_ITEM(out, i, ids);
    Py_DECREF(row);
  }
  Py_DECREF(batch);
  return out;
}

// ids_to_tokens(batch: list[list[int]]) -> list[list[str]]
static PyObject* Vocab_ids_to_tokens(VocabObject* self, PyObject* arg) {
  PyObject* batch = PySequence_Fast(arg, "expected a sequence");
  if (!batch)
    return nullptr;
  const Py_ssize_t nb = PySequence_Fast_GET_SIZE(batch);
  PyObject* out = PyList_New(nb);
  const auto& table = *self->id_to_token;
  for (Py_ssize_t i = 0; i < nb; ++i) {
    PyObject* row = PySequence_Fast(PySequence_Fast_GET_ITEM(batch, i),
                                    "expected a sequence of ids");
    if (!row) {
      Py_DECREF(batch);
      Py_DECREF(out);
      return nullptr;
    }
    const Py_ssize_t nt = PySequence_Fast_GET_SIZE(row);
    PyObject* tokens = PyList_New(nt);
    for (Py_ssize_t t = 0; t < nt; ++t) {
      const long long id = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(row, t));
      if (id >= 0 && static_cast<size_t>(id) < table.size()) {
        const std::string& tok = table[id];
        PyList_SET_ITEM(tokens, t,
                        PyUnicode_FromStringAndSize(tok.data(), tok.size()));
      } else {
        Py_INCREF(Py_None);
        PyList_SET_ITEM(tokens, t, Py_None);
      }
    }
    PyList_SET_ITEM(out, i, tokens);
    Py_DECREF(row);
  }
  Py_DECREF(batch);
  return out;
}

static PyMethodDef Vocab_methods[] = {
    {"tokens_to_ids", reinterpret_cast<PyCFunction>(Vocab_tokens_to_ids),
     METH_O, "Convert a batch of token lists to id lists."},
    {"ids_to_tokens", reinterpret_cast<PyCFunction>(Vocab_ids_to_tokens),
     METH_O, "Convert a batch of id lists to token lists."},
    {"size", reinterpret_cast<PyCFunction>(Vocab_size), METH_NOARGS,
     "Vocabulary size."},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject VocabType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// rebatch(lengths, max_batch_size, batch_type) -> list[list[int]]
// Length-sorted descending batching (reference: src/batch_reader.cc:174-227).
// ---------------------------------------------------------------------------

static PyObject* host_rebatch(PyObject*, PyObject* args) {
  PyObject* lengths_obj;
  long max_batch_size = 0;
  const char* batch_type = "examples";
  if (!PyArg_ParseTuple(args, "O|ls", &lengths_obj, &max_batch_size,
                        &batch_type))
    return nullptr;

  PyObject* seq = PySequence_Fast(lengths_obj, "expected a sequence");
  if (!seq)
    return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::vector<long long> lengths(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    lengths[i] = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(seq, i));
  Py_DECREF(seq);

  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return lengths[a] > lengths[b]; });

  std::vector<std::vector<int64_t>> batches;
  const bool by_tokens = std::strcmp(batch_type, "tokens") == 0;
  std::vector<int64_t> current;
  long long current_longest = 0;

  for (int64_t idx : order) {
    if (max_batch_size <= 0) {
      current.push_back(idx);
      continue;
    }
    if (by_tokens) {
      const long long longest = std::max<long long>(current_longest, lengths[idx]);
      if (!current.empty() &&
          longest * static_cast<long long>(current.size() + 1) > max_batch_size) {
        batches.emplace_back(std::move(current));
        current.clear();
        current_longest = 0;
      }
      current.push_back(idx);
      current_longest = std::max<long long>(current_longest, lengths[idx]);
    } else {
      current.push_back(idx);
      if (static_cast<long>(current.size()) >= max_batch_size) {
        batches.emplace_back(std::move(current));
        current.clear();
      }
    }
  }
  if (!current.empty())
    batches.emplace_back(std::move(current));

  PyObject* out = PyList_New(batches.size());
  for (size_t b = 0; b < batches.size(); ++b) {
    PyObject* lst = PyList_New(batches[b].size());
    for (size_t i = 0; i < batches[b].size(); ++i)
      PyList_SET_ITEM(lst, i, PyLong_FromLongLong(batches[b][i]));
    PyList_SET_ITEM(out, b, lst);
  }
  return out;
}

// ---------------------------------------------------------------------------
// parse_model_index(bytes) -> (version, spec, revision,
//                              [(name, dtype_id, shape, offset, nbytes)],
//                              [(alias, target)])
// Header-only parse; weight payloads stay untouched so Python can map them
// zero-copy with numpy.
// ---------------------------------------------------------------------------

static bool read_str(const uint8_t* data, Py_ssize_t size, Py_ssize_t& pos,
                     std::string& out) {
  if (pos + 2 > size)
    return false;
  uint16_t len;
  std::memcpy(&len, data + pos, 2);
  pos += 2;
  if (len == 0 || pos + len > size)
    return false;
  out.assign(reinterpret_cast<const char*>(data + pos), len - 1);
  pos += len;
  return true;
}

template <typename T>
static bool read_scalar(const uint8_t* data, Py_ssize_t size, Py_ssize_t& pos,
                        T& out) {
  if (pos + static_cast<Py_ssize_t>(sizeof(T)) > size)
    return false;
  std::memcpy(&out, data + pos, sizeof(T));
  pos += sizeof(T);
  return true;
}

static PyObject* host_parse_model_index(PyObject*, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view))
    return nullptr;
  const uint8_t* data = static_cast<const uint8_t*>(view.buf);
  const Py_ssize_t size = view.len;
  Py_ssize_t pos = 0;

  uint32_t version = 0, revision = 1, num_vars = 0;
  std::string spec;

  if (!read_scalar(data, size, pos, version))
    goto fail;
  if (version >= 2) {
    if (!read_str(data, size, pos, spec))
      goto fail;
    if (!read_scalar(data, size, pos, revision))
      goto fail;
  }
  if (!read_scalar(data, size, pos, num_vars))
    goto fail;

  {
    PyObject* vars = PyList_New(num_vars);
    for (uint32_t i = 0; i < num_vars; ++i) {
      std::string name;
      if (!read_str(data, size, pos, name)) {
        Py_DECREF(vars);
        goto fail;
      }
      uint8_t rank = 0;
      if (!read_scalar(data, size, pos, rank)) {
        Py_DECREF(vars);
        goto fail;
      }
      PyObject* shape = PyTuple_New(rank);
      for (uint8_t d = 0; d < rank; ++d) {
        uint32_t dim = 0;
        if (!read_scalar(data, size, pos, dim)) {
          Py_DECREF(shape);
          Py_DECREF(vars);
          goto fail;
        }
        PyTuple_SET_ITEM(shape, d, PyLong_FromUnsignedLong(dim));
      }
      int dtype_id;
      uint32_t num_bytes = 0;
      if (version >= 4) {
        uint8_t tid = 0;
        if (!read_scalar(data, size, pos, tid) ||
            !read_scalar(data, size, pos, num_bytes)) {
          Py_DECREF(shape);
          Py_DECREF(vars);
          goto fail;
        }
        dtype_id = tid;
      } else {
        uint8_t item_size = 0;
        uint32_t num_items = 0;
        if (!read_scalar(data, size, pos, item_size) ||
            !read_scalar(data, size, pos, num_items)) {
          Py_DECREF(shape);
          Py_DECREF(vars);
          goto fail;
        }
        num_bytes = num_items * item_size;
        // item size -> dtype id: 4=float32(0), 1=int8(1), 2=int16(2)
        dtype_id = item_size == 4 ? 0 : (item_size == 1 ? 1 : 2);
      }
      PyObject* entry = Py_BuildValue("(s#iNnk)", name.data(),
                                      static_cast<Py_ssize_t>(name.size()),
                                      dtype_id, shape,
                                      static_cast<Py_ssize_t>(pos),
                                      static_cast<unsigned long>(num_bytes));
      PyList_SET_ITEM(vars, i, entry);
      pos += num_bytes;
      if (pos > size) {
        Py_DECREF(vars);
        goto fail;
      }
    }

    PyObject* aliases = PyList_New(0);
    if (version >= 3 && pos + 4 <= size) {
      uint32_t num_aliases = 0;
      read_scalar(data, size, pos, num_aliases);
      for (uint32_t i = 0; i < num_aliases; ++i) {
        std::string alias, target;
        if (!read_str(data, size, pos, alias) ||
            !read_str(data, size, pos, target))
          break;
        PyObject* pair = Py_BuildValue("(s#s#)", alias.data(),
                                       static_cast<Py_ssize_t>(alias.size()),
                                       target.data(),
                                       static_cast<Py_ssize_t>(target.size()));
        PyList_Append(aliases, pair);
        Py_DECREF(pair);
      }
    }

    PyObject* result =
        Py_BuildValue("(ks#kNN)", static_cast<unsigned long>(version),
                      spec.data(), static_cast<Py_ssize_t>(spec.size()),
                      static_cast<unsigned long>(revision), vars, aliases);
    PyBuffer_Release(&view);
    return result;
  }

fail:
  PyBuffer_Release(&view);
  PyErr_SetString(PyExc_ValueError, "Invalid model.bin payload");
  return nullptr;
}

// ---------------------------------------------------------------------------
// RequestQueue: bounded MPMC queue with timeout-based batch collection.
// ---------------------------------------------------------------------------

struct QueueObject {
  PyObject_HEAD
  std::deque<PyObject*>* items;
  std::mutex* mutex;
  std::condition_variable* cv;
  long max_size;
  bool closed;
};

static PyObject* Queue_new(PyTypeObject* type, PyObject*, PyObject*) {
  QueueObject* self = reinterpret_cast<QueueObject*>(type->tp_alloc(type, 0));
  if (self) {
    self->items = new std::deque<PyObject*>();
    self->mutex = new std::mutex();
    self->cv = new std::condition_variable();
    self->max_size = 0;
    self->closed = false;
  }
  return reinterpret_cast<PyObject*>(self);
}

static int Queue_init(QueueObject* self, PyObject* args, PyObject*) {
  long max_size = 0;
  if (!PyArg_ParseTuple(args, "|l", &max_size))
    return -1;
  self->max_size = max_size;
  return 0;
}

static void Queue_dealloc(QueueObject* self) {
  {
    std::lock_guard<std::mutex> lock(*self->mutex);
    for (PyObject* item : *self->items)
      Py_DECREF(item);
    self->items->clear();
  }
  delete self->items;
  delete self->mutex;
  delete self->cv;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

static PyObject* Queue_put(QueueObject* self, PyObject* item) {
  Py_INCREF(item);
  Py_BEGIN_ALLOW_THREADS
  std::unique_lock<std::mutex> lock(*self->mutex);
  while (self->max_size > 0 &&
         static_cast<long>(self->items->size()) >= self->max_size &&
         !self->closed)
    self->cv->wait(lock);
  self->items->push_back(item);
  self->cv->notify_all();
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

// collect(max_items, timeout_ms, min_items=1) -> list
// Blocks until at least min_items are available (or timeout/close), then
// drains up to max_items: the micro-batching primitive
// (reference: src/buffered_translation_wrapper.cc:68-111).
static PyObject* Queue_collect(QueueObject* self, PyObject* args) {
  long max_items = 0;
  double timeout_ms = 0.0;
  long min_items = 1;
  if (!PyArg_ParseTuple(args, "ld|l", &max_items, &timeout_ms, &min_items))
    return nullptr;

  std::vector<PyObject*> collected;
  Py_BEGIN_ALLOW_THREADS
  std::unique_lock<std::mutex> lock(*self->mutex);
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::duration<double, std::milli>(timeout_ms);
  while (static_cast<long>(self->items->size()) < min_items && !self->closed) {
    if (self->cv->wait_until(lock, deadline) == std::cv_status::timeout)
      break;
  }
  while (!self->items->empty() &&
         (max_items <= 0 || static_cast<long>(collected.size()) < max_items)) {
    collected.push_back(self->items->front());
    self->items->pop_front();
  }
  self->cv->notify_all();
  Py_END_ALLOW_THREADS

  PyObject* out = PyList_New(collected.size());
  for (size_t i = 0; i < collected.size(); ++i)
    PyList_SET_ITEM(out, i, collected[i]);  // transfer ownership
  return out;
}

static PyObject* Queue_close(QueueObject* self, PyObject*) {
  {
    std::lock_guard<std::mutex> lock(*self->mutex);
    self->closed = true;
  }
  self->cv->notify_all();
  Py_RETURN_NONE;
}

static PyObject* Queue_size(QueueObject* self, PyObject*) {
  std::lock_guard<std::mutex> lock(*self->mutex);
  return PyLong_FromSsize_t(self->items->size());
}

static PyMethodDef Queue_methods[] = {
    {"put", reinterpret_cast<PyCFunction>(Queue_put), METH_O,
     "Enqueue an item (blocks when full)."},
    {"collect", reinterpret_cast<PyCFunction>(Queue_collect), METH_VARARGS,
     "Collect up to max_items, waiting up to timeout_ms for min_items."},
    {"close", reinterpret_cast<PyCFunction>(Queue_close), METH_NOARGS,
     "Close the queue (wakes all waiters)."},
    {"size", reinterpret_cast<PyCFunction>(Queue_size), METH_NOARGS,
     "Current number of queued items."},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject QueueType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// Module.
// ---------------------------------------------------------------------------

static PyMethodDef module_methods[] = {
    {"rebatch", host_rebatch, METH_VARARGS,
     "Length-sorted descending batching."},
    {"parse_model_index", host_parse_model_index, METH_VARARGS,
     "Parse a model.bin header into a variable index (zero-copy offsets)."},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "ct2tpu_host",
    "Native host-side runtime core for ctranslate2_tpu_torch.", -1, module_methods,
    nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_ct2tpu_host(void) {
  VocabType.tp_name = "ct2tpu_host.Vocabulary";
  VocabType.tp_basicsize = sizeof(VocabObject);
  VocabType.tp_flags = Py_TPFLAGS_DEFAULT;
  VocabType.tp_new = Vocab_new;
  VocabType.tp_init = reinterpret_cast<initproc>(Vocab_init);
  VocabType.tp_dealloc = reinterpret_cast<destructor>(Vocab_dealloc);
  VocabType.tp_methods = Vocab_methods;

  QueueType.tp_name = "ct2tpu_host.RequestQueue";
  QueueType.tp_basicsize = sizeof(QueueObject);
  QueueType.tp_flags = Py_TPFLAGS_DEFAULT;
  QueueType.tp_new = Queue_new;
  QueueType.tp_init = reinterpret_cast<initproc>(Queue_init);
  QueueType.tp_dealloc = reinterpret_cast<destructor>(Queue_dealloc);
  QueueType.tp_methods = Queue_methods;

  if (PyType_Ready(&VocabType) < 0 || PyType_Ready(&QueueType) < 0)
    return nullptr;

  PyObject* m = PyModule_Create(&module_def);
  if (!m)
    return nullptr;
  Py_INCREF(&VocabType);
  PyModule_AddObject(m, "Vocabulary", reinterpret_cast<PyObject*>(&VocabType));
  Py_INCREF(&QueueType);
  PyModule_AddObject(m, "RequestQueue", reinterpret_cast<PyObject*>(&QueueType));
  return m;
}
